// Coarse bucket score for one batch of read-strands.
//
// Replaces bucketmap_tpu/ops/coarse.py:_coarse_score_pallas (the fused
// DMA-ring row gather + AND + bit-plane count + per-word max kernel).
//
// What it computes: for read-strand r with s sampled k-mers, each sample
// i names nq occupancy rows (its contained q-grams). The sample's
// bucket-presence word at column c is the AND of those rows' words at c.
// The s presence words ripple-carry into n_planes bit-plane counters
// (plane j bit b = bit j of bucket 32c+b's hit count). Each word then
// reduces to the max count among its valid buckets and the number of
// buckets at that max (bucketmap_tpu/ops/coarse.py:_word_max_cnt); words
// past `bound` are masked so the all-ones sentinel row adds no phantom
// buckets (max -1, count 32 for a fully masked word).
//
// What bounds it on the H100: device-memory traffic. Every read-strand
// reads s*nq whole occupancy rows (60 rows of ~3.2 KB at the bench
// shape, ~6.4 GB per 16384-read batch) from a table far larger than L2,
// and does a handful of integer ops per word read.
//
// Design: one block per (read-strand, 128-word tile); one thread owns one
// 32-bucket word. The block stages its s*nq row indices in shared
// memory; the threads of a warp then read neighbouring words of the same
// row, so every row read is a coalesced 512-byte sweep. The counters stay
// in registers (at most 5 planes, s <= 31), and only cm/cc/planes are
// written: presence never exists in device memory. There is no tile
// padding of the table: any width works.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPlanes = 5;       // s <= 31
constexpr int kMaxNq = 16;          // k <= 16
constexpr int kMaxRowIdx = 31 * kMaxNq;

__device__ __forceinline__ uint32_t valid_word_mask(int64_t colbase,
                                                    int32_t bound) {
  const int64_t rem = static_cast<int64_t>(bound) - colbase;
  if (rem >= 32) return 0xFFFFFFFFu;
  if (rem <= 0) return 0u;
  return (1u << rem) - 1u;
}

__global__ void __launch_bounds__(kThreads)
coarse_score_kernel(const uint32_t* __restrict__ table, int64_t w,
                    const int32_t* __restrict__ rows, int s, int nq,
                    int n_planes, int32_t bound, int32_t* __restrict__ cm,
                    int32_t* __restrict__ cc, uint32_t* __restrict__ planes) {
  __shared__ int32_t srow[kMaxRowIdx];
  const int64_t r = blockIdx.x;
  const int n_idx = s * nq;
  for (int i = threadIdx.x; i < n_idx; i += blockDim.x)
    srow[i] = rows[r * n_idx + i];
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (col >= w) return;

  uint32_t pl[kMaxPlanes];
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) pl[j] = 0u;

#pragma unroll 2
  for (int i = 0; i < s; ++i) {
    uint32_t carry = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < kMaxNq; ++q)
      if (q < nq)
        carry &= __ldg(table + static_cast<int64_t>(srow[i * nq + q]) * w + col);
#pragma unroll
    for (int j = 0; j < kMaxPlanes; ++j) {
      if (j < n_planes) {
        const uint32_t t = pl[j] & carry;
        pl[j] ^= carry;
        carry = t;
      }
    }
  }

  // bitwise max over the packed counters: scan planes high to low,
  // narrowing the candidate set to buckets that have each max bit
  const uint32_t vmask = valid_word_mask(col * 32, bound);
  uint32_t cand = vmask;
  int m = 0;
#pragma unroll
  for (int j = kMaxPlanes - 1; j >= 0; --j) {
    if (j < n_planes) {
      const uint32_t t = cand & pl[j];
      const int nz = t != 0u;
      if (nz) cand = t;
      m = m * 2 + nz;
    }
  }
  const int64_t o = r * w + col;
  cm[o] = vmask == 0u ? -1 : m;
  cc[o] = vmask == 0u ? 32 : __popc(cand);
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j)
    if (j < n_planes) planes[(r * n_planes + j) * w + col] = pl[j];
}

}  // namespace

// table (G1, w) u32; rows (B2*s, nq) i32 row ids, sample-minor; outputs
// cm, cc (B2, w) i32 and planes (B2, n_planes, w) u32. Returns
// cudaGetLastError() after the launch (or an argument error).
extern "C" int bm_coarse_score(const void* table, int64_t w, const void* rows,
                               int64_t b2, int s, int nq, int n_planes,
                               int32_t bound, void* cm, void* cc, void* planes,
                               void* stream) {
  if (s < 1 || s > 31 || nq < 1 || nq > kMaxNq || n_planes < 1 ||
      n_planes > kMaxPlanes || w < 1 || b2 < 0 || b2 > 0x7FFFFFFF ||
      (w + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b2 > 0) {
    const dim3 grid(static_cast<unsigned>(b2),
                    static_cast<unsigned>((w + kThreads - 1) / kThreads));
    coarse_score_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), w,
        static_cast<const int32_t*>(rows), s, nq, n_planes, bound,
        static_cast<int32_t*>(cm), static_cast<int32_t*>(cc),
        static_cast<uint32_t*>(planes));
  }
  return static_cast<int>(cudaGetLastError());
}
