// Bit-sliced hit counting and per-word max over per-sample presence words.
//
// Replaces bucketmap_tpu/ops/coarse.py:_chunk_scan_pallas (the counting
// half of the staged coarse branch; its plain twin is _chunk_scan_jnp).
//
// What it computes: read-strand r has s presence words per word column c
// (presence[r, i, c], bit b = sample i holds every q-gram of bucket
// 32c+b). They ripple-carry into n_planes = bit_length(s) bit-plane
// counters (plane j bit b = bit j of bucket 32c+b's hit count). Each word
// then reduces to the max count among its valid buckets and the number of
// buckets at that max (bucketmap_tpu/ops/coarse.py:_word_max_cnt); buckets
// at or past `bound` are masked (the all-ones sentinel row sets phantom
// bits past the last real bucket), and a fully masked word reads max -1,
// count 32. The planes are written too, for the at-max extraction.
//
// What bounds it on the H100: device-memory traffic. It reads the
// presence tensor once (1.6 GB per 16384-read batch at the bench shape)
// and writes (2 + n_planes) words per presence row of s words; the
// arithmetic is a few integer ops per word read.
//
// Design: one thread per (read-strand, word column), 128 threads along
// the columns of one read-strand per block, so each of the s loads and
// every store is a coalesced sweep along a row. The counters stay in
// registers: the plane count is a template parameter, 1..8 (s <= 255),
// picked from n_planes at the launch. The outputs keep the width w: the
// TPU kernel's 128-word tile padding is left out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t valid_word_mask(int64_t colbase,
                                                    int32_t bound) {
  const int64_t rem = static_cast<int64_t>(bound) - colbase;
  if (rem >= 32) return 0xFFFFFFFFu;
  if (rem <= 0) return 0u;
  return (1u << rem) - 1u;
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(const uint32_t* __restrict__ presence, int s, int64_t w,
                  int32_t bound, int32_t* __restrict__ cm,
                  int32_t* __restrict__ cc, uint32_t* __restrict__ planes) {
  const int64_t r = blockIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (col >= w) return;

  uint32_t pl[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) pl[j] = 0u;

  const uint32_t* row = presence + r * s * w + col;
#pragma unroll 4
  for (int i = 0; i < s; ++i) {
    uint32_t carry = __ldg(row + static_cast<int64_t>(i) * w);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const uint32_t t = pl[j] & carry;
      pl[j] ^= carry;
      carry = t;
    }
  }

  // bitwise max over the packed counters: scan planes high to low,
  // narrowing the candidate set to buckets that have each max bit
  const uint32_t vmask = valid_word_mask(col * 32, bound);
  uint32_t cand = vmask;
  int m = 0;
#pragma unroll
  for (int j = NP - 1; j >= 0; --j) {
    const uint32_t t = cand & pl[j];
    const int nz = t != 0u;
    if (nz) cand = t;
    m = m * 2 + nz;
  }
  const int64_t o = r * w + col;
  cm[o] = vmask == 0u ? -1 : m;
  cc[o] = vmask == 0u ? 32 : __popc(cand);
#pragma unroll
  for (int j = 0; j < NP; ++j) planes[(r * NP + j) * w + col] = pl[j];
}

template <int NP>
void launch(const dim3& grid, cudaStream_t stream, const void* presence,
            int s, int64_t w, int32_t bound, void* cm, void* cc,
            void* planes) {
  chunk_scan_kernel<NP><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(presence), s, w, bound,
      static_cast<int32_t*>(cm), static_cast<int32_t*>(cc),
      static_cast<uint32_t*>(planes));
}

int bit_length(int s) { return 32 - __builtin_clz(static_cast<unsigned>(s)); }

}  // namespace

// presence (B2, s, w) u32; outputs cm, cc (B2, w) i32 and planes
// (B2, n_planes, w) u32. Returns cudaGetLastError() after the launch (or
// an argument error).
extern "C" int bm_chunk_scan(const void* presence, int64_t b2, int s,
                             int64_t w, int n_planes, int32_t bound, void* cm,
                             void* cc, void* planes, void* stream) {
  if (s < 1 || s > 255 || n_planes != bit_length(s) || w < 1 || b2 < 0 ||
      b2 > 0x7FFFFFFF || (w + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b2 > 0) {
    const dim3 grid(static_cast<unsigned>(b2),
                    static_cast<unsigned>((w + kThreads - 1) / kThreads));
    const auto st = static_cast<cudaStream_t>(stream);
    switch (n_planes) {  // 1..8, as s <= 255
      case 1: launch<1>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      case 2: launch<2>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      case 3: launch<3>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      case 4: launch<4>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      case 5: launch<5>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      case 6: launch<6>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      case 7: launch<7>(grid, st, presence, s, w, bound, cm, cc, planes); break;
      default: launch<8>(grid, st, presence, s, w, bound, cm, cc, planes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
