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
// What bounds it on the H100 (a model, not a trace): at the bench shape
// (32,768 read-strands x 15 samples x 4 q-grams per batch, a 262,145 x
// 811-word table) the read-strands gather 1.97 M rows, 6.38 GB, from a
// 0.85 GB table: each row ~7.5 times a batch. The rows are 3,244 B
// apart, not a multiple of the 32 B sector, so a row's kWt-word slice
// spans kWt / 8 + 0.875 sectors on average: at kWt = 128 the gathers
// move an estimated ~6.8 GB of sectors and the outputs 0.64 GB a batch,
// ~2.2 ms at the card's 3.35 TB/s if every sector came from device
// memory; the distinct bytes alone (table once, indices, outputs) would
// take 0.45 ms. Whether the L2 serves part of the repeats has not been
// measured (no hardware counters on the machines this ran on); a column
// slice of this row-major table needs at least one 128 B line per row,
// 33.5 MB of a 50 MB L2 split in two halves, and narrower tiles measured
// slower, not faster (PERF.md).
//
// Design: a column sweep with many loads in flight. The work unit is (a
// tile of kWt = 128 words, a block of 8 read-strands); the grid's linear
// block id runs over read-strand blocks fastest and column tiles
// slowest. One warp owns one read-strand: 4 words per lane, strided by
// 32 so each load instruction reads one 128 B run of a row. Each thread
// keeps 16 independent table loads in flight (4 rows x 4 words). The
// row indices come in with one coalesced load per batch of 4 rows (the
// next batch's while this batch's rows arrive) and go to the lanes by
// shuffles, so no shared memory caps s. 128 words measured fastest of
// 8..128 (PERF.md). The counters stay in registers: the plane count is a
// template parameter, 1..8 (s <= 255), picked from n_planes at the
// launch. Outputs go out with streaming (evict-first) stores. At 32
// words, an L2 evict-last hint on the table loads and plain stores each
// measured within 1% of this design, so neither is kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWt = 128;                  // words per column tile
constexpr int kWpl = kWt / 32;            // words per lane
constexpr int kThreads = 256;
constexpr int kStrands = kThreads / 32;   // read-strands per block
constexpr int kBatch = 16 / kWpl;         // rows per batch: 16 loads in flight
constexpr int kMaxNq = 16;                // k <= 16

__device__ __forceinline__ uint32_t valid_word_mask(int64_t colbase,
                                                    int32_t bound) {
  const int64_t rem = static_cast<int64_t>(bound) - colbase;
  if (rem >= 32) return 0xFFFFFFFFu;
  if (rem <= 0) return 0u;
  return (1u << rem) - 1u;
}

// lane b < kBatch holds row index j0 + b
__device__ __forceinline__ int32_t load_index(const int32_t* my_rows, int j0,
                                              int n_idx, int lane) {
  return (lane < kBatch && j0 + lane < n_idx) ? __ldg(my_rows + j0 + lane) : 0;
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
coarse_score_kernel(const uint32_t* __restrict__ table, int64_t w,
                    const int32_t* __restrict__ rows, int64_t b2, int s,
                    int nq, int32_t bound, int32_t* __restrict__ cm,
                    int32_t* __restrict__ cc, uint32_t* __restrict__ planes) {
  const int lane = threadIdx.x % 32;
  const int64_t r_in = static_cast<int64_t>(blockIdx.x) * kStrands +
                       threadIdx.x / 32;
  // every lane runs the whole loop (the shuffles take the full warp);
  // lanes past the last read-strand or word load in range, store nothing
  const int64_t r = r_in < b2 ? r_in : b2 - 1;
  const int n_idx = s * nq;
  const int32_t* my_rows = rows + r * n_idx;
  // lane's words: col0 + 32 k, so a warp's load is one run per row
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kWt + lane;
  const uint32_t* tcol[kWpl];
#pragma unroll
  for (int k = 0; k < kWpl; ++k) {
    const int64_t col = col0 + k * 32;
    tcol[k] = table + (col < w ? col : w - 1);
  }

  uint32_t pl[kWpl][NP];
  uint32_t acc[kWpl];
#pragma unroll
  for (int k = 0; k < kWpl; ++k) {
    acc[k] = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < NP; ++j) pl[k][j] = 0u;
  }
  int qc = 0;

  int32_t idx = load_index(my_rows, 0, n_idx, lane);
  for (int j0 = 0; j0 < n_idx; j0 += kBatch) {
    uint32_t v[kBatch][kWpl];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t row = __shfl_sync(0xFFFFFFFFu, idx, b);
#pragma unroll
      for (int k = 0; k < kWpl; ++k)
        v[b][k] = j0 + b < n_idx ? __ldg(tcol[k] + row * w)
                                 : 0xFFFFFFFFu;
    }
    idx = load_index(my_rows, j0 + kBatch, n_idx, lane);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < n_idx) {
#pragma unroll
        for (int k = 0; k < kWpl; ++k) acc[k] &= v[b][k];
        if (++qc == nq) {       // a sample's rows are in: count its words
#pragma unroll
          for (int k = 0; k < kWpl; ++k) {
            uint32_t carry = acc[k];
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              const uint32_t t = pl[k][j] & carry;
              pl[k][j] ^= carry;
              carry = t;
            }
            acc[k] = 0xFFFFFFFFu;
          }
          qc = 0;
        }
      }
    }
  }
  if (r_in >= b2) return;

#pragma unroll
  for (int k = 0; k < kWpl; ++k) {
    const int64_t col = col0 + k * 32;
    if (col >= w) break;
    // bitwise max over the packed counters: scan planes high to low,
    // narrowing the candidate set to buckets that have each max bit
    const uint32_t vmask = valid_word_mask(col * 32, bound);
    uint32_t cand = vmask;
    int m = 0;
#pragma unroll
    for (int j = NP - 1; j >= 0; --j) {
      const uint32_t t = cand & pl[k][j];
      const int nz = t != 0u;
      if (nz) cand = t;
      m = m * 2 + nz;
    }
    const int64_t o = r * w + col;
    __stcs(cm + o, vmask == 0u ? -1 : m);
    __stcs(cc + o, vmask == 0u ? 32 : __popc(cand));
#pragma unroll
    for (int j = 0; j < NP; ++j)
      __stcs(planes + (r * NP + j) * w + col, pl[k][j]);
  }
}

template <int NP>
void launch(const dim3& grid, cudaStream_t stream, const void* table,
            int64_t w, const void* rows, int64_t b2, int s, int nq,
            int32_t bound, void* cm, void* cc, void* planes) {
  coarse_score_kernel<NP><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(table), w,
      static_cast<const int32_t*>(rows), b2, s, nq, bound,
      static_cast<int32_t*>(cm), static_cast<int32_t*>(cc),
      static_cast<uint32_t*>(planes));
}

int bit_length(int s) { return 32 - __builtin_clz(static_cast<unsigned>(s)); }

}  // namespace

// table (G1, w) u32; rows (B2*s, nq) i32 row ids, sample-minor; outputs
// cm, cc (B2, w) i32 and planes (B2, n_planes, w) u32. Returns
// cudaGetLastError() after the launch (or an argument error).
extern "C" int bm_coarse_score(const void* table, int64_t w, const void* rows,
                               int64_t b2, int s, int nq, int n_planes,
                               int32_t bound, void* cm, void* cc, void* planes,
                               void* stream) {
  if (s < 1 || s > 255 || nq < 1 || nq > kMaxNq ||
      n_planes != bit_length(s) || w < 1 || b2 < 0 ||
      (b2 + kStrands - 1) / kStrands > 0x7FFFFFFF ||
      (w + kWt - 1) / kWt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b2 > 0) {
    // read-strand blocks fastest, column tiles slowest
    const dim3 grid(static_cast<unsigned>((b2 + kStrands - 1) / kStrands),
                    static_cast<unsigned>((w + kWt - 1) / kWt));
    const auto st = static_cast<cudaStream_t>(stream);
    switch (n_planes) {  // 1..8, as s <= 255
      case 1: launch<1>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      case 2: launch<2>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      case 3: launch<3>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      case 4: launch<4>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      case 5: launch<5>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      case 6: launch<6>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      case 7: launch<7>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes); break;
      default: launch<8>(grid, st, table, w, rows, b2, s, nq, bound, cm, cc, planes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
