// Per-sample bucket presence: the AND of each sample's occupancy rows.
//
// Replaces bucketmap_tpu/ops/coarse.py:_presence_gather_pallas (the
// manual-DMA row gather + AND of the staged coarse branch).
//
// What it computes: sample row r names nq occupancy rows rows[r, 0..nq)
// (its contained q-grams). out[r, c] = AND over q of table[rows[r, q], c]
// for every word column c. Rows may repeat (every sample of a read that
// hits the all-ones sentinel row names the same row).
//
// What bounds it on the H100: device-memory traffic. Each sample reads nq
// whole rows of a table far larger than L2 (4 rows of ~3.2 KB at the
// bench shape) and writes one row: ~6.4 GB gathered and 1.6 GB written
// per 16384-read batch, with one AND per word read.
//
// Design: the column sweep of coarse_score.cu. The work unit is (a tile
// of kWt = 128 words, a block of 8 sample rows); the grid runs sample
// blocks fastest and column tiles slowest. One warp owns one sample row:
// 4 words per lane, strided by 32 so each load instruction reads one
// 128 B run of a table row. Lane q < nq loads the sample's q-th row index
// once; the indices reach the other lanes by shuffles. The rows' loads go
// out in batches of 4 rows, all 16 of a batch (4 rows x 4 words) before
// the first AND, so at nq = 4 every load of the sample is in flight at
// once. The output rows, which nothing reads back before the chunk scan,
// go out with streaming (evict-first) stores. Any width, any row count
// and 1 <= nq <= 16 work; no padding of the table is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWt = 128;                  // words per column tile
constexpr int kWpl = kWt / 32;            // words per lane
constexpr int kThreads = 256;
constexpr int kSamples = kThreads / 32;   // sample rows per block
constexpr int kBatch = 4;                 // rows per batch: 16 loads in flight
constexpr int kMaxNq = 16;                // k <= 16

__global__ void __launch_bounds__(kThreads)
presence_gather_kernel(const uint32_t* __restrict__ table, int64_t w,
                       const int32_t* __restrict__ rows, int64_t n_rows,
                       int nq, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kSamples +
                    threadIdx.x / 32;
  if (r >= n_rows) return;  // uniform across the warp
  const int32_t idx = lane < nq ? __ldg(rows + r * nq + lane) : 0;
  // lane's words: col0 + 32 k, so a warp's load is one run per row
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kWt + lane;
  const uint32_t* tcol[kWpl];
#pragma unroll
  for (int k = 0; k < kWpl; ++k) {
    const int64_t col = col0 + k * 32;
    tcol[k] = table + (col < w ? col : w - 1);
  }
  uint32_t acc[kWpl];
#pragma unroll
  for (int k = 0; k < kWpl; ++k) acc[k] = 0xFFFFFFFFu;
  for (int q0 = 0; q0 < nq; q0 += kBatch) {
    uint32_t v[kBatch][kWpl];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t row = __shfl_sync(0xFFFFFFFFu, idx, q0 + b);
#pragma unroll
      for (int k = 0; k < kWpl; ++k)
        v[b][k] = q0 + b < nq ? __ldg(tcol[k] + row * w) : 0xFFFFFFFFu;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int k = 0; k < kWpl; ++k) acc[k] &= v[b][k];
  }
#pragma unroll
  for (int k = 0; k < kWpl; ++k) {
    const int64_t col = col0 + k * 32;
    if (col < w) __stcs(out + r * w + col, acc[k]);
  }
}

}  // namespace

// table (G1, w) u32; rows (R, nq) i32 row ids; out (R, w) u32. Returns
// cudaGetLastError() after the launch (or an argument error).
extern "C" int bm_presence_gather(const void* table, int64_t w,
                                  const void* rows, int64_t n_rows, int nq,
                                  void* out, void* stream) {
  if (nq < 1 || nq > kMaxNq || w < 1 || n_rows < 0 ||
      (n_rows + kSamples - 1) / kSamples > 0x7FFFFFFF ||
      (w + kWt - 1) / kWt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    // sample blocks fastest, column tiles slowest
    const dim3 grid(static_cast<unsigned>((n_rows + kSamples - 1) / kSamples),
                    static_cast<unsigned>((w + kWt - 1) / kWt));
    presence_gather_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), w,
        static_cast<const int32_t*>(rows), n_rows, nq,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
