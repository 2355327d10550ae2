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
// bench shape) and writes one row: ~6.4 GB read and 1.6 GB written per
// 16384-read batch, with one AND per word read.
//
// Design: one block per (group of kRows sample rows, 128-word tile); one
// thread owns one word column. The block stages its kRows*nq row indices
// in shared memory, then each thread walks the group's rows, so the
// threads of a warp read neighbouring words of the same row and every row
// read and every output store is a coalesced 512-byte sweep. No padding
// of the table is needed: any width and any row count work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;           // sample rows per block
constexpr int kMaxNq = 16;          // k <= 16

__global__ void __launch_bounds__(kThreads)
presence_gather_kernel(const uint32_t* __restrict__ table, int64_t w,
                       const int32_t* __restrict__ rows, int64_t n_rows,
                       int nq, uint32_t* __restrict__ out) {
  __shared__ int32_t srow[kRows * kMaxNq];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t left = n_rows - r0;
  const int nr = left < kRows ? static_cast<int>(left) : kRows;
  for (int i = threadIdx.x; i < nr * nq; i += blockDim.x)
    srow[i] = rows[r0 * nq + i];
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (col >= w) return;
  for (int r = 0; r < nr; ++r) {
    uint32_t acc = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < kMaxNq; ++q)
      if (q < nq)
        acc &= __ldg(table + static_cast<int64_t>(srow[r * nq + q]) * w + col);
    out[(r0 + r) * w + col] = acc;
  }
}

}  // namespace

// table (G1, w) u32; rows (R, nq) i32 row ids; out (R, w) u32. Returns
// cudaGetLastError() after the launch (or an argument error).
extern "C" int bm_presence_gather(const void* table, int64_t w,
                                  const void* rows, int64_t n_rows, int nq,
                                  void* out, void* stream) {
  if (nq < 1 || nq > kMaxNq || w < 1 || n_rows < 0 ||
      (n_rows + kRows - 1) / kRows > 0x7FFFFFFF ||
      (w + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows),
                    static_cast<unsigned>((w + kThreads - 1) / kThreads));
    presence_gather_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), w,
        static_cast<const int32_t*>(rows), n_rows, nq,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
