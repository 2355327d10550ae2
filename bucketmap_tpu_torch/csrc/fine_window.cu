// Fine-stage window lookup for the hybrid prefix search.
//
// Replaces bucketmap_tpu/ops/vote.py:_fine_window_pallas (the DMA-ring
// window fetch + first-match rank + occurrence extraction kernel), which
// on the TPU stood in for the XLA row gather at vote.py:729-754.
//
// What it computes: for each (pair, sample) row r, a window of 3
// consecutive 128-slot sub-tile rows of the sorted fine table starting at
// row frow[r] (clamped to [0, NT - 3]). It finds the first window slot i
// with lo_rel <= i < hi_rel whose low `low_bits` bits equal low[r], and
// returns that slot and the next O - 1 slots when they satisfy the same
// test; 0xFFFFFFFF elsewhere. Slots inside one prefix segment are sorted
// by their low bits, so the matches are consecutive.
//
// What bounds it on the H100: latency of scattered 1.5 KB reads. One
// 4096-pair vote chunk reads 40,960 windows (~61 MB) from a ~7 GB table,
// with almost no arithmetic per byte.
//
// Design: one warp per row. The 32 lanes sweep the 384 slots in 12
// coalesced 128-byte steps, keep the smallest matching index, and a
// shuffle min-reduction gives the first match; lanes 0..O-1 then emit
// their slot, re-read from L1. Many warps in flight hide the latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kW = 3;
constexpr int kWin = kW * 128;

__global__ void __launch_bounds__(kThreads)
fine_window_kernel(const uint32_t* __restrict__ ftf, int64_t nt,
                   const int32_t* __restrict__ frow,
                   const int32_t* __restrict__ lo_rel,
                   const int32_t* __restrict__ hi_rel,
                   const int32_t* __restrict__ low, int64_t n_rows, int n_occ,
                   uint32_t low_mask, uint32_t* __restrict__ out) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;  // uniform across the warp
  int64_t f = frow[r];
  f = f < 0 ? 0 : (f > nt - kW ? nt - kW : f);
  const uint32_t* win = ftf + f * 128;
  const int lo = lo_rel[r];
  const int hi = hi_rel[r];
  const uint32_t want = static_cast<uint32_t>(low[r]);

  int first = kWin;
#pragma unroll
  for (int t = 0; t < kWin / 32; ++t) {
    const int i = t * 32 + lane;
    const uint32_t v = __ldg(win + i);
    if (i >= lo && i < hi && (v & low_mask) == want && i < first) first = i;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    first = min(first, __shfl_xor_sync(0xFFFFFFFFu, first, d));

  if (lane < n_occ) {
    const int i = first + lane;
    uint32_t v = 0xFFFFFFFFu;
    if (i < kWin && i >= lo && i < hi) {
      const uint32_t x = __ldg(win + i);
      if ((x & low_mask) == want) v = x;
    }
    out[r * n_occ + lane] = v;
  }
}

}  // namespace

// ftf (NT, 128) u32 slot table; frow/lo_rel/hi_rel/low (R,) i32; out
// (R, O) u32. Returns cudaGetLastError() after the launch (or an
// argument error).
extern "C" int bm_fine_window(const void* ftf, int64_t nt, const void* frow,
                              const void* lo_rel, const void* hi_rel,
                              const void* low, int64_t n_rows, int n_occ,
                              int low_bits, void* out, void* stream) {
  if (nt < kW || n_occ < 1 || n_occ > 32 || low_bits < 0 || low_bits > 16 ||
      n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const int64_t warps_per_block = kThreads / 32;
    const int64_t blocks = (n_rows + warps_per_block - 1) / warps_per_block;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    fine_window_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ftf), nt,
        static_cast<const int32_t*>(frow), static_cast<const int32_t*>(lo_rel),
        static_cast<const int32_t*>(hi_rel), static_cast<const int32_t*>(low),
        n_rows, n_occ, (1u << low_bits) - 1u, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
