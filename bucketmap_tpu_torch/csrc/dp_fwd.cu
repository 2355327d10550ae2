// Forward banded semi-global edit DP of the align stage.
//
// Replaces bucketmap_tpu/ops/align.py:_dp_fwd_pallas (the Pallas kernel
// that runs the forward pass of the banded aligner on VMEM-resident
// wavefronts, 128 pairs per block, band on sublanes).
//
// What it computes, per pair: rows i = 1..Q of the query against a
// band of `band` diagonals d, cell (i, d) at text column j = i + d - lo.
// Match 0, mismatch and gaps -1, free text end gaps (row 0 is 0 on
// 0 <= j <= width). diag = prev[d] + sub, up = prev[d+1] - 1 (NEG past
// the band edge), and the in-row left move solved as the max-plus
// prefix scan m[d] = cummax(base + d) - d with base = max(diag, up). A
// cell is valid where 0 <= j <= width; invalid cells hold NEG. Each cell
// stores one byte dir | min(run, 63) << 2, dir 1 diagonal, 2 up, 3 left
// (in that priority), 0 where invalid or m <= NEG / 2; run is the length
// of the same-direction chain ending in the cell (diagonal from (i-1, d),
// up from (i-1, d+1), left the distance to the last non-left cell of the
// row). `final` is the row i == qlen (row 0 where qlen == 0, else NEG
// until reached).
//
// What bounds it on the H100: each pair is a dependent chain of Q rows,
// and every row has two prefix scans across the band; the (Q+1) * band
// direction bytes per pair (237 MB per 16,384 pairs at Q=304, band 48)
// are written once and never read back here.
//
// Design: one warp per pair, 4 pairs per block. Lane l holds cells
// d = l + 32 r for r < R = ceil(band / 32) <= 4, so one compiled kernel
// per R serves any band up to 128 with `band` and `lo` given at run time.
// `up` is a shuffle down by one across the register chunks; both prefix
// scans (the max-plus cummax and the last non-left index) are 5-step
// __shfl_up_sync max-scans with a carry between chunks. The pair's text
// window and query codes sit in shared memory as bytes. Each row's band
// bytes go out as one coalesced store per chunk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNeg = -100000000;  // NEG of the aligner
constexpr int kMinInt = -2147483647 - 1;

// Inclusive max-scan over the 32 lanes (lane 0 first).
__device__ __forceinline__ int warp_cummax(int x, int lane) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int y = __shfl_up_sync(kFull, x, k);
    if (lane >= k) x = max(x, y);
  }
  return x;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
dp_fwd_kernel(const uint8_t* __restrict__ textp,
              const uint8_t* __restrict__ qcodes,
              const int32_t* __restrict__ qlen,
              const int32_t* __restrict__ width, int64_t n_pairs, int W,
              int Q, int band, int lo, int smem_stride,
              uint8_t* __restrict__ dirs, int32_t* __restrict__ final_out) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pair >= n_pairs) return;  // uniform across the warp

  uint8_t* s_text = smem + warp * smem_stride;
  uint8_t* s_q = s_text + W;
  const uint8_t* tp = textp + pair * W;
  const uint8_t* qp = qcodes + pair * Q;
  for (int k = lane; k < W; k += 32) s_text[k] = tp[k];
  for (int k = lane; k < Q; k += 32) s_q[k] = qp[k];
  __syncwarp();

  const int wid = width[pair];
  const int ql = qlen[pair];
  const int64_t row_stride = n_pairs * band;
  uint8_t* out = dirs + pair * band;

  int prev[R], pdb[R], fin[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    const int j0 = d - lo;
    const int v = (j0 >= 0 && j0 <= wid) ? 0 : kNeg;
    prev[r] = v;
    pdb[r] = 0;
    fin[r] = ql == 0 ? v : kNeg;
    if (d < band) out[d] = 0;  // row 0: all stop
  }

  for (int i = 1; i <= Q; ++i) {
    const int qc = s_q[i - 1];
    // the previous row at d + 1 (the up move's source)
    int up_m[R], up_db[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rn = r + 1 < R ? r + 1 : r;
      const int a = __shfl_down_sync(kFull, prev[r], 1);
      const int b = __shfl_down_sync(kFull, pdb[r], 1);
      const int a0 = __shfl_sync(kFull, prev[rn], 0);
      const int b0 = __shfl_sync(kFull, pdb[rn], 0);
      const int d = lane + 32 * r;
      const bool edge = d + 1 >= band;
      up_m[r] = edge ? kNeg : (lane == 31 ? a0 : a);
      up_db[r] = edge ? 0 : (lane == 31 ? b0 : b);
    }
    int carry_m = kMinInt;
    int carry_last = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = lane + 32 * r;
      const int t = d < band ? s_text[i - 1 + d] : 4;
      const int diag = prev[r] + (t == qc ? 0 : -1);
      const int up = up_m[r] - 1;
      int x = warp_cummax(max(diag, up) + d, lane);
      x = max(x, carry_m);
      carry_m = __shfl_sync(kFull, x, 31);
      const int j = i + d - lo;
      const bool valid = j >= 0 && j <= wid;
      const int m = valid ? x - d : kNeg;
      int dir = m == diag ? 1 : (m == up ? 2 : 3);
      if (!(valid && m > kNeg / 2)) dir = 0;

      int last = warp_cummax(dir != 3 ? d : -1, lane);
      last = max(last, carry_last);
      carry_last = __shfl_sync(kFull, last, 31);

      const int pd = pdb[r] & 3, pr = pdb[r] >> 2;
      const int ud = up_db[r] & 3, ur = up_db[r] >> 2;
      const int run1 = min((pd == 1 ? pr : 0) + 1, 63);
      const int run2 = min((ud == 2 ? ur : 0) + 1, 63);
      const int run3 = min(d - last, 63);
      const int run = dir == 1 ? run1 : (dir == 2 ? run2 : (dir == 3 ? run3 : 0));
      const int db = dir > 0 ? (dir | (run << 2)) : 0;
      if (d < band) out[i * row_stride + d] = static_cast<uint8_t>(db);
      if (i == ql) fin[r] = m;
      prev[r] = m;
      pdb[r] = db;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    if (d < band) final_out[pair * band + d] = fin[r];
  }
}

template <int R>
int launch(int64_t blocks, size_t smem, cudaStream_t st, const uint8_t* t,
           const uint8_t* q, const int32_t* ql, const int32_t* w,
           int64_t n_pairs, int W, int Q, int band, int lo, int stride,
           uint8_t* dirs, int32_t* fin) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dp_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dp_fwd_kernel<R><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      t, q, ql, w, n_pairs, W, Q, band, lo, stride, dirs, fin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// textp (P, W) u8 left-padded window text (sentinel 4), qcodes (P, Q)
// u8, qlen/width (P,) i32; outputs dirs (Q+1, P, band) u8 and final
// (P, band) i32. Needs 1 <= band <= 128, 0 <= lo < band and
// W >= Q + band - 1. Returns cudaGetLastError() after the launch (or an
// argument error).
extern "C" int bm_dp_fwd(const void* textp, const void* qcodes,
                         const void* qlen, const void* width, int64_t n_pairs,
                         int W, int Q, int band, int lo, void* dirs,
                         void* final_out, void* stream) {
  if (n_pairs < 0 || Q < 0 || band < 1 || band > 128 || lo < 0 ||
      lo >= band || W < Q + band - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  const int stride = (W + Q + 15) / 16 * 16;
  const size_t smem = static_cast<size_t>(stride) * kWarps;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const uint8_t*>(textp);
  auto q = static_cast<const uint8_t*>(qcodes);
  auto ql = static_cast<const int32_t*>(qlen);
  auto w = static_cast<const int32_t*>(width);
  auto d = static_cast<uint8_t*>(dirs);
  auto f = static_cast<int32_t*>(final_out);
  switch ((band + 31) / 32) {
    case 1: return launch<1>(blocks, smem, st, t, q, ql, w, n_pairs, W, Q, band, lo, stride, d, f);
    case 2: return launch<2>(blocks, smem, st, t, q, ql, w, n_pairs, W, Q, band, lo, stride, d, f);
    case 3: return launch<3>(blocks, smem, st, t, q, ql, w, n_pairs, W, Q, band, lo, stride, d, f);
    default: return launch<4>(blocks, smem, st, t, q, ql, w, n_pairs, W, Q, band, lo, stride, d, f);
  }
}
