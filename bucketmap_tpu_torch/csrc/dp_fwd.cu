// Forward banded semi-global edit DP of the align stage, and the same DP
// with the run-jump traceback and the per-row run-length encoding fused
// behind it.
//
// Replaces bucketmap_tpu/ops/align.py:_dp_fwd_pallas (the Pallas kernel
// that runs the forward pass of the banded aligner on VMEM-resident
// wavefronts, 128 pairs per block, band on sublanes) and, in bm_dp_runs,
// the run-jump traceback and per-row RLE that follow it there
// (_align_core(tb_mode="runs") and the first half of _align_runs_impl).
//
// What the DP computes, per pair: rows i = 1..Q of the query against a
// band of `band` diagonals d, cell (i, d) at text column j = i + d - lo.
// Match 0, mismatch and gaps -1, free text end gaps (row 0 is 0 on
// 0 <= j <= width). diag = prev[d] + sub, up = prev[d+1] - 1 (NEG past
// the band edge), and the in-row left move solved as the max-plus
// prefix scan m[d] = cummax(base + d) - d with base = max(diag, up). A
// cell is valid where 0 <= j <= width; invalid cells hold NEG. Each cell
// holds one byte dir | min(run, 63) << 2, dir 1 diagonal, 2 up, 3 left
// (in that priority), 0 where invalid or m <= NEG / 2; run is the length
// of the same-direction chain ending in the cell (diagonal from (i-1, d),
// up from (i-1, d+1), left the distance to the last non-left cell of the
// row). `final` is the row i == qlen (row 0 where qlen == 0, else NEG
// until reached).
//
// bm_dp_fwd writes every direction byte to device memory ((Q+1) x band
// per pair) and the final row: the packed-ops path's per-cell traceback
// reads them there. bm_dp_runs keeps only each cell's direction (2 bits)
// of rows 1..min(qlen, Q) in shared memory, or, where that strip cannot
// fit, in a per-warp slice of a device scratch. After the last row one
// lane of the pair takes the final row's max (the smallest d at it) and
// walks the path cell by cell, counting what the run-jump traceback
// would jump: a jump takes a same-direction chain whole, at most 63
// cells (the byte's run is the chain's length so far, capped at 63), so
// a chain of n cells is ceil(n / 63) jumps, and the walk stops where T2
// jumps end. Chains are the merged runs (a 63-cap split leaves two jumps
// of one op, merged). It writes only the score, the begin, the run
// count, the first MR runs in query order as length << 2 | op, the
// longest of those and the unterminated flag. wrap_star starts rows with
// score < -60 at i = 0 (an empty walk). The strip is read at d clamped
// to the band; d itself is not clamped.
//
// What bounds it on the H100: each pair is a dependent chain of rows,
// and every row has a prefix scan across the band (two in bm_dp_fwd), so
// the DP is bound by operation issue and by the latency of the in-row
// scans, not by memory; the direction bytes (237 MB per 16,384 pairs at
// Q 304, band 48) were the only large traffic, and bm_dp_runs writes
// none of them.
//
// Design: L lanes per pair, C consecutive cells per lane (d = C l + c):
// 16 x 1..4 for band <= 64 (two pairs per warp), 32 x 3..4 above, so a
// compiled kernel per (L, C) serves any band up to 128 with `band` and
// `lo` given at run time. The max-plus scan runs serially over a lane's
// C cells, then as a log2(L)-step shuffle scan over the pair's lanes;
// the up source of a lane's last cell is one shuffle down. In bm_dp_fwd
// the last non-left cell comes from one ballot per cell slot instead of
// a second shuffle scan. bm_dp_runs needs no run lengths, so its rows
// skip that work; two ballots per cell slot give the warp's direction
// bits, and lane 0 stores them, C x 8 bytes per row for the warp's pairs
// (7.3 KB per warp at Q 304, band 48, a quarter of a byte strip), so
// ~24 one-warp blocks share an SM where byte strips allowed 7. The
// pair's text window and query codes sit in shared memory as bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNeg = -100000000;  // NEG of the aligner
constexpr int kFwdWarps = 4;      // warps per block of bm_dp_fwd
constexpr size_t kSmemMax = 227 * 1024;

// A lane's place among its pair's lanes [g L, g L + L) of the warp: its
// lane within the pair, and the warp's lanes below it in the pair.
template <int L>
struct Group {
  int l;
  unsigned below;
  __device__ explicit Group(int lane)
      : l(lane % L),
        below(((1u << lane) - 1u) & ~((1u << (lane - lane % L)) - 1u)) {}
};

// The DP rows 1..n_rows of one pair on its L lanes. With kRuns, every
// cell's byte (direction and run) goes to sink.cell(i, d, byte) for
// d < band; without, only the directions, as the warp's ballots
// sink.row(i, bit0, bit1) (bit l' of bitN[c] is bit N of the direction of
// lane l''s cell c). fin comes out as the row i == ql.
template <int L, int C, bool kRuns, class Sink>
__device__ __forceinline__ void dp_rows(const uint8_t* s_text,
                                        const uint8_t* s_q, int n_rows,
                                        int wid, int ql, int band, int lo,
                                        const Group<L>& gr, int (&fin)[C],
                                        const Sink& sink) {
  int prev[C], pdb[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j0 = C * gr.l + c - lo;
    prev[c] = (j0 >= 0 && j0 <= wid) ? 0 : kNeg;
    pdb[c] = 0;
    fin[c] = ql == 0 ? prev[c] : kNeg;
  }
  for (int i = 1; i <= n_rows; ++i) {
    const int qc = s_q[i - 1];
    // the next lane's first cell: the up source of this lane's last cell
    const int nm = __shfl_down_sync(kFull, prev[0], 1, L);
    const int ndb = kRuns ? __shfl_down_sync(kFull, pdb[0], 1, L) : 0;
    int diag[C], up[C], udb[C], x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = C * gr.l + c;
      const bool edge = d + 1 >= band;
      up[c] = (edge ? kNeg : (c + 1 < C ? prev[c + 1] : nm)) - 1;
      udb[c] = edge ? 0 : (c + 1 < C ? pdb[c + 1] : ndb);
      const int t = d < band ? s_text[i - 1 + d] : 4;
      diag[c] = prev[c] + (t == qc ? 0 : -1);
      x[c] = max(diag[c], up[c]) + d;
      if (c > 0) x[c] = max(x[c], x[c - 1]);
    }
    // max-plus prefix over the pair's lanes before this one
    int tot = x[C - 1];
#pragma unroll
    for (int k = 1; k < L; k <<= 1) {
      const int y = __shfl_up_sync(kFull, tot, k, L);
      if (gr.l >= k) tot = max(tot, y);
    }
    int before = __shfl_up_sync(kFull, tot, 1, L);
    if (gr.l == 0) before = INT_MIN;
    int m[C], dir[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = C * gr.l + c;
      const int j = i + d - lo;
      const bool valid = j >= 0 && j <= wid;
      m[c] = valid ? max(x[c], before) - d : kNeg;
      dir[c] = m[c] == diag[c] ? 1 : (m[c] == up[c] ? 2 : 3);
      if (!(valid && m[c] > kNeg / 2)) dir[c] = 0;
      if (i == ql) fin[c] = m[c];
      prev[c] = m[c];
    }
    if constexpr (!kRuns) {
      unsigned bit0[C], bit1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        bit0[c] = __ballot_sync(kFull, dir[c] & 1);
        bit1[c] = __ballot_sync(kFull, dir[c] >> 1);
      }
      sink.row(i, bit0, bit1);
    } else {
      unsigned nonleft[C], any = 0u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        nonleft[c] = __ballot_sync(kFull, dir[c] != 3);
        any |= nonleft[c];
      }
      // the last non-left cell before this lane's cells: the highest
      // lane below with one, then its highest such cell
      int last = -1;
      const unsigned lanes = any & gr.below;
      if (lanes != 0u) {
        const int ls = 31 - __clz(lanes);
        int cs = 0;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if ((nonleft[c] >> ls) & 1u) cs = c;
        last = C * (ls % L) + cs;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = C * gr.l + c;
        if (dir[c] != 3) last = d;
        const int pd = pdb[c] & 3, pr = pdb[c] >> 2;
        const int ud = udb[c] & 3, ur = udb[c] >> 2;
        const int run1 = min((pd == 1 ? pr : 0) + 1, 63);
        const int run2 = min((ud == 2 ? ur : 0) + 1, 63);
        const int run3 = min(d - last, 63);
        const int run = dir[c] == 1 ? run1
                                    : (dir[c] == 2 ? run2
                                                   : (dir[c] == 3 ? run3 : 0));
        const int db = dir[c] > 0 ? (dir[c] | (run << 2)) : 0;
        if (d < band) sink.cell(i, d, db);
        pdb[c] = db;
      }
    }
  }
}

// bm_dp_fwd's sink: every byte of the live pair to device memory.
struct ByteSink {
  uint8_t* out;
  int64_t row_stride;
  bool live;
  __device__ void cell(int i, int d, int db) const {
    if (live) out[i * row_stride + d] = static_cast<uint8_t>(db);
  }
  __device__ void row(int, const unsigned*, const unsigned*) const {}
};

// bm_dp_runs's sink: lane 0 stores the warp's row of direction bits.
template <int C>
struct BitSink {
  uint2* strip;
  int lane;
  __device__ void cell(int, int, int) const {}
  __device__ void row(int i, const unsigned* b0, const unsigned* b1) const {
    if (lane == 0)
#pragma unroll
      for (int c = 0; c < C; ++c)
        strip[(i - 1) * C + c] = make_uint2(b0[c], b1[c]);
  }
};

// The pair's text window (W bytes) and query codes (Q bytes) into shared
// memory, by the pair's L lanes.
template <int L>
__device__ __forceinline__ void stage(uint8_t* s_text, uint8_t* s_q,
                                      const uint8_t* tp, const uint8_t* qp,
                                      int W, int Q, int l) {
  for (int k = l; k < W; k += L) s_text[k] = tp[k];
  for (int k = l; k < Q; k += L) s_q[k] = qp[k];
}

int round_up(int64_t x, int a) { return static_cast<int>((x + a - 1) / a * a); }

// ---- bm_dp_fwd ---------------------------------------------------------

template <int L, int C>
__global__ void __launch_bounds__(32 * kFwdWarps)
dp_fwd_kernel(const uint8_t* __restrict__ textp,
              const uint8_t* __restrict__ qcodes,
              const int32_t* __restrict__ qlen,
              const int32_t* __restrict__ width, int64_t n_pairs, int W,
              int Q, int band, int lo, int smem_stride,
              uint8_t* __restrict__ dirs, int32_t* __restrict__ final_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const Group<L> gr(lane);
  const int slot = (threadIdx.x >> 5) * G + lane / L;
  const int64_t raw = static_cast<int64_t>(blockIdx.x) * kFwdWarps * G + slot;
  const bool live = raw < n_pairs;
  const int64_t pair = live ? raw : n_pairs - 1;  // every lane runs the rows

  uint8_t* s_text = smem + slot * smem_stride;
  uint8_t* s_q = s_text + W;
  stage<L>(s_text, s_q, textp + pair * W, qcodes + pair * Q, W, Q, gr.l);
  __syncwarp();

  const int64_t row_stride = n_pairs * band;
  uint8_t* out = dirs + pair * band;
  if (live)
    for (int d = gr.l; d < band; d += L) out[d] = 0;  // row 0: all stop
  const ByteSink sink{out, row_stride, live};
  int fin[C];
  dp_rows<L, C, true>(s_text, s_q, Q, width[pair], qlen[pair], band, lo, gr,
                      fin, sink);
  if (!live) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = C * gr.l + c;
    if (d < band) final_out[pair * band + d] = fin[c];
  }
}

// ---- bm_dp_runs --------------------------------------------------------

template <int L, int C, bool kSmemStrip>
__global__ void __launch_bounds__(32)
dp_runs_kernel(const uint8_t* __restrict__ textp,
               const uint8_t* __restrict__ qcodes,
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ width, int64_t n_pairs, int W,
               int Q, int band, int lo, int T2, int MR, int wrap_star,
               int strip_bytes, int stage_stride,
               uint2* __restrict__ scratch, int32_t* __restrict__ head,
               int32_t* __restrict__ runs) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int G = 32 / L;
  constexpr int kMaxPerLane = 128 / L;  // MR <= 128 runs over L lanes
  const int lane = threadIdx.x & 31;
  const Group<L> gr(lane);
  const int g = lane / L;
  const int64_t raw = static_cast<int64_t>(blockIdx.x) * G + g;
  const bool live = raw < n_pairs;
  const int64_t pair = live ? raw : n_pairs - 1;

  // the warp's strip: row i - 1 holds C (bit0, bit1) ballot pairs
  uint2* strip = kSmemStrip ? reinterpret_cast<uint2*>(smem)
                            : scratch + static_cast<int64_t>(blockIdx.x) * Q * C;
  uint8_t* s_text = smem + (kSmemStrip ? strip_bytes : 0) + g * stage_stride;
  uint8_t* s_q = s_text + W;
  stage<L>(s_text, s_q, textp + pair * W, qcodes + pair * Q, W, Q, gr.l);
  __syncwarp();

  const int ql = qlen[pair];
  // rows past qlen feed no traceback; the warp runs its pairs' longest
  const int n_rows = __reduce_max_sync(kFull, min(ql, Q));
  const BitSink<C> sink{strip, lane};
  int fin[C];
  dp_rows<L, C, false>(s_text, s_q, n_rows, width[pair], ql, band, lo, gr,
                       fin, sink);

  // score and end d: the final row's max, the smallest d at it
  int best = INT_MIN, bd = band;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = C * gr.l + c;
    if (d < band && fin[c] > best) {
      best = fin[c];
      bd = d;
    }
  }
#pragma unroll
  for (int k = L / 2; k > 0; k >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, k, L);
    const int od = __shfl_xor_sync(kFull, bd, k, L);
    if (ob > best || (ob == best && od < bd)) {
      best = ob;
      bd = od;
    }
  }
  __syncwarp();  // the strip, written by lane 0, to the walking lanes

  // the walk, by the pair's lane 0: merged run r (traceback order) goes
  // to slot r % MR of the pair's runs, so the last MR of them, the first
  // MR in query order, stay
  int32_t* my_runs = runs + pair * MR;
  int i = (wrap_star && best < -60) ? 0 : ql, d = bd, n_runs = 0;
  if (gr.l == 0 && live) {
    int jumps = 0, in_jump = 0, cur = 0, len = 0, slot = -1;
    while (i > 0) {
      const int dc = min(max(d, 0), band - 1);
      const int lc = dc / C;
      const uint2 w = strip[(min(i, Q) - 1) * C + (dc - lc * C)];
      const int bit = g * L + lc;
      const int op = ((w.x >> bit) & 1u) | (((w.y >> bit) & 1u) << 1);
      if (op == 0) break;  // no move: the traceback stays here
      if (op != cur || in_jump == 63) {  // this cell starts a jump
        if (jumps == T2) break;
        ++jumps;
        in_jump = 0;
        if (op != cur) {
          if (cur != 0) my_runs[slot] = (len << 2) | cur;
          slot = slot + 1 == MR ? 0 : slot + 1;
          ++n_runs;
          cur = op;
          len = 0;
        }
      }
      ++in_jump;
      ++len;
      if (op != 3) --i;
      d += op == 2 ? 1 : (op == 3 ? -1 : 0);
    }
    if (cur != 0) my_runs[slot] = (len << 2) | cur;
  }
  // query-order run k is merged run n_runs - 1 - k; the pair's lanes
  // read the kept runs, then write them in that order, zeros past them
  n_runs = __shfl_sync(kFull, n_runs, 0, L);
  __syncwarp();
  const int kept = min(n_runs, MR);
  int v[kMaxPerLane];
  int max_len = 0;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int k = gr.l + j * L;
    v[j] = live && k < kept ? my_runs[(n_runs - 1 - k) % MR] : 0;
    max_len = max(max_len, v[j] >> 2);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int k = gr.l + j * L;
    if (live && k < MR) my_runs[k] = v[j];
  }
#pragma unroll
  for (int k = L / 2; k > 0; k >>= 1)
    max_len = max(max_len, __shfl_xor_sync(kFull, max_len, k, L));
  if (gr.l != 0 || !live) return;
  head[pair] = best;
  head[n_pairs + pair] = d - lo;
  head[2 * n_pairs + pair] = n_runs;
  head[3 * n_pairs + pair] = max_len;
  head[4 * n_pairs + pair] = i > 0;
}

// ---- launch ------------------------------------------------------------

template <class K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

struct Args {
  const uint8_t* t;
  const uint8_t* q;
  const int32_t* ql;
  const int32_t* w;
  int64_t n_pairs;
  int W, Q, band, lo;
  cudaStream_t st;
};

template <int L, int C>
int launch_fwd(const Args& a, uint8_t* dirs, int32_t* fin) {
  constexpr int G = 32 / L;
  const int stride = round_up(a.W + a.Q, 16);
  const size_t smem = static_cast<size_t>(stride) * kFwdWarps * G;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (a.n_pairs + kFwdWarps * G - 1) / (kFwdWarps * G);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = set_smem(dp_fwd_kernel<L, C>, smem)) return e;
  dp_fwd_kernel<L, C><<<static_cast<unsigned>(blocks), 32 * kFwdWarps, smem,
                        a.st>>>(a.t, a.q, a.ql, a.w, a.n_pairs, a.W, a.Q,
                                a.band, a.lo, stride, dirs, fin);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a one-warp block of bm_dp_runs: the warp's strip
// (Q rows of C ballot pairs; 0 where it does not fit and goes to device
// scratch) and each pair's staged text and query.
struct RunsSmem {
  int strip, stage;
  size_t block;
};

RunsSmem runs_smem(int lanes, int cells, int W, int Q) {
  const int G = 32 / lanes;
  const int64_t strip = static_cast<int64_t>(Q) * cells * 8;
  const int stage = round_up(W + Q, 16);
  const size_t staged = static_cast<size_t>(stage) * G;
  if (staged > kSmemMax) return {-1, 0, 0};
  if (static_cast<size_t>(strip) + staged <= kSmemMax)
    return {static_cast<int>(strip), stage, strip + staged};
  return {0, stage, staged};
}

int lanes_for(int band) { return band <= 64 ? 16 : 32; }
int cells_for(int band) {
  const int L = lanes_for(band);
  return (band + L - 1) / L;
}

template <int L, int C>
int launch_runs(const Args& a, int T2, int MR, int wrap_star, uint2* scratch,
                int32_t* head, int32_t* runs) {
  constexpr int G = 32 / L;
  const RunsSmem s = runs_smem(L, C, a.W, a.Q);
  if (s.strip < 0 || MR > 128) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = s.strip > 0 || a.Q == 0;
  if (!in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (a.n_pairs + G - 1) / G;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = in_smem ? dp_runs_kernel<L, C, true>
                        : dp_runs_kernel<L, C, false>;
  if (const int e = set_smem(kernel, s.block)) return e;
  kernel<<<static_cast<unsigned>(blocks), 32, s.block, a.st>>>(
      a.t, a.q, a.ql, a.w, a.n_pairs, a.W, a.Q, a.band, a.lo, T2, MR,
      wrap_star, s.strip, s.stage, scratch, head, runs);
  return static_cast<int>(cudaGetLastError());
}

// (L, C) by band: 16 lanes up to 64 diagonals, 32 above.
int variant(int band) {
  return band <= 16 ? 0 : band <= 32 ? 1 : band <= 48 ? 2 : band <= 64 ? 3
                                                      : band <= 96 ? 4 : 5;
}

bool bad_geometry(int64_t n_pairs, int W, int Q, int band, int lo) {
  return n_pairs < 0 || Q < 0 || band < 1 || band > 128 || lo < 0 ||
         lo >= band || W < Q + band - 1;
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
  if (bad_geometry(n_pairs, W, Q, band, lo))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const uint8_t*>(textp),
               static_cast<const uint8_t*>(qcodes),
               static_cast<const int32_t*>(qlen),
               static_cast<const int32_t*>(width), n_pairs, W, Q, band, lo,
               static_cast<cudaStream_t>(stream)};
  auto d = static_cast<uint8_t*>(dirs);
  auto f = static_cast<int32_t*>(final_out);
  switch (variant(band)) {
    case 0: return launch_fwd<16, 1>(a, d, f);
    case 1: return launch_fwd<16, 2>(a, d, f);
    case 2: return launch_fwd<16, 3>(a, d, f);
    case 3: return launch_fwd<16, 4>(a, d, f);
    case 4: return launch_fwd<32, 3>(a, d, f);
    default: return launch_fwd<32, 4>(a, d, f);
  }
}

// Bytes of device scratch bm_dp_runs needs for n_pairs pairs at this
// geometry: 0 where a warp's strip fits in shared memory, a strip of Q x
// C x 8 bytes per warp where it does not, -1 where not even the staging
// fits.
extern "C" int64_t bm_dp_runs_scratch_bytes(int64_t n_pairs, int W, int Q,
                                            int band) {
  if (band < 1 || band > 128 || Q < 0 || n_pairs < 0) return -1;
  const int L = lanes_for(band), C = cells_for(band);
  const RunsSmem s = runs_smem(L, C, W, Q);
  if (s.strip < 0) return -1;
  const int64_t warps = (n_pairs + 32 / L - 1) / (32 / L);
  return s.strip > 0 || Q == 0 ? 0 : warps * Q * C * 8;
}

// The DP of bm_dp_fwd with the run-jump traceback and per-row RLE behind
// it. Inputs as bm_dp_fwd; T2 run jumps at most, MR runs kept per row;
// wrap_star 0 or 1; MR <= 128. scratch: bm_dp_runs_scratch_bytes bytes
// (may be null where that is 0). Outputs head (5, P) i32, rows score, begin, run
// count, longest kept run, unterminated (0/1); runs (P, MR) i32, merged
// runs in query order as length << 2 | op, 0 past the kept ones.
extern "C" int bm_dp_runs(const void* textp, const void* qcodes,
                          const void* qlen, const void* width, int64_t n_pairs,
                          int W, int Q, int band, int lo, int T2, int MR,
                          int wrap_star, void* scratch, void* head, void* runs,
                          void* stream) {
  if (bad_geometry(n_pairs, W, Q, band, lo) || T2 < 0 || MR < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const uint8_t*>(textp),
               static_cast<const uint8_t*>(qcodes),
               static_cast<const int32_t*>(qlen),
               static_cast<const int32_t*>(width), n_pairs, W, Q, band, lo,
               static_cast<cudaStream_t>(stream)};
  auto s = static_cast<uint2*>(scratch);
  auto h = static_cast<int32_t*>(head);
  auto r = static_cast<int32_t*>(runs);
  const int ws = wrap_star != 0;
  switch (variant(band)) {
    case 0: return launch_runs<16, 1>(a, T2, MR, ws, s, h, r);
    case 1: return launch_runs<16, 2>(a, T2, MR, ws, s, h, r);
    case 2: return launch_runs<16, 3>(a, T2, MR, ws, s, h, r);
    case 3: return launch_runs<16, 4>(a, T2, MR, ws, s, h, r);
    case 4: return launch_runs<32, 3>(a, T2, MR, ws, s, h, r);
    default: return launch_runs<32, 4>(a, T2, MR, ws, s, h, r);
  }
}
