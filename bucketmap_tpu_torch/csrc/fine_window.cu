// Fine stage of the tiled vote: the whole search per (pair, sample), and
// the window lookup alone.
//
// bm_fine_search (the map path) replaces bucketmap_tpu/ops/vote.py:54
// (_fine_window_pallas, the DMA-ring window fetch + first-match rank +
// occurrence extraction kernel) together with the XLA code around it in
// _vote_packed_impl (vote.py:667-764): the target on the pair's strand,
// the prefix segment's two fine_ptab gathers, the narrowing probes, the
// clamps, and the slots' turn into proposals. On the TPU the cut was
// drawn for XLA, which fused those gathers under jit; eager PyTorch ran
// them as ~174 launches a 4096-lane chunk around one window launch.
//
// What it computes, for each (pair, sample) row: the pair's read sample
// (through lane_read), its target hash and index on the pair's strand,
// the segment [lo, seg_hi) of slots with the target's 12-bit prefix, and
// the first O slots of that segment whose low bits equal the target's
// (consecutive, as a segment is sorted by its low bits); each becomes
// the proposal pos - tgt_idx (an invalid one 0 - tgt_idx), written in
// the tally's layout (P, p*O), the sample axis flipped for
// reverse-complement pairs.
//
// What bounds it on the H100: distinct bytes, moved as dependent
// scattered reads. Each byte counted once: the 128-slot rows that the
// rows' 3-row windows cover, the 32-byte fine_ptab sectors of the
// segment bounds, and the narrowing's probed sectors outside those
// window rows; with the lanes' inputs and the two (P, p*O) int32
// outputs, over 3.35 TB/s (chip_smoke.py's search_bound): ~65 MB and
// ~0.0195 ms for the main chunk's 40,960 rows, with almost no
// arithmetic per byte. Each row's reads depend on each other (lane
// -> sample -> segment -> probes -> window), so the time is latency.
//
// Design: one warp per row, one launch a chunk instead of ~175; many
// warps in flight hide the latency. The narrowing is warp-cooperative:
// while the interval holds more than 128 slots, the 32 lanes probe 32
// evenly spaced slots at once and a ballot picks the sub-interval
// (1/33 of it), so the 4 dependent probes of an 11-step search become
// one round. Any narrowing gives the plain version's result: the
// occurrences are the first O equal-low slots of the segment, and once
// at most 128 slots remain above lo the 384-slot window from lo's row
// holds the first match and the next O - 1 slots. The lanes then sweep
// the 3-row window in three coalesced 512-byte steps of 16 bytes a
// lane, a min-reduction gives the first match, and lanes 0..O-1 emit
// their proposal, the slot re-read from L1. Offsets are 64-bit: the
// f=0.25 3.1 Gbp table passes element 2^31.
//
// bm_fine_window is the window alone (the arguments computed outside):
// for each row r, a window of 3 consecutive 128-slot sub-tile rows of
// the sorted fine table starting at row frow[r] (clamped to [0, NT - 3]),
// the first window slot i with lo_rel <= i < hi_rel whose low `low_bits`
// bits equal low[r], and that slot and the next O - 1 slots when they
// satisfy the same test; 0xFFFFFFFF elsewhere. One warp per row, 12
// coalesced 128-byte steps. No map path launches it; it stays as the
// A/B baseline of bm_fine_search.

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

constexpr int kOcc = 8;          // occurrences per sample (MAX_OCC)
constexpr int kMaxSamples = 32;  // p * kOcc <= 256, the tally's limit
constexpr int kNarrow = 128;     // narrow [lo, hi) to at most this many

__device__ __forceinline__ uint64_t revcomp_hash(uint64_t h, int k) {
  uint64_t out = 0;
  for (int i = 0; i < k; ++i)
    out |= ((~(h >> (2 * i))) & 3ull) << (2 * (k - 1 - i));
  return out;
}

__global__ void __launch_bounds__(kThreads)
fine_search_kernel(const uint32_t* __restrict__ ftf, int64_t n_buckets,
                   int64_t T, const int32_t* __restrict__ ptab,
                   int64_t ptab_w, const int64_t* __restrict__ vote_bucket,
                   const uint8_t* __restrict__ lane_rc,
                   const int64_t* __restrict__ lane_read, int64_t n_pairs,
                   const int64_t* __restrict__ samp_hash,
                   const int64_t* __restrict__ samp_idx,
                   const int32_t* __restrict__ lengths, int64_t n_reads,
                   int p, int k, int low_bits, int32_t* __restrict__ prop,
                   int32_t* __restrict__ valid) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_pairs * p) return;  // uniform across the warp
  const int64_t pair = r / p;
  const int j = static_cast<int>(r - pair * p);

  // the lane and its read's sample: every lane loads the same words
  int64_t b = __ldg(vote_bucket + pair);
  b = b < 0 ? 0 : (b >= n_buckets ? n_buckets - 1 : b);
  const bool rc = __ldg(lane_rc + pair) != 0;
  int64_t rd = __ldg(lane_read + pair);
  rd = rd < 0 ? 0 : (rd >= n_reads ? n_reads - 1 : rd);
  const uint64_t h = static_cast<uint64_t>(__ldg(samp_hash + rd * p + j));
  const int64_t si = __ldg(samp_idx + rd * p + j);
  const uint64_t tgt = rc ? revcomp_hash(h, k) : h;
  const int64_t tgt_idx =
      rc ? static_cast<int64_t>(__ldg(lengths + rd)) - k - si : si;
  const uint32_t low_mask = (1u << low_bits) - 1u;
  const uint32_t want = static_cast<uint32_t>(tgt) & low_mask;
  int64_t prefix = static_cast<int64_t>(tgt >> low_bits);
  prefix = prefix > ptab_w - 2 ? ptab_w - 2 : prefix;

  // the prefix segment [lo, seg_hi)
  const int32_t* seg = ptab + b * ptab_w + prefix;
  int64_t lo = __ldg(seg);
  const int64_t seg_hi = __ldg(seg + 1);
  const uint32_t* slots = ftf + b * T * 128;  // the bucket's slots
  const int64_t last = T * 128 - 1;

  // narrow: 32 probes a round; lower bound m of `want` stays in [lo, hi]
  int64_t hi = seg_hi;
  while (hi - lo > kNarrow) {
    const int64_t n = hi - lo;
    int64_t q = lo + (lane + 1) * n / 33;
    q = q > last ? last : q;
    const bool below = (__ldg(slots + q) & low_mask) < want;
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, below));
    const int64_t new_lo = c > 0 ? lo + c * n / 33 + 1 : lo;
    hi = c < 32 ? lo + (c + 1) * n / 33 : hi;
    lo = new_lo;
  }

  // the 3-row window from lo's row
  int64_t t0 = lo >> 7;
  t0 = t0 > T - kW ? T - kW : t0;
  const int64_t base = t0 * 128;
  const uint32_t* win = slots + base;
  const int64_t lo_rel = lo - base;
  const int64_t hi_rel = (seg_hi < base + kWin ? seg_hi : base + kWin) - base;
  uint4 v[kW];
#pragma unroll
  for (int t = 0; t < kW; ++t)  // all three loads in flight at once
    v[t] = __ldg(reinterpret_cast<const uint4*>(win) + t * 32 + lane);
  int first = kWin;
#pragma unroll
  for (int t = kW - 1; t >= 0; --t) {
    const uint32_t w4[4] = {v[t].x, v[t].y, v[t].z, v[t].w};
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int i = (t * 32 + lane) * 4 + e;
      if (i >= lo_rel && i < hi_rel && (w4[e] & low_mask) == want) first = i;
    }
  }
  first = __reduce_min_sync(0xFFFFFFFFu, first);

  if (lane < kOcc) {
    const int i = first + lane;
    uint32_t x = 0xFFFFFFFFu;
    if (i < kWin && i >= lo_rel && i < hi_rel) {
      const uint32_t y = __ldg(win + i);
      if ((y & low_mask) == want) x = y;
    }
    const bool ok = x != 0xFFFFFFFFu;
    const int64_t pos = ok ? static_cast<int32_t>(x >> low_bits) : 0;
    const int jj = rc ? p - 1 - j : j;
    const int64_t o = pair * (static_cast<int64_t>(p) * kOcc) + jj * kOcc +
                      lane;
    prop[o] = static_cast<int32_t>(pos - tgt_idx);
    valid[o] = ok ? 1 : 0;
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

// fine_packed (N, T, 128) u32 sorted slots; fine_ptab (N, ptab_w) i32
// prefix segment starts; vote_bucket/lane_read (P,) i64, lane_rc (P,)
// bool; samp_hash/samp_idx (S, p) i64, lengths (S,) i32; prop/valid
// (P, p*O) i32. O must be 8 and p at most 32. Returns cudaGetLastError()
// after the launch (or an argument error).
extern "C" int bm_fine_search(const void* fine_packed, int64_t n_buckets,
                              int64_t T, const void* fine_ptab,
                              int64_t ptab_w, const void* vote_bucket,
                              const void* lane_rc, const void* lane_read,
                              int64_t n_pairs, const void* samp_hash,
                              const void* samp_idx, const void* lengths,
                              int64_t n_reads, int p, int n_occ, int k,
                              int low_bits, void* prop, void* valid,
                              void* stream) {
  if (n_buckets < 1 || T < kW || ptab_w < 2 || n_occ != kOcc || p < 1 ||
      p > kMaxSamples || k < 1 || k > 16 || low_bits < 0 || low_bits > 16 ||
      n_pairs < 0 || (n_pairs > 0 && n_reads < 1) ||
      reinterpret_cast<uintptr_t>(fine_packed) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs > 0) {
    const int64_t warps_per_block = kThreads / 32;
    const int64_t blocks =
        (n_pairs * p + warps_per_block - 1) / warps_per_block;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    fine_search_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(fine_packed), n_buckets, T,
        static_cast<const int32_t*>(fine_ptab), ptab_w,
        static_cast<const int64_t*>(vote_bucket),
        static_cast<const uint8_t*>(lane_rc),
        static_cast<const int64_t*>(lane_read), n_pairs,
        static_cast<const int64_t*>(samp_hash),
        static_cast<const int64_t*>(samp_idx),
        static_cast<const int32_t*>(lengths), n_reads, p, k, low_bits,
        static_cast<int32_t*>(prop), static_cast<int32_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
