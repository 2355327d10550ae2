// Fine stage of the table-free vote: each lane's samples found by a scan
// of its whole packed bucket.
//
// bm_fine_scan replaces the XLA scan of bucketmap_tpu/ops/vote.py:
// _vote_impl (:477-526: unpack the pair's bucket, hash every k-mer, and
// per sample a lax.top_k over the match scores); no Pallas kernel did
// this work on the TPU. It is the vote path of every index with no fine
// table: k = 16, and an index built without one where the packed slot
// encoding does not apply (at l = 14 a 65,536-base bucket's 65,827
// positions overflow its 16 position bits). Upstream does the same work
// per candidate bucket at locate time (bucket_locator.h:209-290).
//
// What it computes, for each lane (one (read, strand, bucket) pair of a
// vote chunk): the read's p samples through lane_read, each target on
// the bucket's strand (a reverse-complement lane looks for the sample's
// reverse complement at index seg_len - k - samp_idx), and per sample
// the first O = 8 positions pos <= bucket_len - k (and below the row's
// Wb * 16 - k + 1 k-mers) whose k-mer equals the target, ascending. Each
// becomes the proposal pos - tgt_idx, an empty slot 0 - tgt_idx with
// valid 0, written in the tally's layout (P, p*O) with the sample axis
// flipped for reverse-complement lanes: word for word what targets,
// scan_occurrences and proposal_args give (ops/vote.py fine_scan_plain).
//
// What bounds it on the H100: each lane reads its bucket's packed row,
// 4 * Wb bytes (16,460 at Wb = 4,115), and looks at each of its
// Wb * 16 - k + 1 k-mer positions at least once; a 4,096-lane chunk is
// 67 MB (0.020 ms at 3.35 TB/s) and 2.7e8 positions (0.016 ms at one
// int32 operation each at 16.7 T/s). The scan this replaces wrote and
// read (P, positions) int64 tensors for every step of the hash and for
// every sample, ~54 ms a chunk.
//
// Design: one warp per lane, no (P, positions) tensor and no shared
// memory. The warp walks the row 32 words (512 bases) at a time, each
// thread one word, in coalesced loads issued one step ahead (four steps
// ahead bought 1-6% on made tables, L2-resident or each lane its own
// row); a thread takes the word after its own from its neighbour by
// shuffle (lane 31 from the next step's first word), so the 16 k-mers
// that start in its word are each one funnel shift and one mask of the
// two words, taken least-significant base first. The targets are turned
// into that order once (2-bit groups reversed; a reverse complement is
// the complement alone) and sit in registers, the sample count a
// template parameter, so that the equality tests of the 16 positions
// chain into four predicates (ISETP.EQ.OR, four chains in flight): p + 2
// operations a position. Matches are rare: a step with none costs its
// shifts, masks and tests and one warp vote. A step with one walks the
// warp's matching positions in position order (ballot, then each word's
// bits lowest first), and thread j appends to sample j's list, stopping
// at O; a full sample's target then leaves the tests, so that a repeat it
// lies in costs nothing more, and the warp stops when every sample holds
// O. So the kernel is bound by its operations, p + 2 a position against
// the one of the bound; no filter in front of the tests was tried.
// Lanes past n_pairs are a block's tail only.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOcc = 8;          // occurrences per sample (MAX_OCC)
constexpr int kMaxSamples = 32;  // p * kOcc <= 256, the tally's limit
constexpr unsigned kFull = 0xFFFFFFFFu;

// a big-endian k-mer hash (first base in the high bits) with its 2-bit
// groups reversed: the first base in the low bits, as the words hold it
__device__ __forceinline__ uint32_t low_first(uint32_t h, int k) {
  uint32_t x = __brev(h);
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  return x >> (32 - 2 * k);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
fine_scan_kernel(const uint32_t* __restrict__ bp, int64_t n_buckets,
                 int64_t wb, int64_t row_stride,
                 const int64_t* __restrict__ blen,
                 const int64_t* __restrict__ vote_bucket,
                 const uint8_t* __restrict__ lane_rc,
                 const int64_t* __restrict__ lane_read, int64_t n_pairs,
                 const int64_t* __restrict__ samp_hash,
                 const int64_t* __restrict__ samp_idx,
                 const int32_t* __restrict__ lengths, int64_t n_reads, int p,
                 int k, int32_t* __restrict__ prop,
                 int32_t* __restrict__ valid) {
  const int64_t pair =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // uniform across the warp

  int64_t b = __ldg(vote_bucket + pair);
  b = b < 0 ? 0 : (b >= n_buckets ? n_buckets - 1 : b);
  const bool rc = __ldg(lane_rc + pair) != 0;
  int64_t rd = __ldg(lane_read + pair);
  rd = rd < 0 ? 0 : (rd >= n_reads ? n_reads - 1 : rd);
  const uint32_t kmask = k == 16 ? kFull : (1u << (2 * k)) - 1u;

  // thread j < p: sample j's target, low base first, and its index
  uint32_t my_t = 0;
  int64_t my_idx = 0;
  if (lane < p) {
    const uint32_t h =
        static_cast<uint32_t>(__ldg(samp_hash + rd * p + lane));
    const int64_t si = __ldg(samp_idx + rd * p + lane);
    my_t = rc ? (~h & kmask) : low_first(h, k);
    my_idx = rc ? static_cast<int64_t>(__ldg(lengths + rd)) - k - si : si;
  }
  uint32_t t[P];  // every target in every thread; past p, sample 0's
#pragma unroll
  for (int j = 0; j < P; ++j) t[j] = __shfl_sync(kFull, my_t, j < p ? j : 0);

  // the bucket's k-mers: positions 0..limit, in words 0..n_words-1; the
  // last one's k-mers may reach into word n_words
  const int64_t lpos = wb * 16 - k + 1;
  int64_t limit = __ldg(blen + b) - k;
  limit = limit < lpos - 1 ? limit : lpos - 1;
  const int64_t n_words = limit < 0 ? 0 : (limit >> 4) + 1;
  const int64_t n_load = n_words + 1 < wb ? n_words + 1 : wb;
  const uint32_t* row = bp + b * row_stride;

  const int jj = rc ? p - 1 - lane : lane;
  const int64_t out0 = pair * (static_cast<int64_t>(p) * kOcc) + jj * kOcc;
  int cnt = 0;  // thread j < p: sample j's occurrences so far

  uint32_t a = lane < n_load ? __ldg(row + lane) : 0u;
  for (int64_t ws = 0; ws < n_words; ws += 32) {  // ws: the step's first word
    const int64_t wi = ws + lane;
    const uint32_t an = wi + 32 < n_load ? __ldg(row + wi + 32) : 0u;
    uint32_t nb = __shfl_down_sync(kFull, a, 1);
    const uint32_t next0 = __shfl_sync(kFull, an, 0);
    if (lane == 31) nb = next0;

    bool hit[4] = {false, false, false, false};  // four chains in flight
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t v = __funnelshift_r(a, nb, 2 * e) & kmask;
#pragma unroll
      for (int j = 0; j < P; ++j) hit[e & 3] |= v == t[j];
    }
    if (__any_sync(kFull, (hit[0] || hit[1] || hit[2] || hit[3]) &&
                              wi < n_words)) {
      // the positions of this step that match some target, in order
      uint32_t m = 0;
      if (wi < n_words) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint32_t v = __funnelshift_r(a, nb, 2 * e) & kmask;
          bool any = false;
#pragma unroll
          for (int j = 0; j < P; ++j) any |= v == t[j];
          m |= static_cast<uint32_t>(any) << e;
        }
      }
      unsigned who = __ballot_sync(kFull, m != 0);
      while (who) {
        const int src = __ffs(who) - 1;
        who &= who - 1;
        uint32_t ms = __shfl_sync(kFull, m, src);
        const uint32_t as = __shfl_sync(kFull, a, src);
        const uint32_t bs = __shfl_sync(kFull, nb, src);
        const int64_t base = (ws + src) * 16;
        while (ms) {
          const int e = __ffs(ms) - 1;
          ms &= ms - 1;
          if (base + e > limit) {  // every later position is past it too
            who = 0;
            break;
          }
          const uint32_t v = __funnelshift_r(as, bs, 2 * e) & kmask;
          if (lane < p && v == my_t && cnt < kOcc) {
            prop[out0 + cnt] = static_cast<int32_t>(base + e - my_idx);
            valid[out0 + cnt] = 1;
            ++cnt;
          }
        }
      }
      // a full sample takes no more: its target leaves the tests (k < 16:
      // a value no masked k-mer has; k = 16: a live sample's target)
      const unsigned full = __ballot_sync(kFull, lane < p && cnt >= kOcc);
      const unsigned live = ~full & (p == 32 ? kFull : (1u << p) - 1u);
      if (!live) break;
      const uint32_t live_t = __shfl_sync(kFull, my_t, __ffs(live) - 1);
      const uint32_t dead = k < 16 ? kFull : live_t;
#pragma unroll
      for (int j = 0; j < P; ++j)
        if ((full >> (j < p ? j : 0)) & 1u) t[j] = dead;
    }
    a = an;
  }
  if (lane < p) {
    for (int c = cnt; c < kOcc; ++c) {
      prop[out0 + c] = static_cast<int32_t>(-my_idx);
      valid[out0 + c] = 0;
    }
  }
}

template <int P>
void launch(unsigned blocks, cudaStream_t stream, const uint32_t* bp,
            int64_t n_buckets, int64_t wb, int64_t row_stride,
            const int64_t* blen,
            const int64_t* vote_bucket, const uint8_t* lane_rc,
            const int64_t* lane_read, int64_t n_pairs,
            const int64_t* samp_hash, const int64_t* samp_idx,
            const int32_t* lengths, int64_t n_reads, int p, int k,
            int32_t* prop, int32_t* valid) {
  fine_scan_kernel<P><<<blocks, kThreads, 0, stream>>>(
      bp, n_buckets, wb, row_stride, blen, vote_bucket, lane_rc, lane_read,
      n_pairs,
      samp_hash, samp_idx, lengths, n_reads, p, k, prop, valid);
}

}  // namespace

// buckets_packed (N, Wb) u32 words, 16 bases each, first base in the low
// bits, row_stride words apart (the align mode's rows are padded);
// bucket_lengths (N,) i64; vote_bucket/lane_read (P,) i64, lane_rc
// (P,) bool; samp_hash/samp_idx (S, p) i64, lengths (S,) i32; prop/valid
// (P, p*O) i32. O must be 8, p at most 32, k at most 16. Returns
// cudaGetLastError() after the launch (or an argument error).
extern "C" int bm_fine_scan(const void* buckets_packed, int64_t n_buckets,
                            int64_t wb, int64_t row_stride,
                            const void* bucket_lengths,
                            const void* vote_bucket, const void* lane_rc,
                            const void* lane_read, int64_t n_pairs,
                            const void* samp_hash, const void* samp_idx,
                            const void* lengths, int64_t n_reads, int p,
                            int n_occ, int k, void* prop, void* valid,
                            void* stream) {
  if (n_buckets < 1 || wb < 1 || n_occ != kOcc || p < 1 ||
      p > kMaxSamples || k < 1 || k > 16 || wb * 16 < k || row_stride < wb ||
      n_pairs < 0 ||
      (n_pairs > 0 && n_reads < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs > 0) {
    const int64_t warps_per_block = kThreads / 32;
    const int64_t blocks = (n_pairs + warps_per_block - 1) / warps_per_block;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    // the default p = 10 and the long-read p = 20 test no padding target
    auto* fn = p <= 10 ? &launch<10> : p <= 20 ? &launch<20> : &launch<32>;
    fn(static_cast<unsigned>(blocks), static_cast<cudaStream_t>(stream),
       static_cast<const uint32_t*>(buckets_packed), n_buckets, wb,
       row_stride, static_cast<const int64_t*>(bucket_lengths),
       static_cast<const int64_t*>(vote_bucket),
       static_cast<const uint8_t*>(lane_rc),
       static_cast<const int64_t*>(lane_read), n_pairs,
       static_cast<const int64_t*>(samp_hash),
       static_cast<const int64_t*>(samp_idx),
       static_cast<const int32_t*>(lengths), n_reads, p, k,
       static_cast<int32_t*>(prop), static_cast<int32_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
