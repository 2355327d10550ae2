// Sequential offset vote per (read, bucket) pair.
//
// Replaces bucketmap_tpu/ops/vote.py:_tally_pallas_call (the Pallas
// kernel that runs the _find_offset accumulation, bucket_locator.h:
// 227-290, on VMEM-resident state).
//
// What it computes: for each pair, S = p*O proposals (segment starts)
// visited in order, sample by sample (the caller has already reversed
// the sample axis for reverse-complement pairs). The tolerance is chosen
// once per sample: exact merge while no proposal slot exists yet,
// +-indel afterwards. A valid proposal adds one vote to every live slot
// within the tolerance; if none is close it creates slot j*O+o with one
// vote. An invalid proposal changes nothing. The winner is the largest
// packed key votes<<19 | (2^19-1 - (pos+read_len)), i.e. most votes,
// then smallest position. Accept when votes >= min_vote and
// offset >= 1.
//
// What bounds it on the H100: latency. Its bytes (2*S int32 per pair,
// read once) and operations (the live slots compared at each valid
// step) take under a microsecond for a chunk; the time is the longest
// pair's chain of valid steps, each a shuffle and a warp vote.
//
// Design: one warp per pair. The warp loads the pair's S proposals and
// valid flags once, coalesced: lane l holds proposal l + 32k in register
// k. A ballot per register gives the valid steps in order; the warp
// walks only those (invalid steps change no state: no vote, no slot,
// and the per-sample tolerance depends only on whether a slot was made
// before the sample began). Each step broadcasts its proposal with a
// shuffle, so the chain holds no memory operation and its length is the
// valid count, not S. Slot idx lives in lane idx % 32, register idx / 32
// (only registers up to the step's own can hold a slot yet); one
// __any_sync per step decides whether the step makes a slot, and a warp
// max-reduction decodes the winner. A 4096-pair chunk gives 4096 warps.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int SPL>
__global__ void __launch_bounds__(kThreads)
tally_kernel(const int32_t* __restrict__ prop, const int32_t* __restrict__ valid,
             int64_t n_pairs, int p, int n_occ, int indel, int min_vote,
             int read_len, int32_t* __restrict__ off_out,
             int32_t* __restrict__ votes_out, int32_t* __restrict__ acc_out) {
  const int64_t pair =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // uniform across the warp
  const int S = p * n_occ;
  const int32_t* pr = prop + pair * S;
  const int32_t* va = valid + pair * S;

  int props[SPL];
  int sample[SPL];  // idx / O, off the chain
  unsigned vmask[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int idx = k * 32 + lane;
    const bool in = idx < S;
    props[k] = in ? pr[idx] : 0;
    sample[k] = idx / n_occ;
    vmask[k] = __ballot_sync(kFull, in && va[idx] != 0);
  }

  int pos[SPL];
  int votes[SPL];
  bool created[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    pos[k] = 0;
    votes[k] = 0;
    created[k] = false;
  }
  int first_sample = INT_MAX;  // sample of the first slot; warp-uniform

#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    unsigned m = vmask[k];
    while (m != 0u) {
      const int l = __ffs(m) - 1;
      m &= m - 1u;
      const int pcur = __shfl_sync(kFull, props[k], l);
      const int smp = __shfl_sync(kFull, sample[k], l);
      // the tolerance of this sample: was a slot made before it began?
      const int tol = first_sample < smp ? indel : 0;
      bool close_any = false;
#pragma unroll
      for (int kk = 0; kk <= k; ++kk) {
        const int d = pos[kk] - pcur;
        const bool c = created[kk] && (d < 0 ? -d : d) <= tol;
        close_any |= c;
        votes[kk] += c ? 1 : 0;
      }
      if (!__any_sync(kFull, close_any)) {
        if (first_sample == INT_MAX) first_sample = smp;
        if (lane == l) {
          pos[k] = pcur;
          votes[k] = 1;
          created[k] = true;
        }
      }
    }
  }

  int best = -1;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    if (created[k]) {
      const int key = votes[k] * (1 << 19) + ((1 << 19) - 1 - (pos[k] + read_len));
      best = best > key ? best : key;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int other = __shfl_xor_sync(kFull, best, d);
    best = best > other ? best : other;
  }
  if (lane == 0) {
    const bool ok = best >= 0;
    const int bvotes = best >> 19;
    const int boff = ((1 << 19) - 1 - (best & ((1 << 19) - 1))) - read_len;
    off_out[pair] = ok ? boff : 0;
    votes_out[pair] = ok ? bvotes : 0;
    acc_out[pair] = (ok && bvotes >= min_vote && boff >= 1) ? 1 : 0;
  }
}

template <int SPL>
void launch(int64_t blocks, cudaStream_t st, const int32_t* prop,
            const int32_t* valid, int64_t n_pairs, int p, int n_occ, int indel,
            int min_vote, int read_len, int32_t* off, int32_t* votes,
            int32_t* acc) {
  tally_kernel<SPL><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      prop, valid, n_pairs, p, n_occ, indel, min_vote, read_len, off, votes,
      acc);
}

}  // namespace

// prop/valid (P, p*O) i32, sample axis already flipped for rc pairs;
// outputs off, votes, acc (P,) i32. Returns cudaGetLastError() after the
// launch (or an argument error).
extern "C" int bm_tally(const void* prop, const void* valid, int64_t n_pairs,
                        int p, int n_occ, int indel, int min_vote, int read_len,
                        void* off, void* votes, void* acc, void* stream) {
  const int S = p * n_occ;
  if (p < 1 || n_occ < 1 || S > 256 || n_pairs < 0 || indel < 0 ||
      read_len < 0 || read_len >= (1 << 18))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs > 0) {
    const int64_t blocks = (n_pairs + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    auto pr = static_cast<const int32_t*>(prop);
    auto va = static_cast<const int32_t*>(valid);
    auto o = static_cast<int32_t*>(off);
    auto v = static_cast<int32_t*>(votes);
    auto a = static_cast<int32_t*>(acc);
    switch ((S + 31) / 32) {
      case 1: launch<1>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      case 2: launch<2>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      case 3: launch<3>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      case 4: launch<4>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      case 5: launch<5>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      case 6: launch<6>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      case 7: launch<7>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
      default: launch<8>(blocks, st, pr, va, n_pairs, p, n_occ, indel, min_vote, read_len, o, v, a); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
