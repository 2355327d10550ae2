"""Fine stage on torch: in-bucket offset voting.

Counterpart of `bucketmap_tpu/ops/vote.py:FineLocator` on each of its
vote paths, chosen by the fine tables that exist (vote_path). The
production path is the tiled packed table the device build makes: per
(pair, sample) the 12-bit hash prefix bounds a segment of the sorted
slot table, the search narrows it to at most 128 slots, and one
3-sub-tile window yields the sample's occurrences, which become the
tally's proposals. The fine-search kernel (`csrc/fine_window.cu`
`bm_fine_search`) does all of that in one launch a vote chunk, from the
chunk's lanes to the proposals; its plain version, fine_search_plain,
is the composition of the pieces kept beside it (window_args,
fine_window_plain, tally_args), and the fine-window kernel
(`bm_fine_window`, the window alone) stays as their A/B baseline. With
no fine table the fine-scan kernel (`csrc/fine_scan.cu` `bm_fine_scan`)
walks each lane's packed bucket once, from the chunk's lanes to the
proposals in one launch; its plain version, fine_scan_plain, is targets,
scan_occurrences (every k-mer hashed, a top-k per sample) and
proposal_args. The host build's 2-D packed table and its prefix and
positional tables find the same occurrences with plain torch gathers and
searches, as the JAX package does with XLA. On every path the proposals
go through the sequential vote (the tally kernel, `csrc/tally.cu`). On
CPU tensors every kernel runs as its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from bucketmap_tpu_torch.index.builder import BucketIndex
from bucketmap_tpu_torch.ops.sampler import sample_table
from bucketmap_tpu_torch import kernels
from bucketmap_tpu_torch.device import MASK32, resolve_device, srl
from bucketmap_tpu_torch.ops.coarse import rank_select
from bucketmap_tpu_torch.ops.encoding import (kmer_hashes, revcomp_hash,
                                              unpack_2bit)

WINDOW_ROWS = 3          # sub-tile rows per fine window
MAX_OCC = 8              # occurrences per sampled k-mer (vote.py:403)


def fine_window_plain(ftf: torch.Tensor, frow, lo_rel, hi_rel, low, O: int,
                      low_bits: int) -> torch.Tensor:
    """Plain PyTorch version of the fine-window kernel.

    ftf: (NT, 128) int32 slot table; frow: (R,) first sub-tile row of each
    window (clamped to [0, NT - 3]); lo_rel/hi_rel: (R,) slot interval
    relative to the window start; low: (R,) target low bits. Returns
    (R, O) int32: the first O slots in [lo_rel, hi_rel) whose low bits
    equal `low` (consecutive, as the interval is low-bits sorted), -1
    (0xFFFFFFFF) where the run is shorter."""
    nt = ftf.shape[0]
    span = WINDOW_ROWS * 128
    dev = ftf.device
    f = frow.to(torch.int64).clamp(0, nt - WINDOW_ROWS)
    flat = torch.arange(span, dtype=torch.int64, device=dev)
    win = ftf.reshape(-1)[(f * 128)[:, None] + flat]                # (R, 384)
    lo = lo_rel.to(torch.int64)[:, None]
    hi = hi_rel.to(torch.int64)[:, None]
    want = low.to(torch.int32)[:, None]
    eq = (flat >= lo) & (flat < hi) & ((win & ((1 << low_bits) - 1)) == want)
    first = torch.where(eq, flat, span).amin(dim=1, keepdim=True)   # (R, 1)
    idx = first + torch.arange(O, dtype=torch.int64, device=dev)    # (R, O)
    inwin = idx < span
    cidx = torch.where(inwin, idx, 0)
    hit = inwin & torch.gather(eq, 1, cidx)
    return torch.where(hit, torch.gather(win, 1, cidx), -1).to(torch.int32)


def fine_window(ftf: torch.Tensor, frow, lo_rel, hi_rel, low, O: int,
                low_bits: int) -> torch.Tensor:
    """Fine window: the CUDA kernel on a CUDA table, the plain version on
    a CPU table. Same arguments and results as fine_window_plain."""
    if ftf.device.type == "cpu":
        return fine_window_plain(ftf, frow, lo_rel, hi_rel, low, O, low_bits)
    nt = ftf.shape[0]
    R = frow.shape[0]
    kernels.require(ftf, "ftf", torch.int32, (nt, 128))
    for name, t in (("frow", frow), ("lo_rel", lo_rel), ("hi_rel", hi_rel),
                    ("low", low)):
        kernels.require(t, name, torch.int32, (R,))
        if t.device != ftf.device:
            raise ValueError(f"{name} and ftf must be on the same device")
    out = torch.empty((R, O), dtype=torch.int32, device=ftf.device)
    err = kernels.library().bm_fine_window(
        ftf.data_ptr(), nt, frow.data_ptr(), lo_rel.data_ptr(),
        hi_rel.data_ptr(), low.data_ptr(), R, O, low_bits, out.data_ptr(),
        kernels.stream_handle(ftf))
    kernels.check(err, "fine_window")
    kernels.LAUNCHES["fine_window"] += 1
    return out


def tally_plain(flat_prop: torch.Tensor, flat_valid: torch.Tensor, p: int,
                O: int, indel: int, min_vote: int, read_len: int):
    """Plain PyTorch version of the tally kernel: the _find_offset vote
    (vote.py:438-475) as a loop over the p*O proposals.

    flat_prop/flat_valid: (P, p*O) int32, sample axis already flipped for
    reverse-complement pairs. Returns (offset, votes, accept) (P,) int32;
    offset and votes are 0 where no proposal was made."""
    P, S = flat_prop.shape
    dev = flat_prop.device
    col = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    pos = torch.zeros((P, S), dtype=torch.int32, device=dev)
    votes = torch.zeros((P, S), dtype=torch.int32, device=dev)
    created = torch.zeros((P, S), dtype=torch.bool, device=dev)
    valid = flat_valid != 0
    for j in range(p):
        # tolerance chosen once per sample (bucket_locator.h:247)
        tol = torch.where(created.any(dim=1, keepdim=True), indel, 0)
        for o in range(O):
            idx = j * O + o
            pcur = flat_prop[:, idx:idx + 1]
            val = valid[:, idx:idx + 1]
            close = created & ((pos - pcur).abs() <= tol)
            votes = votes + (close & val).to(torch.int32)
            hit = val & ~close.any(dim=1, keepdim=True) & (col == idx)
            pos = torch.where(hit, pcur, pos)
            votes = torch.where(hit, 1, votes).to(torch.int32)
            created = created | hit
    key = torch.where(created,
                      votes * (1 << 19) + ((1 << 19) - 1 - (pos + read_len)), -1)
    best = key.amax(dim=1)
    ok = best >= 0
    bvotes = best >> 19
    boff = ((1 << 19) - 1 - (best & ((1 << 19) - 1))) - read_len
    off = torch.where(ok, boff, 0).to(torch.int32)
    bv = torch.where(ok, bvotes, 0).to(torch.int32)
    acc = (ok & (bvotes >= min_vote) & (boff >= 1)).to(torch.int32)
    return off, bv, acc


def tally(flat_prop: torch.Tensor, flat_valid: torch.Tensor, p: int, O: int,
          indel: int, min_vote: int, read_len: int):
    """Tally: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. Same arguments and results as tally_plain."""
    if flat_prop.device.type == "cpu":
        return tally_plain(flat_prop, flat_valid, p, O, indel, min_vote,
                           read_len)
    P, S = flat_prop.shape
    if S != p * O:
        raise ValueError(f"proposal width {S} != p*O = {p * O}")
    kernels.require(flat_prop, "flat_prop", torch.int32, (P, S))
    kernels.require(flat_valid, "flat_valid", torch.int32, (P, S))
    if flat_valid.device != flat_prop.device:
        raise ValueError("flat_prop and flat_valid must be on the same device")
    dev = flat_prop.device
    off = torch.empty(P, dtype=torch.int32, device=dev)
    votes = torch.empty(P, dtype=torch.int32, device=dev)
    acc = torch.empty(P, dtype=torch.int32, device=dev)
    err = kernels.library().bm_tally(
        flat_prop.data_ptr(), flat_valid.data_ptr(), P, p, O, indel, min_vote,
        read_len, off.data_ptr(), votes.data_ptr(), acc.data_ptr(),
        kernels.stream_handle(flat_prop))
    kernels.check(err, "tally")
    kernels.LAUNCHES["tally"] += 1
    return off, votes, acc


# tables each path reads beside the sample table (vote.py:789-799)
PATH_TABLES = {
    "tiled": ("fine_packed", "fine_ptab"),
    "packed": ("fine_packed", "fine_ptab"),
    "prefix": ("fine_ptab", "fine_low", "fine_pos"),
    "sorted": ("fine_pos", "buckets_packed"),
    "scan": ("buckets_packed", "bucket_lengths"),
}


def vote_path(tables: dict) -> str:
    """The vote path a set of fine tables takes, in the JAX order
    (vote.py:789-799): the packed slot table (tiled (N, Tp, 128) as the
    device build stores it, else the host build's (N, lpos)), then the
    prefix tables, then the positional table alone, else the table-free
    scan of the packed bucket sequences."""
    fp = tables.get("fine_packed")
    if fp is not None:
        return "tiled" if fp.dim() == 3 else "packed"
    if tables.get("fine_ptab") is not None:
        return "prefix"
    if tables.get("fine_pos") is not None:
        return "sorted"
    return "scan"


def lower_bound(lo, hi, target, steps: int, probe):
    """`steps` probes of a lower-bound search for target within [lo, hi)
    (vote.py:629-635); probe(mid) reads the keys at slots mid. Lanes whose
    interval is empty keep it."""
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        below = active & (probe(mid) < target)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo, hi


def targets(is_rc, samp_hash, samp_idx, seg_len, k: int):
    """Each sample on the bucket's strand: (tgt_hash, tgt_idx) (P, p)
    int64. A reverse-complement pair looks for the sample's reverse
    complement at index seg_len - k - samp_idx."""
    rc = is_rc[:, None]
    tgt_hash = torch.where(rc, revcomp_hash(samp_hash, k), samp_hash)
    tgt_idx = torch.where(rc, seg_len[:, None].to(torch.int64) - k
                          - samp_idx, samp_idx)
    return tgt_hash, tgt_idx


def window_args(fine_packed, fine_ptab, bucket_ids, is_rc, samp_hash,
                samp_idx, seg_len, k: int, low_bits: int, search_steps: int,
                O: int = MAX_OCC):
    """Tiled path: per (pair, sample) target and narrowed slot interval.
    fine_packed (N, T, 128) int32 sorted slots, fine_ptab (N, 4097) int32
    prefix segment starts; the rest per pair (samp_hash/samp_idx (P, p)).
    Returns the fine-window arguments (ftf, frow, lo_rel, hi_rel, low, O,
    low_bits), flattened over (pair, sample), and tgt_idx (P, p)."""
    fp = fine_packed
    N, T = fp.shape[0], fp.shape[1]
    lpos = T * 128
    low_mask = (1 << low_bits) - 1
    tgt_hash, tgt_idx = targets(is_rc, samp_hash, samp_idx, seg_len, k)
    low = tgt_hash & low_mask
    bid = bucket_ids.to(torch.int64)[:, None]
    prefix = tgt_hash >> low_bits
    lo = fine_ptab[bid, prefix].to(torch.int64)
    seg_hi = fine_ptab[bid, prefix + 1].to(torch.int64)

    def probe(mid):
        mc = mid.clamp(0, lpos - 1)
        return (fp[bid, mc // 128, mc % 128] & low_mask).to(torch.int64)

    # narrow [lo, hi) to <= 128 slots; the window does the rest
    lo, _ = lower_bound(lo, seg_hi, low, max(0, search_steps - 7), probe)
    t0 = (lo // 128).clamp(0, T - WINDOW_ROWS)
    base = t0 * 128
    # padding lanes carry arbitrary bucket ids: keep windows in the table
    frow = (bid * T + t0).clamp(0, N * T - WINDOW_ROWS)
    hi_rel = torch.minimum(seg_hi, base + WINDOW_ROWS * 128) - base
    args = (fp.reshape(-1, 128),
            frow.reshape(-1).to(torch.int32),
            (lo - base).reshape(-1).to(torch.int32),
            hi_rel.reshape(-1).to(torch.int32),
            low.reshape(-1).to(torch.int32), O, low_bits)
    return args, tgt_idx


def proposal_args(occ_pos, occ_valid, tgt_idx, is_rc):
    """Occurrences (P, p, O) -> the tally's (prop, valid) (P, p*O) int32.
    Each valid occurrence proposes the segment start occ_pos - tgt_idx (an
    invalid one 0 - tgt_idx, as the JAX vote writes it); reverse-complement
    pairs visit their samples last to first (bucket_locator.h:235-236), so
    their sample axis is flipped."""
    P, p, O = occ_valid.shape
    prop = torch.where(occ_valid, occ_pos, 0).to(torch.int64) \
        - tgt_idx[:, :, None]
    rc = is_rc[:, None, None]
    prop = torch.where(rc, prop.flip(1), prop)
    occ_valid = torch.where(rc, occ_valid.flip(1), occ_valid)
    return (prop.reshape(P, p * O).to(torch.int32).contiguous(),
            occ_valid.reshape(P, p * O).to(torch.int32).contiguous())


def tally_args(pk, tgt_idx, is_rc, low_bits: int):
    """Tiled path: window slots (P, p, O), -1 where empty, -> the tally's
    (prop, valid)."""
    return proposal_args(srl(pk, low_bits), pk != -1, tgt_idx, is_rc)


def fine_search_plain(fine_packed, fine_ptab, vote_bucket, lane_rc,
                      lane_read, samp_hash, samp_idx, lengths, k: int,
                      low_bits: int, search_steps: int, O: int = MAX_OCC):
    """Plain PyTorch version of the fine-search kernel: the tiled vote from
    a chunk's lanes to the tally's arguments, the composition of the
    lanes' sample gathers, window_args, fine_window_plain and tally_args.

    fine_packed (N, T, 128) int32, fine_ptab (N, 4097) int32; per lane
    vote_bucket (P,) int64, lane_rc (P,) bool, lane_read (P,) int64 (the
    lane's row of the step's samples); samp_hash/samp_idx (S, p) int64
    and lengths (S,) int32. Returns (prop, valid) (P, p*O) int32 in the
    tally's layout: the sample axis flipped for reverse-complement pairs,
    an invalid occurrence proposing 0 - tgt_idx."""
    rd = lane_read.to(torch.int64)
    wargs, tgt_idx = window_args(fine_packed, fine_ptab, vote_bucket,
                                 lane_rc, samp_hash[rd], samp_idx[rd],
                                 lengths[rd], k, low_bits, search_steps, O)
    P, p = tgt_idx.shape
    pk = fine_window_plain(*wargs).reshape(P, p, O)
    return tally_args(pk, tgt_idx, lane_rc, low_bits)


def fine_search(fine_packed, fine_ptab, vote_bucket, lane_rc, lane_read,
                samp_hash, samp_idx, lengths, k: int, low_bits: int,
                search_steps: int, O: int = MAX_OCC):
    """Fine search: the CUDA kernel on a CUDA table, the plain version on
    a CPU table. Same arguments and results as fine_search_plain. The
    kernel narrows each segment until at most 128 slots are left, however
    many halvings that takes, so it needs no search_steps: the
    occurrences are the first O equal-low slots of the segment either
    way."""
    if fine_packed.device.type == "cpu":
        return fine_search_plain(fine_packed, fine_ptab, vote_bucket,
                                 lane_rc, lane_read, samp_hash, samp_idx,
                                 lengths, k, low_bits, search_steps, O)
    N, T = fine_packed.shape[0], fine_packed.shape[1]
    P = vote_bucket.shape[0]
    S, p = samp_hash.shape
    kernels.require(fine_packed, "fine_packed", torch.int32, (N, T, 128))
    kernels.require(fine_ptab, "fine_ptab", torch.int32,
                    (N, fine_ptab.shape[1]))
    for name, t, dtype, shape in (
            ("vote_bucket", vote_bucket, torch.int64, (P,)),
            ("lane_rc", lane_rc, torch.bool, (P,)),
            ("lane_read", lane_read, torch.int64, (P,)),
            ("samp_hash", samp_hash, torch.int64, (S, p)),
            ("samp_idx", samp_idx, torch.int64, (S, p)),
            ("lengths", lengths, torch.int32, (S,))):
        kernels.require(t, name, dtype, shape)
        if t.device != fine_packed.device:
            raise ValueError(f"{name} and fine_packed must be on the same "
                             f"device")
    dev = fine_packed.device
    prop = torch.empty((P, p * O), dtype=torch.int32, device=dev)
    valid = torch.empty((P, p * O), dtype=torch.int32, device=dev)
    err = kernels.library().bm_fine_search(
        fine_packed.data_ptr(), N, T, fine_ptab.data_ptr(),
        fine_ptab.shape[1], vote_bucket.data_ptr(), lane_rc.data_ptr(),
        lane_read.data_ptr(), P, samp_hash.data_ptr(), samp_idx.data_ptr(),
        lengths.data_ptr(), S, p, O, k, low_bits, prop.data_ptr(),
        valid.data_ptr(), kernels.stream_handle(fine_packed))
    kernels.check(err, "fine_search")
    kernels.LAUNCHES["fine_search"] += 1
    return prop, valid


def scan_occurrences(buckets_packed, bucket_lengths, bucket_ids, tgt_hash,
                     k: int, O: int = MAX_OCC):
    """No fine table (vote.py:477-526): hash every k-mer of each pair's
    bucket, then per sample the top O of lpos - position over the
    matches (the earliest positions, ascending). buckets_packed (N, Wb)
    int32 words, bucket_lengths (N,); bucket_ids (P,), tgt_hash (P, p)
    int64. Returns (occ_pos, occ_valid) (P, p, O); occ_pos is lpos where
    not valid. One sample's (P, lpos) score is alive at a time; lanes
    without a match score 0."""
    lb = buckets_packed.shape[1] * 16
    lpos = lb - k + 1
    b = bucket_ids.to(torch.int64)
    bk = kmer_hashes(unpack_2bit(buckets_packed[b], lb), k)     # (P, lpos)
    bpos = torch.arange(lpos, dtype=torch.int64, device=bk.device)
    # hashes are >= 0: -1 never matches a target
    bk = torch.where(bpos[None, :] <= (bucket_lengths[b].to(
        torch.int64)[:, None] - k), bk, -1)
    rev = (lpos - bpos).to(torch.int32)
    tops = []
    for j in range(tgt_hash.shape[1]):
        score = torch.where(bk == tgt_hash[:, j:j + 1], rev, 0)
        tops.append(torch.topk(score, O, dim=1, sorted=True).values)
        del score
    occ_score = torch.stack(tops, dim=1).to(torch.int64)           # (P, p, O)
    return lpos - occ_score, occ_score > 0


def fine_scan_plain(buckets_packed, bucket_lengths, vote_bucket, lane_rc,
                    lane_read, samp_hash, samp_idx, lengths, k: int,
                    O: int = MAX_OCC):
    """Plain PyTorch version of the fine-scan kernel: the table-free vote
    from a chunk's lanes to the tally's arguments, the composition of the
    lanes' sample gathers, targets, scan_occurrences and proposal_args.

    buckets_packed (N, Wb) int32, bucket_lengths (N,) int64; the lane and
    sample arguments as fine_search_plain's. Returns (prop, valid) (P,
    p*O) int32 in the tally's layout."""
    rd = lane_read.to(torch.int64)
    tgt_hash, tgt_idx = targets(lane_rc, samp_hash[rd], samp_idx[rd],
                                lengths[rd], k)
    occ_pos, occ_valid = scan_occurrences(buckets_packed, bucket_lengths,
                                          vote_bucket, tgt_hash, k, O)
    return proposal_args(occ_pos, occ_valid, tgt_idx, lane_rc)


def fine_scan(buckets_packed, bucket_lengths, vote_bucket, lane_rc,
              lane_read, samp_hash, samp_idx, lengths, k: int,
              O: int = MAX_OCC):
    """Fine scan: the CUDA kernel on a CUDA table, the plain version on a
    CPU table. Same arguments and results as fine_scan_plain."""
    if buckets_packed.device.type == "cpu":
        return fine_scan_plain(buckets_packed, bucket_lengths, vote_bucket,
                               lane_rc, lane_read, samp_hash, samp_idx,
                               lengths, k, O)
    N, Wb = buckets_packed.shape
    P = vote_bucket.shape[0]
    S, p = samp_hash.shape
    # its rows may be a view of wider ones (the align mode's padded genome)
    if not buckets_packed.is_cuda or buckets_packed.dtype != torch.int32 \
            or buckets_packed.stride(1) != 1:
        raise ValueError("buckets_packed must be a CUDA int32 tensor whose "
                         "rows are contiguous")
    for name, t, dtype, shape in (
            ("bucket_lengths", bucket_lengths, torch.int64, (N,)),
            ("vote_bucket", vote_bucket, torch.int64, (P,)),
            ("lane_rc", lane_rc, torch.bool, (P,)),
            ("lane_read", lane_read, torch.int64, (P,)),
            ("samp_hash", samp_hash, torch.int64, (S, p)),
            ("samp_idx", samp_idx, torch.int64, (S, p)),
            ("lengths", lengths, torch.int32, (S,))):
        kernels.require(t, name, dtype, shape)
        if t.device != buckets_packed.device:
            raise ValueError(f"{name} and buckets_packed must be on the same "
                             f"device")
    dev = buckets_packed.device
    prop = torch.empty((P, p * O), dtype=torch.int32, device=dev)
    valid = torch.empty((P, p * O), dtype=torch.int32, device=dev)
    err = kernels.library().bm_fine_scan(
        buckets_packed.data_ptr(), N, Wb, buckets_packed.stride(0),
        bucket_lengths.data_ptr(), vote_bucket.data_ptr(), lane_rc.data_ptr(),
        lane_read.data_ptr(), P, samp_hash.data_ptr(), samp_idx.data_ptr(),
        lengths.data_ptr(), S, p, O, k, prop.data_ptr(), valid.data_ptr(),
        kernels.stream_handle(buckets_packed))
    kernels.check(err, "fine_scan")
    kernels.LAUNCHES["fine_scan"] += 1
    return prop, valid


class FineLocator:
    """Locator sampling and the in-bucket vote on one device, on whichever
    fine tables `tables` holds (vote_path names the path):

      tiled   "fine_packed" (N, Tp, 128) int32 sorted slots (pos <<
              low_bits | low) and "fine_ptab" (N, 4097) int32 prefix
              segment starts: the fine-search kernel narrows each
              segment to <= 128 slots and reads one 3-row window, from
              the lanes to the tally's proposals in one launch;
      packed  "fine_packed" (N, lpos) int32 and "fine_ptab": search_steps
              probes, then one gather per occurrence;
      prefix  "fine_ptab", "fine_low" (N, lpos) int32 hash low bits and
              "fine_pos" (N, lpos) int32 positions in hash order;
      sorted  "fine_pos" and "buckets_packed" (N, Wb) int32 words: a binary
              search over the whole row, hashes derived from the words;
      scan    "buckets_packed" and "bucket_lengths" (N,): the fine-scan
              kernel compares every k-mer of the lane's bucket with every
              sample, from the lanes to the tally's proposals in one
              launch.

    Every path ends in the tally kernel. "search_steps", "low_bits" and
    "locator_sample_tab" complete the tables."""

    def __init__(self, index: BucketIndex, device, tables: dict):
        self.device = resolve_device(device)
        self.cfg = index.config
        self.path = vote_path(tables)
        missing = [n for n in PATH_TABLES[self.path] if tables.get(n) is None]
        if missing:
            raise ValueError(f"the {self.path} vote path needs {missing}")
        self.fine_packed = tables.get("fine_packed")
        self.fine_ptab = tables.get("fine_ptab")
        self.fine_low = tables.get("fine_low")
        self.fine_pos = tables.get("fine_pos")
        self.buckets_packed = tables.get("buckets_packed")
        self.bucket_lengths = tables.get("bucket_lengths")
        self.search_steps = int(tables.get("search_steps", 0))
        self.low_bits = int(tables.get("low_bits", 0))
        self.sample_tab = tables["locator_sample_tab"]
        if self.path == "tiled" and (self.fine_packed.shape[1] < WINDOW_ROWS
                                     or self.fine_packed.shape[2] != 128):
            raise ValueError("a tiled fine_packed must be (N, Tp >= 3, 128)")

    def prepare(self, codes, qual_ok, lengths):
        """Sample p locator k-mers per segment (bucket_locator.h:292-347):
        quality gate only; all valid k-mers when none passes. Returns
        (samp_hash (S, p) int64, samp_idx (S, p) int64)."""
        cfg = self.cfg
        k = cfg.query_seed
        S, L = codes.shape
        K = L - k + 1
        kmers = kmer_hashes(codes, k)
        pos = torch.arange(K, dtype=torch.int64, device=codes.device)
        valid = pos[None, :] < (lengths[:, None].to(torch.int64) - (k - 1))
        good = valid & qual_ok
        num_good = good.sum(dim=1)
        use_all = num_good == 0
        good = torch.where(use_all[:, None], valid, good)
        num_good = torch.where(use_all, valid.sum(dim=1), num_good)
        ub = (num_good - 1).clamp(0, self.sample_tab.shape[0] - 1)
        sel = self.sample_tab[ub]                                   # (S, p)
        rank = torch.cumsum(good.to(torch.int64), dim=1)
        samp_idx = rank_select(rank, sel + 1)
        return torch.gather(kmers, 1, samp_idx), samp_idx

    def _segment(self, bid, prefix):
        """[lo, seg_hi) of the slots with each target's 12-bit prefix."""
        return (self.fine_ptab[bid, prefix].to(torch.int64),
                self.fine_ptab[bid, prefix + 1].to(torch.int64))

    def window_args(self, bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """Tiled path: the fine-window arguments and tgt_idx of these
        pairs (module window_args)."""
        return window_args(self.fine_packed, self.fine_ptab, bucket_ids,
                           is_rc, samp_hash, samp_idx, seg_len,
                           self.cfg.query_seed, self.low_bits,
                           self.search_steps)

    def occurrences(self, bucket_ids, tgt_hash):
        """Packed, prefix and sorted paths: the first MAX_OCC positions
        of each target in its bucket, ascending. Returns
        (occ_pos, occ_valid) (P, p, O); occ_pos is arbitrary where not
        valid."""
        bid = bucket_ids.to(torch.int64)[:, None]
        return getattr(self, "_occ_" + self.path)(bid, tgt_hash)

    def _occ_packed(self, bid, tgt_hash):
        """The host build's (N, lpos) slot table (vote.py:687-697, 756-764):
        full probes, then one gather reads each occurrence's position and
        checks its low bits."""
        fp = self.fine_packed
        lpos = fp.shape[1]
        low_mask = (1 << self.low_bits) - 1
        low = tgt_hash & low_mask
        lo, seg_hi = self._segment(bid, tgt_hash >> self.low_bits)
        lo, _ = lower_bound(
            lo, seg_hi, low, self.search_steps,
            lambda mid: (fp[bid, mid.clamp(0, lpos - 1)] & low_mask)
            .to(torch.int64))
        occ_idx = lo[:, :, None] + torch.arange(MAX_OCC, device=lo.device)
        pk = fp[bid[:, :, None], occ_idx.clamp(0, lpos - 1)]
        valid = (occ_idx < seg_hi[:, :, None]) & \
            ((pk & low_mask) == low[:, :, None])
        return srl(pk, self.low_bits), valid

    def _occ_prefix(self, bid, tgt_hash):
        """fine_low/fine_pos (vote.py:597-644): the prefix segment, probes
        over the low bits, then the equal-low run's positions."""
        fl = self.fine_low
        lpos = self.fine_pos.shape[1]
        low_bits = 2 * self.cfg.query_seed - 12
        low = tgt_hash & ((1 << low_bits) - 1)
        lo, seg_hi = self._segment(bid, tgt_hash >> low_bits)
        lo, _ = lower_bound(
            lo, seg_hi, low, self.search_steps,
            lambda mid: fl[bid, mid.clamp(0, lpos - 1)].to(torch.int64))
        occ_idx = lo[:, :, None] + torch.arange(MAX_OCC, device=lo.device)
        b3 = bid[:, :, None]
        cl = occ_idx.clamp(0, lpos - 1)
        valid = (occ_idx < seg_hi[:, :, None]) & \
            (fl[b3, cl].to(torch.int64) == low[:, :, None])
        return self.fine_pos[b3, cl], valid

    def _hash_at(self, bid, pos):
        """The k-mer hash at base position pos of bucket bid (vote.py:
        545-566) as int64, 0xFFFFFFFF where pos < 0: the k bases come from
        two packed words (16 bases each, first base in the low bits) and
        are reversed by 2-bit groups into the big-endian hash."""
        k = self.cfg.query_seed
        bp = self.buckets_packed
        sp = pos.clamp(min=0)
        w0 = sp >> 4
        sh = 2 * (sp & 15)
        a = bp[bid, w0].to(torch.int64) & MASK32
        b = bp[bid, (w0 + 1).clamp(max=bp.shape[1] - 1)].to(torch.int64) \
            & MASK32
        x = ((a >> sh) | torch.where(sh > 0, b << (32 - sh), 0)) & (4**k - 1)
        for m, s in ((0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8),
                     (0x0000FFFF, 16)):
            x = ((x >> s) & m) | ((x & m) << s)
        return torch.where(pos >= 0, x >> (32 - 2 * k), MASK32)

    def _occ_sorted(self, bid, tgt_hash):
        """fine_pos alone (vote.py:529-594): a lower-bound search of
        bit_length(lpos) steps over the whole row, each probe's hash
        derived from the packed bucket; the occurrences are the next O
        slots clipped to the row (the last slot may repeat), each checked
        against the target."""
        fpos = self.fine_pos
        lpos = fpos.shape[1]
        lo = torch.zeros_like(tgt_hash)
        hi = torch.full_like(tgt_hash, lpos)
        for _ in range(max(1, lpos.bit_length())):
            mid = (lo + hi) // 2
            v = self._hash_at(bid, fpos[bid, mid.clamp(0, lpos - 1)]
                              .to(torch.int64))
            below = v < tgt_hash
            lo = torch.where(below, mid + 1, lo)
            hi = torch.where(below, hi, mid)
        b3 = bid[:, :, None]
        occ_idx = (lo[:, :, None] + torch.arange(MAX_OCC, device=lo.device)
                   ).clamp(0, lpos - 1)
        raw = fpos[b3, occ_idx].to(torch.int64)
        return raw, self._hash_at(b3, raw) == tgt_hash[:, :, None]

    def search_lanes(self, vote_bucket, lane_rc, lane_read, samp_hash,
                     samp_idx, lengths):
        """The vote up to the tally for lanes that name their row of the
        step's samples (fine_search's lane arguments), as the tally's
        arguments: on the tiled path the fine-search kernel and on the
        scan path the fine-scan kernel, straight from the lanes; on the
        others each sample's occurrences in its lane's bucket."""
        k = self.cfg.query_seed
        if self.path == "tiled":
            prop, valid = fine_search(
                self.fine_packed, self.fine_ptab, vote_bucket, lane_rc,
                lane_read, samp_hash, samp_idx, lengths, k, self.low_bits,
                self.search_steps)
            return (prop, valid, *self._tally_consts(samp_hash.shape[1]))
        if self.path == "scan":
            prop, valid = fine_scan(
                self.buckets_packed, self.bucket_lengths, vote_bucket,
                lane_rc, lane_read, samp_hash, samp_idx, lengths, k)
            return (prop, valid, *self._tally_consts(samp_hash.shape[1]))
        tgt_hash, tgt_idx = targets(lane_rc, samp_hash[lane_read],
                                    samp_idx[lane_read], lengths[lane_read], k)
        occ_pos, occ_valid = self.occurrences(vote_bucket, tgt_hash)
        return (*proposal_args(occ_pos, occ_valid, tgt_idx, lane_rc),
                *self._tally_consts(*occ_valid.shape[1:]))

    def search(self, bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """search_lanes for pairs that carry their own samples: pair i
        reads row i."""
        P = bucket_ids.shape[0]
        return self.search_lanes(
            bucket_ids.to(torch.int64), is_rc.to(torch.bool),
            torch.arange(P, dtype=torch.int64, device=bucket_ids.device),
            samp_hash.to(torch.int64).contiguous(),
            samp_idx.to(torch.int64).contiguous(),
            seg_len.to(torch.int32).contiguous())

    def vote(self, bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """bucket_ids (P,), is_rc (P,) bool, samp_hash/samp_idx (P, p),
        seg_len (P,). Returns (offset, votes, accept) (P,) int32: offset
        is the segment start in the bucket."""
        return tally(*self.search(bucket_ids, is_rc, samp_hash, samp_idx,
                                  seg_len))

    def _tally_consts(self, p: int, O: int = MAX_OCC) -> tuple:
        cfg = self.cfg
        return p, O, cfg.allowed_indel, cfg.min_vote, cfg.read_len

    def tally_args(self, pk, tgt_idx, is_rc):
        """Tiled path: window slots (P, p, O), -1 where empty, -> the
        tally's arguments (module tally_args)."""
        return (*tally_args(pk, tgt_idx, is_rc, self.low_bits),
                *self._tally_consts(*pk.shape[1:]))


def locator_sample_tab(index: BucketIndex, device) -> torch.Tensor:
    cfg = index.config
    return torch.from_numpy(
        sample_table(cfg.locator_samples, cfg.read_len).astype(np.int64)
    ).to(device)
