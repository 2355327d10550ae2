"""Fine stage on torch: in-bucket offset voting on the tiled packed
fine index.

Counterpart of `bucketmap_tpu/ops/vote.py:FineLocator` on its packed
path with the tiled (N, Tp, 128) table the device build makes: per
(pair, sample) the 12-bit hash prefix bounds a segment of the sorted
slot table, `search_steps - 7` binary-search probes narrow it to at most
128 slots, and one 3-sub-tile window yields the sample's occurrences
(the fine-window kernel, `csrc/fine_window.cu`). The occurrences'
implied segment starts then go through the sequential vote (the tally
kernel, `csrc/tally.cu`). On CPU tensors both kernels run as their plain
PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.ops.sampler import sample_table
from bucketmap_tpu_torch import kernels
from bucketmap_tpu_torch.device import resolve_device, srl
from bucketmap_tpu_torch.ops.coarse import rank_select
from bucketmap_tpu_torch.ops.encoding import kmer_hashes, revcomp_hash

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


class FineLocator:
    """Locator sampling and the packed vote on one device.

    tables: "fine_packed" (N, Tp, 128) int32 sorted slots (pos <<
    low_bits | low), "fine_ptab" (N, 4097) int32 prefix segment starts,
    "search_steps", "low_bits", and "locator_sample_tab"."""

    def __init__(self, index: BucketIndex, device, tables: dict):
        self.device = resolve_device(device)
        self.cfg = index.config
        self.fine_packed = tables["fine_packed"]
        self.fine_ptab = tables["fine_ptab"]
        self.search_steps = int(tables["search_steps"])
        self.low_bits = int(tables["low_bits"])
        self.sample_tab = tables["locator_sample_tab"]
        if self.fine_packed.dim() != 3 or self.fine_packed.shape[1] < 3:
            raise ValueError("fine_packed must be the tiled (N, Tp, 128) table")

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

    def window_args(self, bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """Per (pair, sample) target and narrowed slot interval: returns
        the fine-window arguments (ftf, frow, lo_rel, hi_rel, low, O,
        low_bits), flattened over (pair, sample), and tgt_idx (P, p), the
        sample's index in the segment on the bucket's strand."""
        cfg = self.cfg
        k = cfg.query_seed
        fp = self.fine_packed
        N, T = fp.shape[0], fp.shape[1]
        lpos = T * 128
        low_bits = self.low_bits
        low_mask = (1 << low_bits) - 1
        rc = is_rc[:, None]
        tgt_hash = torch.where(rc, revcomp_hash(samp_hash, k), samp_hash)
        tgt_idx = torch.where(rc, seg_len[:, None].to(torch.int64) - k
                              - samp_idx, samp_idx)
        prefix = tgt_hash >> low_bits                               # (P, p)
        low = tgt_hash & low_mask
        bid = bucket_ids.to(torch.int64)[:, None]
        lo = self.fine_ptab[bid, prefix].to(torch.int64)
        seg_hi = self.fine_ptab[bid, prefix + 1].to(torch.int64)
        hi = seg_hi
        # narrow [lo, hi) to <= 128 slots; the window does the rest
        for _ in range(max(0, self.search_steps - 7)):
            active = lo < hi
            mid = (lo + hi) // 2
            mc = mid.clamp(0, lpos - 1)
            v = (fp[bid, mc // 128, mc % 128] & low_mask).to(torch.int64)
            below = active & (v < low)
            lo = torch.where(below, mid + 1, lo)
            hi = torch.where(active & ~below, mid, hi)
        t0 = (lo // 128).clamp(0, T - WINDOW_ROWS)
        base = t0 * 128
        # padding lanes carry arbitrary bucket ids: keep windows in the table
        frow = (bid * T + t0).clamp(0, N * T - WINDOW_ROWS)
        hi_rel = torch.minimum(seg_hi, base + WINDOW_ROWS * 128) - base
        args = (fp.reshape(-1, 128),
                frow.reshape(-1).to(torch.int32),
                (lo - base).reshape(-1).to(torch.int32),
                hi_rel.reshape(-1).to(torch.int32),
                low.reshape(-1).to(torch.int32), MAX_OCC, low_bits)
        return args, tgt_idx

    def vote(self, bucket_ids, is_rc, samp_hash, samp_idx, seg_len):
        """bucket_ids (P,), is_rc (P,) bool, samp_hash/samp_idx (P, p),
        seg_len (P,). Returns (offset, votes, accept) (P,) int32: offset
        is the segment start in the bucket."""
        P, p = samp_hash.shape
        args, tgt_idx = self.window_args(bucket_ids, is_rc, samp_hash,
                                         samp_idx, seg_len)
        pk = fine_window(*args).reshape(P, p, MAX_OCC)
        return tally(*self.tally_args(pk, tgt_idx, is_rc))

    def tally_args(self, pk, tgt_idx, is_rc):
        """Window slots (P, p, O) -> the tally's arguments. Each found slot
        proposes the segment start position - tgt_idx; reverse-complement
        pairs visit their samples last to first (bucket_locator.h:235-236),
        so their sample axis is flipped."""
        cfg = self.cfg
        P, p, O = pk.shape
        occ_valid = pk != -1
        prop = torch.where(occ_valid, srl(pk, self.low_bits), 0).to(torch.int64) \
            - tgt_idx[:, :, None]
        rc = is_rc[:, None, None]
        prop = torch.where(rc, prop.flip(1), prop)
        occ_valid = torch.where(rc, occ_valid.flip(1), occ_valid)
        return (prop.reshape(P, p * O).to(torch.int32).contiguous(),
                occ_valid.reshape(P, p * O).to(torch.int32).contiguous(),
                p, O, cfg.allowed_indel, cfg.min_vote, cfg.read_len)


def locator_sample_tab(index: BucketIndex, device) -> torch.Tensor:
    cfg = index.config
    return torch.from_numpy(
        sample_table(cfg.locator_samples, cfg.read_len).astype(np.int64)
    ).to(device)
