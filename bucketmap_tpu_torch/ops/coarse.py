"""Coarse stage on torch: score every bucket against each read's sampled
k-mers and keep the buckets at the maximum hit count.

Counterpart of `bucketmap_tpu/ops/coarse.py:CoarseMapper`. The per-bucket
hit count of a read-strand is the number of its s sampled k-mers whose nq
q-gram occupancy rows all have the bucket's bit; the candidates are the
buckets at the maximum count, cleared when the maximum is below
min_coarse_hits, the read gave up, or more than max_candidate_buckets tie.

The counting takes one of the JAX package's two branches
(`coarse_path`):
  * "fused": one kernel gathers the rows, ANDs them and counts
    (`csrc/coarse_score.cu`, for `_coarse_score_pallas`);
  * "staged": the per-sample presence words are gathered first
    (`csrc/presence_gather.cu`, for `_presence_gather_pallas`) and then
    counted (`csrc/chunk_scan.cu`, for `_chunk_scan_pallas`).
Both give the same words. On CPU tensors each kernel runs as its plain
PyTorch version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bucketmap_tpu_torch.index.builder import BucketIndex
from bucketmap_tpu_torch.ops.host_encoding import window_quality_sums
from bucketmap_tpu_torch.ops.sampler import sample_table
from bucketmap_tpu_torch import kernels
from bucketmap_tpu_torch.device import (MASK32, i64_to_i32, popcount32,
                                        resolve_device, upload_u32)
from bucketmap_tpu_torch.ops.encoding import kmer_hashes, revcomp_hash


def valid_word_mask(colbase: torch.Tensor, bound) -> torch.Tensor:
    """int32 word of valid-bucket bits for words whose first bucket is
    colbase: all ones below `bound`, partial at it, 0 past it."""
    rem = bound - colbase.to(torch.int64)
    part = (torch.ones_like(rem) << rem.clamp(0, 31)) - 1
    m = torch.where(rem >= 32, MASK32, torch.where(rem <= 0, 0, part))
    return i64_to_i32(m)


def word_max_cnt(planes, vmask: torch.Tensor):
    """Per-word max and at-max count of 32 bit-plane-packed counters
    (planes[j] bit b = bit j of bucket b's count), over the buckets set
    in vmask. Fully masked words read max -1, count 32."""
    cand = vmask
    m = torch.zeros(vmask.shape, dtype=torch.int32, device=vmask.device)
    for j in range(len(planes) - 1, -1, -1):
        t = cand & planes[j]
        nz = t != 0
        cand = torch.where(nz, t, cand)
        m = m * 2 + nz.to(torch.int32)
    empty = vmask == 0
    cm = torch.where(empty, -1, m).to(torch.int32)
    cc = torch.where(empty, 32, popcount32(cand)).to(torch.int32)
    return cm, cc


def rank_select(rank: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """First index along the last axis where the non-decreasing running
    count `rank` reaches `target`; 0 where it never does."""
    idx = torch.searchsorted(rank.to(torch.int64).contiguous(),
                             target.to(torch.int64).contiguous(), side="left")
    return torch.where(idx < rank.shape[-1], idx, 0)


def presence_gather_plain(table: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the presence-gather kernel.

    table: (G1, w) int32 occupancy words; rows: (R, nq) table rows of each
    sample's q-grams. Returns (R, w) int32: per sample, the AND of its nq
    rows (_presence_gather_pallas)."""
    rows = rows.to(torch.int64)
    out = table[rows[:, 0]]
    for q in range(1, rows.shape[1]):
        out = out & table[rows[:, q]]
    return out


def chunk_scan_plain(presence: torch.Tensor, bound: int):
    """Plain PyTorch version of the chunk-scan kernel.

    presence: (..., s, w) int32 presence words of s samples; bound: first
    out-of-range bucket. The s words ripple-carry into s.bit_length()
    bit planes, then each word reduces to its max count and at-max count
    over the buckets below `bound`. Returns (cm (..., w) int32, cc (..., w)
    int32, planes (..., n_planes, w) int32), as _chunk_scan_jnp does
    without its 128-word tile padding."""
    s, w = presence.shape[-2:]
    planes = [torch.zeros(presence.shape[:-2] + (w,), dtype=torch.int32,
                          device=presence.device)
              for _ in range(s.bit_length())]
    for i in range(s):
        carry = presence[..., i, :]
        for j in range(len(planes)):
            t = planes[j] & carry
            planes[j] = planes[j] ^ carry
            carry = t
    colbase = torch.arange(w, dtype=torch.int64, device=presence.device) * 32
    cm, cc = word_max_cnt(planes, valid_word_mask(colbase, bound))
    return cm, cc, torch.stack(planes, dim=-2)


def coarse_score_plain(table: torch.Tensor, rows: torch.Tensor, bound: int,
                       s: int):
    """Plain PyTorch version of the coarse-score kernel: the staged pair's
    plain versions one after the other.

    table: (G1, w) int32 occupancy words; rows: (B2*s, nq) table rows of
    each sample's q-grams, s samples per read-strand, sample-minor;
    bound: first out-of-range bucket. Returns (cm (B2, w) int32, cc (B2, w)
    int32, planes (B2, n_planes, w) int32) as _coarse_score_pallas does."""
    B2 = rows.shape[0] // s
    presence = presence_gather_plain(table, rows)
    return chunk_scan_plain(presence.reshape(B2, s, table.shape[1]), bound)


def coarse_score(table: torch.Tensor, rows: torch.Tensor, bound: int, s: int):
    """Coarse score: the CUDA kernel on a CUDA table, the plain version on
    a CPU table. Same arguments and results as coarse_score_plain."""
    if table.device.type == "cpu":
        return coarse_score_plain(table, rows, bound, s)
    R, nq = rows.shape
    if R % s:
        raise ValueError(f"rows ({R}) is not a multiple of s ({s})")
    B2 = R // s
    G1, w = table.shape
    n_planes = s.bit_length()
    kernels.require(table, "table", torch.int32, (G1, w))
    kernels.require(rows, "rows", torch.int32, (R, nq))
    if rows.device != table.device:
        raise ValueError("rows and table must be on the same device")
    cm = torch.empty((B2, w), dtype=torch.int32, device=table.device)
    cc = torch.empty((B2, w), dtype=torch.int32, device=table.device)
    planes = torch.empty((B2, n_planes, w), dtype=torch.int32,
                         device=table.device)
    err = kernels.library().bm_coarse_score(
        table.data_ptr(), w, rows.data_ptr(), B2, s, nq, n_planes, int(bound),
        cm.data_ptr(), cc.data_ptr(), planes.data_ptr(),
        kernels.stream_handle(table))
    kernels.check(err, "coarse_score")
    kernels.LAUNCHES["coarse_score"] += 1
    return cm, cc, planes


def presence_gather(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Presence gather: the CUDA kernel on a CUDA table, the plain version
    on a CPU table. Same arguments and result as presence_gather_plain."""
    if table.device.type == "cpu":
        return presence_gather_plain(table, rows)
    R, nq = rows.shape
    G1, w = table.shape
    kernels.require(table, "table", torch.int32, (G1, w))
    kernels.require(rows, "rows", torch.int32, (R, nq))
    if rows.device != table.device:
        raise ValueError("rows and table must be on the same device")
    out = torch.empty((R, w), dtype=torch.int32, device=table.device)
    err = kernels.library().bm_presence_gather(
        table.data_ptr(), w, rows.data_ptr(), R, nq, out.data_ptr(),
        kernels.stream_handle(table))
    kernels.check(err, "presence_gather")
    kernels.LAUNCHES["presence_gather"] += 1
    return out


def chunk_scan(presence: torch.Tensor, bound: int):
    """Chunk scan: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor. Same arguments and results as chunk_scan_plain."""
    if presence.device.type == "cpu":
        return chunk_scan_plain(presence, bound)
    kernels.require(presence, "presence", torch.int32)
    if presence.dim() < 2:
        raise ValueError("presence must be (..., s, w)")
    lead, (s, w) = presence.shape[:-2], presence.shape[-2:]
    n_planes = s.bit_length()
    dev = presence.device
    cm = torch.empty(lead + (w,), dtype=torch.int32, device=dev)
    cc = torch.empty(lead + (w,), dtype=torch.int32, device=dev)
    planes = torch.empty(lead + (n_planes, w), dtype=torch.int32, device=dev)
    err = kernels.library().bm_chunk_scan(
        presence.data_ptr(), math.prod(lead), s, w, n_planes,
        int(bound), cm.data_ptr(), cc.data_ptr(), planes.data_ptr(),
        kernels.stream_handle(presence))
    kernels.check(err, "chunk_scan")
    kernels.LAUNCHES["chunk_scan"] += 1
    return cm, cc, planes


def occupancy_shard(qgram_words: np.ndarray, bi: int, wr: int) -> np.ndarray:
    """Bucket shard bi's occupancy columns: words [bi*wr, (bi+1)*wr) of the
    (G1, w) table, zero past w (device_pipeline.py:232-240 without the
    1024-word rounding)."""
    qw = np.asarray(qgram_words)
    w = qw.shape[1]
    lo = min(bi * wr, w)
    hi = min(lo + wr, w)
    out = np.zeros((qw.shape[0], wr), qw.dtype)
    out[:, : hi - lo] = qw[:, lo:hi]
    return out


def coarse_tables(index: BucketIndex, device, shard=None,
                  qgram_words: torch.Tensor | None = None) -> dict:
    """The coarse stage's device tables, from the host-built index:
    occupancy words (the 1024-word TPU row padding left out; with shard =
    (bi, wr), bucket shard bi's columns as occupancy_shard cuts them;
    qgram_words, a table already on the device, in place of the upload),
    the FracMinHash row map with unsampled q-grams sent to the all-ones
    sentinel row, the distinguishability gate table and the mapper's
    sample table."""
    cfg = index.config
    n = index.n_buckets
    g = index.qgram_words.shape[0] - 1
    k2r = np.asarray(index.kmer_to_row).astype(np.int32)
    k2r_m = np.where(k2r < 0, g, k2r)
    thr = int(cfg.distinguishability * n)
    per_gram = np.asarray(index.zeros)[k2r_m] >= thr
    if 4**cfg.query_seed <= (1 << 26):
        # gate per whole k-mer: any contained q-gram distinguishable
        qb = np.uint32(4**cfg.index_seed - 1)
        h = np.arange(4**cfg.query_seed, dtype=np.uint32)
        dist = np.zeros(4**cfg.query_seed, dtype=bool)
        for i in range(cfg.qgrams_per_kmer):
            dist |= per_gram[(h >> np.uint32(2 * i)) & qb]
        dist_tab = dist.astype(np.uint8)
    else:
        dist_tab = per_gram.astype(np.uint8)
    if qgram_words is None:
        qw = np.asarray(index.qgram_words)
        if shard is not None:
            qw = occupancy_shard(qw, *shard)
        qgram_words = upload_u32(qw, device)
    return {
        "qgram_words": qgram_words,
        "kmer_to_row": torch.from_numpy(k2r_m.astype(np.int64)).to(device),
        "dist_tab": torch.from_numpy(dist_tab).to(device),
        "mapper_sample_tab": torch.from_numpy(
            sample_table(cfg.mapper_samples, cfg.read_len).astype(np.int64)
        ).to(device),
    }


COARSE_PATHS = ("fused", "staged")


class CoarseMapper:
    """Holds the coarse tables on one device and runs the batch query.
    coarse_path picks the counting branch ("fused" or "staged", see the
    module docstring); the table may be one bucket shard's columns."""

    def __init__(self, index: BucketIndex, device, tables: dict | None = None,
                 coarse_path: str = "fused"):
        if coarse_path not in COARSE_PATHS:
            raise ValueError(f"coarse_path must be one of {COARSE_PATHS}, "
                             f"got {coarse_path!r}")
        self.coarse_path = coarse_path
        self.device = resolve_device(device)
        cfg = index.config
        cfg.validate()
        self.cfg = cfg
        self.n_buckets = index.n_buckets
        g = index.qgram_words.shape[0] - 1
        k2r = np.asarray(index.kmer_to_row)
        # FracMinHash f=1.0 keeps every q-gram in hash order: the row map
        # is the identity and its gather is skipped
        self.k2r_identity = bool(
            k2r.shape[0] == g and np.array_equal(k2r, np.arange(g)))
        self.dist_by_kmer = 4**cfg.query_seed <= (1 << 26)
        if tables is None:
            tables = coarse_tables(index, self.device)
        self.qgram_words = tables["qgram_words"]
        self.kmer_to_row = tables["kmer_to_row"]
        self.dist_tab = tables["dist_tab"]
        self.sample_tab = tables["mapper_sample_tab"]

    def sample_hashes(self, codes, qual_ok, lengths):
        """Distinguishability and quality gating, then deterministic
        sampling of s good k-mers per read (q_gram_mapper.h:414-460).
        Returns (both (B, 2, s) int64 hashes, axis 1 = strand; num_good
        (B,) int32; give_up (B,) bool)."""
        cfg = self.cfg
        k, q = cfg.query_seed, cfg.index_seed
        B, L = codes.shape
        K = L - k + 1
        kmers = kmer_hashes(codes, k)                               # (B, K)
        pos = torch.arange(K, dtype=torch.int64, device=codes.device)
        valid = pos[None, :] < (lengths[:, None].to(torch.int64) - (k - 1))
        if self.dist_by_kmer:
            disting = self.dist_tab[kmers] > 0
        else:
            disting = torch.zeros_like(valid)
            for i in range(k - q + 1):
                gram = (kmers >> (2 * i)) & (4**q - 1)
                disting = disting | (self.dist_tab[gram] > 0)
        good = valid & disting & qual_ok
        num_good = good.sum(dim=1).to(torch.int32)
        give_up = num_good < cfg.min_good_kmers
        # the sel-th good position (rank-match; ranks kept in int64)
        ub = (num_good.to(torch.int64) - 1).clamp(0, self.sample_tab.shape[0] - 1)
        sel = self.sample_tab[ub]                                   # (B, s)
        rank = torch.cumsum(good.to(torch.int64), dim=1)
        samp_pos = rank_select(rank, sel + 1)
        samp_hash = torch.gather(kmers, 1, samp_pos)
        both = torch.stack([samp_hash, revcomp_hash(samp_hash, k)], dim=1)
        return both, num_good, give_up

    def gram_rows(self, both: torch.Tensor) -> torch.Tensor:
        """(B, 2, s) k-mer hashes -> (B*2*s, nq) int32 occupancy rows."""
        cfg = self.cfg
        nq = cfg.qgrams_per_kmer
        shifts = 2 * torch.arange(nq, dtype=torch.int64, device=both.device)
        grams = (both[..., None] >> shifts) & (4**cfg.index_seed - 1)
        rows = grams if self.k2r_identity else self.kmer_to_row[grams]
        return rows.reshape(-1, nq).to(torch.int32).contiguous()

    def presence(self, codes, qual_ok, lengths):
        """Per-sample bucket presence over this table's columns: each
        sample's words are the AND of its nq q-gram occupancy rows
        (_presence_impl). Returns (presence (B, 2, s, w) int32, num_good
        (B,) int32, give_up (B,) bool)."""
        B = codes.shape[0]
        w = self.qgram_words.shape[1]
        both, num_good, give_up = self.sample_hashes(codes, qual_ok, lengths)
        pres = presence_gather(self.qgram_words, self.gram_rows(both))
        return (pres.reshape(B, 2, self.cfg.mapper_samples, w), num_good,
                give_up)

    def score(self, codes, qual_ok, lengths, bound: int):
        """Per-word max hit count, at-max count and bit planes of every
        read-strand over this table's columns, buckets from `bound` on
        masked, through the coarse_path branch. Returns (cm (B, 2, w),
        cc (B, 2, w), planes (B, 2, n_planes, w), num_good (B,), give_up
        (B,))."""
        if self.coarse_path == "staged":
            presence, num_good, give_up = self.presence(codes, qual_ok,
                                                        lengths)
            cm, cc, planes = chunk_scan(presence, bound)
            return cm, cc, planes, num_good, give_up
        B = codes.shape[0]
        w = self.qgram_words.shape[1]
        both, num_good, give_up = self.sample_hashes(codes, qual_ok, lengths)
        cm, cc, planes = coarse_score(self.qgram_words, self.gram_rows(both),
                                      bound, self.cfg.mapper_samples)
        return (cm.reshape(B, 2, w), cc.reshape(B, 2, w),
                planes.reshape(B, 2, -1, w), num_good, give_up)

    def extract_at_max(self, planes, max_hits, live, n: int, col0: int = 0):
        """Bucket ids at the read-strand's max hit count, ascending, -1
        padded to (B, 2, C): flag words of the buckets whose packed count
        equals max_hits (at_max_words), then the c-th set bit of each row
        (set_bit_ids) (coarse.py:_extract_at_max2). planes cover the
        buckets from col0 on; buckets from n on are masked."""
        return self.set_bit_ids(
            self.at_max_words(planes, max_hits, live, n, col0), col0)

    def at_max_words(self, planes, max_hits, live, n: int, col0: int = 0):
        """(B, 2, nc) int32 flag words: bit b of word w set where bucket
        col0 + 32w + b has max_hits hits on a live read-strand."""
        nc = planes.shape[3]
        eq = None
        for j in range(planes.shape[2]):
            gb = ((max_hits >> j) & 1).bool()[..., None]
            pj = planes[:, :, j]
            term = torch.where(gb, pj, ~pj)
            eq = term if eq is None else (eq & term)
        colbase = torch.arange(nc, dtype=torch.int64, device=planes.device) * 32
        vmask = valid_word_mask(colbase, n - col0)
        return torch.where(live[..., None], eq & vmask, 0)

    def set_bit_ids(self, eq, col0: int = 0):
        """The first C set bits of each row of flag words as bucket ids,
        ascending, -1 padded: a search over the running popcount for each
        bit's word, then a halving ladder inside the word."""
        C = self.cfg.max_candidate_buckets
        B, two, _ = eq.shape
        pop = popcount32(eq).to(torch.int64)                        # (B,2,nc)
        wrank = torch.cumsum(pop, dim=-1)                           # inclusive
        total = wrank[..., -1:]
        tgt = torch.arange(1, C + 1, dtype=torch.int64,
                           device=eq.device).expand(B, two, C)
        valid = tgt <= total
        word = torch.where(valid, rank_select(wrank, tgt), 0)
        wval = torch.gather(eq, -1, word).to(torch.int64) & MASK32
        r = tgt - 1 - torch.gather(wrank - pop, -1, word)
        pos = torch.zeros_like(r)
        for width in (16, 8, 4, 2, 1):
            lowc = popcount32(wval & ((1 << width) - 1)).to(torch.int64)
            hi = r >= lowc
            r = torch.where(hi, r - lowc, r)
            pos = pos + torch.where(hi, width, 0)
            wval = torch.where(hi, wval >> width, wval)
        return torch.where(valid, col0 + word * 32 + pos, -1).to(torch.int32)

    def select(self, cm, cc, planes, give_up):
        """The candidate policy over score's output: each read-strand's
        max hit count and at-max count; read-strands below
        min_coarse_hits, given up, or with more than C buckets at the max
        keep none. Returns (cand (B, 2, C) int32 ascending, -1 padded;
        counts (B, 2) int32, 0 where cleared)."""
        max_hits, live, counts = self.policy(cm, cc, give_up)
        return self.extract_at_max(planes, max_hits, live,
                                   self.n_buckets), counts

    def policy(self, cm, cc, give_up):
        """select's policy: (max_hits (B, 2), live (B, 2) bool, counts (B,
        2) int32)."""
        cfg = self.cfg
        max_hits = cm.amax(dim=2)                                   # (B, 2)
        ok = (max_hits >= cfg.min_coarse_hits) & ~give_up[:, None]
        counts = torch.where((cm == max_hits[:, :, None]) & ok[..., None],
                             cc, 0).sum(dim=2).to(torch.int32)
        over = counts > cfg.max_candidate_buckets                  # clear
        counts = torch.where(over, 0, counts).to(torch.int32)
        return max_hits, ok & ~over, counts

    def query(self, codes, qual_ok, lengths):
        """codes (B, L) uint8, qual_ok (B, L-k+1) bool, lengths (B,) int.
        Returns (cand (B, 2, C) int32 ascending, -1 padded; counts (B, 2)
        int32; num_good (B,) int32). Axis 1: 0 = original strand, 1 =
        reverse complement."""
        cm, cc, planes, num_good, give_up = self.score(codes, qual_ok,
                                                       lengths, self.n_buckets)
        return self.select(cm, cc, planes, give_up) + (num_good,)

    def query_batch(self, codes: np.ndarray, quals: np.ndarray,
                    lengths: np.ndarray):
        """Host arrays in, host arrays out; the quality gate is computed
        on the host from raw phred ranks."""
        cfg = self.cfg
        qual_ok = window_quality_sums(np.asarray(quals), cfg.query_seed) \
            >= cfg.mapper_min_kmer_quality
        dev = self.device
        cand, counts, num_good = self.query(
            torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev),
            torch.from_numpy(qual_ok).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev))
        return cand.cpu().numpy(), counts.cpu().numpy(), num_good.cpu().numpy()
