"""The plain reference: BucketMap's align-free mapping of one read, in
NumPy, from the genome alone.

Independent of the program under test: it imports nothing of it and
takes nothing that it made. It builds its own index state from the
configuration's genome (the q-gram occupancy of every bucket) and maps
each read as the upstream mapper's literal algorithm does, one read at
a time:

  coarse (q_gram_mapper.h): every k-mer of the read's first read_len
    bases that passes the quality gate and is distinguishable (one of
    its q-grams kept by FracMinHash and absent from at least
    distinguishability * N buckets); fewer than 0.2 * s of them give up;
    s of them sampled deterministically (utils.h Sampler, in double
    arithmetic); per strand, a bucket's hit count is the number of
    samples whose kept q-grams all occur in it; the buckets at the
    maximum count, if it reaches s - ceil(s * e) + 1 and at most
    max_candidate_buckets buckets share it;
  fine (bucket_locator.h _find_offset): p locator k-mers sampled over
    the quality-passing k-mers; per candidate (strand, bucket) each
    sample's first MAX_OCC occurrences in the bucket, ascending, propose
    a segment start, voted sequentially with the +-ceil(n * read_len)
    indel window after the first sample; the best start (most votes,
    then the smallest) is kept where it has at least p - ceil(e * p)
    votes and lies at 1 or beyond; reverse-strand pairs look for the
    samples' reverse complements, last sample first;
  merge (_filter_best_locations, bucket_locator.h:350-405): the
    locations of a read, by bucket and original strand first, merged
    within +-len * n, every location at the maximum kept;
  SAM: flag 0 or 16, the reference's name, POS = ordinal * bucket_len +
    start + 1, MAPQ = min(60, 6 * votes), CIGAR '*', the read's own
    sequence and quality.

MAX_OCC (8 occurrences a sample) is the one cap that the upstream code
does not have: the program states it (its fine tables keep that many),
and the reference holds it to it.
"""

from __future__ import annotations

import bisect
import json
import math
import multiprocessing
import os
import time

import numpy as np

from core import genome as genome_mod
from core.genome import Genome

MAX_OCC = 8
_BLOCK = 256          # buckets a pass of the occupancy build
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_PRIMES = [
    5, 11, 23, 47, 97, 199, 409, 823, 1741, 3469, 6949, 14033, 28411, 57557,
    116731, 236897, 480881, 976369, 1982627, 4026031, 8175383, 16601593,
    33712729, 68460391, 139022417, 282312799, 573292817, 1164186217,
    2364114217, 4294967291,
]


class Params:
    """The mapper settings of a configuration file's "mapper" object and
    the quantities the upstream code derives from them, with its own
    floating-point expressions."""

    def __init__(self, m: dict):
        self.bucket_len = int(m["bucket_len"])
        self.read_len = int(m["read_len"])
        self.q = int(m["index_seed"])
        self.k = int(m["query_seed"])
        self.s = int(m["mapper_samples"])
        self.distinguishability = float(m["distinguishability"])
        self.base_quality = int(m["average_base_quality"])
        self.miss = float(m["seed_miss_rate"])
        self.indel_rate = float(m["indel_rate"])
        self.p = int(m["locator_samples"])
        self.kmer_fraction = float(m["kmer_fraction"])
        self.max_cand = int(m["max_candidate_buckets"])
        self.hash_table_size = int(m["hash_table_size"])
        self.frac_hash_seed = int(m["frac_hash_seed"])
        self.mapper = dict(m)
        self.fault = int(math.ceil(self.s * self.miss))
        self.min_hits = self.s - self.fault + 1
        self.min_kmer_quality = self.base_quality * self.k
        self.min_vote = self.p - int(math.ceil(self.miss * self.p))
        self.allowed_indel = int(math.ceil(self.indel_rate * self.read_len))


def sample_deterministic(n: int, upper_bound: int) -> np.ndarray:
    """The upstream Sampler: floor(i * (ub + 1) / (n - 1)) in double
    arithmetic for i < n - 1, then ub."""
    if n == 1:
        return np.array([upper_bound], np.int64)
    delta = np.float64(upper_bound + 1) / np.float64(n - 1)
    head = np.floor(np.arange(n - 1, dtype=np.float64) * delta)
    return np.concatenate([head.astype(np.int64), [upper_bound]])


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Big-endian base-4 hash of every k-window (A=0 C=1 G=2 T=3)."""
    n = codes.shape[-1] - k + 1
    h = np.zeros(codes.shape[:-1] + (max(n, 0),), np.uint32)
    for j in range(k):
        h = (h << np.uint32(2)) | codes[..., j:j + n].astype(np.uint32)
    return h


def revcomp_hash(h: np.ndarray, k: int) -> np.ndarray:
    h = np.asarray(h, np.uint32)
    out = np.zeros_like(h)
    for i in range(k):
        base = (~(h >> np.uint32(2 * i))) & np.uint32(3)
        out |= base << np.uint32(2 * (k - 1 - i))
    return out


def frac_rows(pr: Params) -> np.ndarray:
    """q-gram -> row of the kept q-grams, -1 where FracMinHash drops it:
    h(g) = (a g + b) mod P mod T kept where h(g) <= T * f, a and b drawn
    from a RandomState seeded with frac_hash_seed (main.cpp:176-185; the
    upstream seeds it with the time)."""
    size = pr.hash_table_size
    P = next(x for x in _PRIMES if x > 10 * size)
    rng = np.random.RandomState(pr.frac_hash_seed)
    a = rng.randint(1, P - 1)
    b = rng.randint(0, P)
    g = np.arange(4 ** pr.q, dtype=np.uint64)
    hv = (np.uint64(a) * g + np.uint64(b)) % np.uint64(P) % np.uint64(size)
    keep = hv <= np.uint64(int(size * pr.kmer_fraction))
    return np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int64)


class ReferenceIndex:
    """Occupancy bits of the kept q-grams over the buckets, (G, ceil(N /
    8)) uint8, bit b % 8 of byte b // 8 for bucket b; the number of
    buckets holding each kept q-gram; the bucket layout."""

    def __init__(self, pr: Params, genome: Genome, occ, present, rows):
        self.pr = pr
        self.genome = genome
        self.layout = genome.buckets(pr.bucket_len, pr.read_len)
        self.n = len(self.layout["rec"])
        self.occ = occ
        self.rows = rows
        self.threshold = int(pr.distinguishability * self.n)
        self.zeros = self.n - present
        self.names = [nm.split(" ")[0] for nm in genome.names]
        self._bucket_hash: dict[int, np.ndarray] = {}

    # -- building ---------------------------------------------------------
    @staticmethod
    def build_arrays(pr: Params, genome: Genome):
        """(occ, present, rows), built in this process."""
        rows = frac_rows(pr)
        layout = genome.buckets(pr.bucket_len, pr.read_len)
        occ = np.zeros((int((rows >= 0).sum()), -(-len(layout["rec"]) // 8)),
                       np.uint8)
        present = _build_range(pr, genome, rows, layout, occ, 0,
                               len(layout["rec"]))
        return occ, present, rows

    @classmethod
    def ensure(cls, cache_dir: str, pr: Params, genome: Genome,
               workers: int | None = None):
        """(index, seconds spent building it, 0 on a cache hit). A build
        splits the buckets over `workers` processes (default: one a
        core), each writing its columns of the saved table."""
        d = os.path.join(cache_dir, "reference")
        built = 0.0
        if not os.path.exists(os.path.join(d, "done.json")):
            t0 = time.perf_counter()
            os.makedirs(d, exist_ok=True)
            rows = frac_rows(pr)
            n = len(genome.buckets(pr.bucket_len, pr.read_len)["rec"])
            path = os.path.join(d, "occ.npy")
            occ = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.uint8,
                shape=(int((rows >= 0).sum()), -(-n // 8)))
            del occ
            jobs = [(b0, min(b0 + 2 * _BLOCK, n))
                    for b0 in range(0, n, 2 * _BLOCK)]
            workers = min(workers or os.cpu_count() or 1, len(jobs))
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(workers, initializer=_build_worker,
                          initargs=(cache_dir, pr.mapper, path)) as pool:
                present = sum(pool.imap_unordered(_build_job, jobs))
            np.save(os.path.join(d, "present.npy"), present)
            built = time.perf_counter() - t0
            with open(os.path.join(d, "done.json"), "w") as f:
                json.dump({"buckets": n, "seconds": built}, f)
        occ = np.load(os.path.join(d, "occ.npy"), mmap_mode="r")
        present = np.load(os.path.join(d, "present.npy"))
        return cls(pr, genome, occ, present, frac_rows(pr)), built

    # -- mapping ----------------------------------------------------------
    def _bits(self, rows: np.ndarray) -> np.ndarray:
        return np.unpackbits(np.asarray(self.occ[rows]), axis=1,
                             count=self.n, bitorder="little").astype(bool)

    def candidates(self, seg: np.ndarray, qual: np.ndarray):
        """(original strand's, reverse strand's) candidate buckets."""
        pr = self.pr
        k, q = pr.k, pr.q
        if len(seg) < k:
            return [], []
        h = kmer_hashes(seg, k)
        grams = (h[:, None] >> (2 * np.arange(k - q + 1, dtype=np.uint32))) \
            & np.uint32(4 ** q - 1)
        r = self.rows[grams.astype(np.int64)]
        dist = ((r >= 0) & (self.zeros[np.maximum(r, 0)] >= self.threshold)
                ).any(axis=1)
        good = dist & self.quality_ok(qual, len(h))
        ng = int(good.sum())
        if ng < 0.2 * pr.s:
            return [], []
        samp = h[good][sample_deterministic(pr.s, ng - 1)]
        out = []
        for hs in (samp, revcomp_hash(samp, k)):
            g = (hs[:, None] >> (2 * np.arange(k - q + 1, dtype=np.uint32))) \
                & np.uint32(4 ** q - 1)
            rr = self.rows[g.astype(np.int64)]
            uniq = np.unique(rr[rr >= 0])
            bits = self._bits(uniq) if len(uniq) else None
            count = np.zeros(self.n, np.int64)
            for row in rr:
                hit = np.ones(self.n, bool)
                for x in row[row >= 0]:
                    hit &= bits[np.searchsorted(uniq, x)]
                count += hit
            top = int(count.max())
            cand = np.flatnonzero(count == top) if top >= pr.min_hits else []
            out.append(list(cand) if len(cand) <= pr.max_cand else [])
        return out[0], out[1]

    def quality_ok(self, qual: np.ndarray, n: int) -> np.ndarray:
        k = self.pr.k
        cs = np.concatenate([[0], np.cumsum(qual.astype(np.int64))])
        return (cs[k:k + n] - cs[:n]) >= self.pr.min_kmer_quality

    def bucket_hashes(self, b: int) -> np.ndarray:
        h = self._bucket_hash.get(b)
        if h is None:
            lay = self.layout
            s = int(lay["start"][b])
            h = kmer_hashes(self.genome.codes(int(lay["rec"][b]), s,
                                              s + int(lay["length"][b])),
                            self.pr.k)
            if len(self._bucket_hash) > 64:
                self._bucket_hash.clear()
            self._bucket_hash[b] = h
        return h

    def locate(self, seg: np.ndarray, qual: np.ndarray, bucket: int,
               rc: bool, p: int | None = None):
        """_find_offset: (segment start, votes) or None."""
        pr = self.pr
        k = pr.k
        p = pr.p if p is None else p
        h = kmer_hashes(seg, k)
        good = self.quality_ok(qual, len(h))
        if not good.any():
            good = np.ones(len(h), bool)
        pos = np.flatnonzero(good)
        sel = sample_deterministic(p, min(len(pos) - 1, pr.read_len))
        idx = pos[sel]
        tgt = h[idx]
        if rc:
            tgt = revcomp_hash(tgt, k)[::-1]
            idx = (len(seg) - k - idx)[::-1]
        bh = self.bucket_hashes(bucket)
        votes: dict[int, int] = {}
        for t, i in zip(tgt, idx):
            props = np.flatnonzero(bh == t)[:MAX_OCC] - int(i)
            exact = not votes
            for x in props.tolist():
                if exact:
                    votes[x] = votes.get(x, 0) + 1
                    continue
                close = [y for y in votes if abs(y - x) <= pr.allowed_indel]
                for y in close:
                    votes[y] += 1
                if not close:
                    votes[x] = 1
        if not votes:
            return None
        start, v = max(votes.items(), key=lambda kv: (kv[1], -kv[0]))
        if v >= pr.min_vote and start >= 1:
            return start, v
        return None

    def records(self, codes: np.ndarray, quality: int, name: bytes,
                p: int | None = None) -> list[bytes]:
        """The SAM records of one read, sorted."""
        pr = self.pr
        L = len(codes)
        sl = min(L, pr.read_len)
        seg = codes[:sl]
        qual = np.full(sl, quality - 33, np.int64)
        cand_o, cand_r = self.candidates(seg, qual)
        locs = []
        for rc, cands in ((False, cand_o), (True, cand_r)):
            for b in cands:
                got = self.locate(seg, qual, int(b), rc, p)
                if got is None:
                    continue
                start, v = got
                off = start - (L - sl) if rc else start
                locs.append((int(b), int(off), v, not rc))
        locs.sort(key=lambda x: (x[0], not x[3]))
        seq = _ACGT[codes].tobytes()
        qs = bytes([quality]) * L
        out = []
        for b, off, v, orig in filter_best(locs, L, pr.indel_rate):
            ref = self.names[int(self.layout["rec"][b])]
            pos = int(self.layout["ordinal"][b]) * pr.bucket_len + off + 1
            out.append(b"\t".join([
                name, b"0" if orig else b"16", ref.encode(),
                str(pos).encode(), str(min(60, 6 * v)).encode(), b"*", b"*",
                b"0", b"0", seq, qs]))
        return sorted(out)


def filter_best(locs, read_length: int, indel_rate: float):
    """_filter_best_locations: locs (bucket, offset, votes, is_orig) in
    order; the kept (bucket, offset, votes, is_orig), by key."""
    total: dict = {}
    keys: list = []
    for b, off, v, orig in locs:
        key = (b, off, orig)
        if not total:
            total[key] = v
            keys.append(key)
            continue
        lo = int(off - read_length * indel_rate)
        hi = int(off + read_length * indel_rate)
        i0 = bisect.bisect_left(keys, (b, lo, False))
        i1 = bisect.bisect_right(keys, (b, hi, True))
        found = False
        for kk in keys[i0:i1]:
            if lo <= kk[1] <= hi and kk[2] == orig:
                total[kk] += v
                found = True
        if not found:
            if key in total:
                total[key] += v
            else:
                total[key] = v
                bisect.insort(keys, key)
    best, top = [], 0
    for kk in keys:
        v = total[kk]
        if v > top:
            best, top = [], v
        if v == top:
            best.append((kk[0], kk[1], v, kk[2]))
    return best


def _build_range(pr: Params, genome: Genome, rows, layout, occ, b0: int,
                 b1: int) -> np.ndarray:
    """Occupancy columns of buckets [b0, b1) (b0 a multiple of 8) into
    occ; the number of these buckets holding each kept q-gram."""
    kept = np.flatnonzero(rows >= 0)
    nq = 4 ** pr.q
    present = np.zeros(len(kept), np.int64)
    width = int(layout["length"].max())
    for c0 in range(b0, b1, _BLOCK):
        c1 = min(c0 + _BLOCK, b1)
        codes = np.zeros((c1 - c0, width), np.uint8)
        for j, b in enumerate(range(c0, c1)):
            s = int(layout["start"][b])
            codes[j, :layout["length"][b]] = genome.codes(
                int(layout["rec"][b]), s, s + int(layout["length"][b]))
        g = kmer_hashes(codes, pr.q).astype(np.int64)
        col = np.arange(g.shape[1])
        g[col[None, :] >= (layout["length"][c0:c1] - pr.q + 1)[:, None]] = nq
        pres = np.zeros((c1 - c0, nq + 1), bool)
        pres[np.arange(c1 - c0)[:, None], g] = True
        pres = pres[:, kept] if len(kept) < nq else pres[:, :nq]
        present += pres.sum(axis=0)
        occ[:, c0 // 8: c0 // 8 + -(-(c1 - c0) // 8)] = np.packbits(
            pres, axis=0, bitorder="little").T
    return present


_worker: dict = {}


def _build_worker(cache_dir: str, mapper: dict, path: str) -> None:
    pr = Params(mapper)
    genome = genome_mod.load(os.path.join(cache_dir, "genome"))
    _worker.update(pr=pr, genome=genome, rows=frac_rows(pr),
                   layout=genome.buckets(pr.bucket_len, pr.read_len),
                   occ=np.load(path, mmap_mode="r+"))


def _build_job(job) -> np.ndarray:
    w = _worker
    present = _build_range(w["pr"], w["genome"], w["rows"], w["layout"],
                           w["occ"], *job)
    w["occ"].flush()
    return present
