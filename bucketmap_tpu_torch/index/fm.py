"""FM-index family: the reference's unused-alternative index/search stack.

The port's copy of `bucketmap_tpu/index/fm.py`. The host parts (suffix
array, FM-index build, rank/LF, backward search, locate, the artifacts,
the bidirectional index, the per-bucket indexer, the verification DP,
the mapper's seeding and the locator) are numpy, as there; their arrays
and the `.fm_index.npz` / `.bfmi.npz` files are the JAX package's, so an
artifact written by either package loads in the other.

Reference parity (SURVEY §2 rows C4/C5/C14/C15):

  * ``FMIndex`` / ``BiFMIndex`` + ``FMIndexer``  — whole-genome
    (bidirectional) FM-index baseline, serialized to a ``.fm_index``
    artifact (reference ``indexer/fm_indexer.h:14-79``).
  * ``BucketFMIndexer``  — per-bucket FM-indexes, ``.bfmi`` artifact
    (reference ``indexer/bucket_fm_indexer.h:6-25``).
  * ``FMIndexMapper``  — whole-genome search with a total error budget
    and best-hit semantics (reference ``mapper/fm_index_mapper.h:19-73``);
    it returns the hits, which the reference drops.
  * ``FMIndexLocator``  — the reference's ``locator/fm_index_locator.h``
    is an empty stub; this wraps FMIndexMapper into the locator
    interface.

The device part
---------------
``exact_search_batch`` backward-searches B patterns at once on an
explicit torch device: the BWT and the occ checkpoints stay on the
device (uploaded once per FMIndex and device, `FMIndex.device_tables`),
and each of the m steps is a few tensor ops over all lanes: the
occ-checkpoint gather, the CP-wide residual count and the per-lane
mask, as the JAX package's ``lax.fori_loop`` body. It is plain PyTorch
on the card, not a hand-written kernel: the JAX package has no Pallas
kernel for it. Ranks are int64 (the JAX device ranks are int32).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.device import resolve_device
from bucketmap_tpu_torch.io.fasta import FastaRecord

_CP = 32           # occ checkpoint spacing (bases)
_SA_SAMPLE = 32    # suffix-array sampling rate for locate()


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes + implicit terminal sentinel (smallest).

    Prefix-doubling with numpy lexsort; O(n log n) sorts. Returns int64
    positions 0..n (n = the sentinel suffix, always first).
    """
    n = len(codes)
    # ranks over the alphabet, sentinel rank -1 at virtual position n
    rank = np.empty(n + 1, dtype=np.int64)
    rank[:n] = codes.astype(np.int64)
    rank[n] = -1
    sa = np.argsort(rank, kind="stable")
    k = 1
    while k <= n:
        key2 = np.full(n + 1, -1, dtype=np.int64)
        key2[: n + 1 - k] = rank[k:]
        order = np.lexsort((key2, rank))
        # recompute ranks: same (rank, key2) pair -> same new rank
        r_sorted = rank[order]
        k2_sorted = key2[order]
        new_rank = np.empty(n + 1, dtype=np.int64)
        diff = np.empty(n + 1, dtype=bool)
        diff[0] = True
        diff[1:] = (r_sorted[1:] != r_sorted[:-1]) | (k2_sorted[1:] != k2_sorted[:-1])
        new_rank[order] = np.cumsum(diff) - 1
        rank = new_rank
        if rank[order[-1]] == n:  # all distinct
            sa = order
            break
        sa = order
        k *= 2
    return sa


@dataclasses.dataclass
class FMIndex:
    """FM-index over a 2-bit-coded text (codes 0..3) with one sentinel.

    bwt: uint8 (n+1,), 255 at the sentinel's BWT slot.
    occ: int32 (ceil((n+1)/CP)+1, 4) checkpointed symbol counts.
    counts: int64 (5,) C array (#symbols < c, sentinel included).
    sa_ranks/sa_vals: text-position-sampled SA (every SA value = 0 mod
    SS is stored), so every locate() LF-walk terminates in < SS steps;
    sa_ranks is sorted for searchsorted lookup.
    """

    bwt: np.ndarray
    occ: np.ndarray
    counts: np.ndarray
    sa_ranks: np.ndarray
    sa_vals: np.ndarray
    n: int                       # text length (without sentinel)
    ref_names: list[str]
    ref_offsets: np.ndarray      # int64 (n_refs+1,) concatenation offsets
    # device copies for exact_search_batch, by device
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    EXTENSION = ".fm_index"      # fm_indexer.h:18

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, records: list[FastaRecord]) -> "FMIndex":
        names = [r.id for r in records]
        offs = np.zeros(len(records) + 1, dtype=np.int64)
        np.cumsum([len(r.codes) for r in records], out=offs[1:])
        text = (np.concatenate([r.codes for r in records])
                if records else np.zeros(0, np.uint8)).astype(np.uint8)
        sa = suffix_array(text)
        n = len(text)
        bwt = np.where(sa > 0, text[np.maximum(sa - 1, 0)], 255).astype(np.uint8)
        # occ checkpoints: counts of each symbol in bwt[:i*CP]
        n_cp = (n + 1 + _CP - 1) // _CP + 1
        occ = np.zeros((n_cp, 4), dtype=np.int32)
        onehot = np.zeros((n + 1, 4), dtype=np.int32)
        valid = bwt < 4
        onehot[np.nonzero(valid)[0], bwt[valid]] = 1
        csum = np.cumsum(onehot, axis=0)
        for i in range(1, n_cp):
            csum_idx = min(i * _CP, n + 1) - 1
            occ[i] = csum[csum_idx]
        # C[c] = #symbols < c in the text+sentinel (sentinel smallest)
        sym_tot = csum[-1] if n + 1 > 0 else np.zeros(4, np.int64)
        C = np.zeros(5, dtype=np.int64)
        C[0] = 1
        for c in range(1, 5):
            C[c] = C[c - 1] + int(sym_tot[c - 1])
        sampled = np.nonzero(sa % _SA_SAMPLE == 0)[0].astype(np.int64)
        return cls(bwt=bwt, occ=occ, counts=C, sa_ranks=sampled,
                   sa_vals=sa[sampled].astype(np.int64), n=n,
                   ref_names=names, ref_offsets=offs)

    # -- rank / LF ------------------------------------------------------
    def rank(self, c: int, i: np.ndarray) -> np.ndarray:
        """#occurrences of symbol c in bwt[:i] (vectorized over i)."""
        i = np.asarray(i, dtype=np.int64)
        cp = i // _CP
        base = self.occ[cp, c].astype(np.int64)
        # residual scan bwt[cp*CP : i]
        start = cp * _CP
        offs = np.arange(_CP, dtype=np.int64)
        idx = np.minimum(start[..., None] + offs, len(self.bwt) - 1)
        win = self.bwt[idx]
        mask = (start[..., None] + offs) < i[..., None]
        return base + ((win == c) & mask).sum(axis=-1)

    def lf(self, i: np.ndarray) -> np.ndarray:
        """LF mapping for BWT ranks i (sentinel slot maps to 0)."""
        i = np.asarray(i, dtype=np.int64)
        c = self.bwt[i]
        sent = c == 255
        cc = np.where(sent, 0, c).astype(np.int64)
        return np.where(sent, 0, self.counts[cc] + self.rank_sym(cc, i))

    def rank_sym(self, c: np.ndarray, i: np.ndarray) -> np.ndarray:
        cp = i // _CP
        base = self.occ[cp, np.minimum(c, 3)].astype(np.int64)
        start = cp * _CP
        offs = np.arange(_CP, dtype=np.int64)
        idx = np.minimum(start[..., None] + offs, len(self.bwt) - 1)
        win = self.bwt[idx]
        mask = (start[..., None] + offs) < i[..., None]
        return base + ((win == c[..., None]) & mask).sum(axis=-1)

    # -- search ---------------------------------------------------------
    def backward_search(self, pattern: np.ndarray) -> tuple[int, int]:
        """Exact match: returns the SA range [lo, hi) of `pattern`."""
        lo, hi = 0, self.n + 1
        for c in pattern[::-1]:
            c = int(c)
            lo = int(self.counts[c] + self.rank(c, np.int64(lo)))
            hi = int(self.counts[c] + self.rank(c, np.int64(hi)))
            if lo >= hi:
                return lo, lo
        return lo, hi

    def locate(self, lo: int, hi: int, limit: int | None = None) -> np.ndarray:
        """Text positions for SA ranks [lo, hi) via sampled-SA LF walks."""
        ranks = np.arange(lo, hi, dtype=np.int64)
        if limit is not None:
            ranks = ranks[:limit]

        def is_sampled(r):
            i = np.searchsorted(self.sa_ranks, r)
            i = np.minimum(i, len(self.sa_ranks) - 1)
            return self.sa_ranks[i] == r

        steps = np.zeros(len(ranks), dtype=np.int64)
        pos = ranks.copy()
        done = is_sampled(pos)
        for _ in range(_SA_SAMPLE):
            if done.all():
                break
            nxt = self.lf(pos)
            pos = np.where(done, pos, nxt)
            steps = np.where(done, steps, steps + 1)
            done = is_sampled(pos)
        vals = self.sa_vals[np.searchsorted(self.sa_ranks, pos)]
        return (vals + steps) % (self.n + 1)

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
        """(bwt, occ transposed to (4, n_cp) int64, counts int64) on
        `device`, uploaded at the first call for that device and kept on
        the index."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._device:
            self._device[key] = (
                torch.from_numpy(self.bwt.copy()).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    self.occ.T, dtype=np.int64)).to(dev),
                torch.from_numpy(self.counts.astype(np.int64)).to(dev))
        return self._device[key]

    def find_all(self, pattern: np.ndarray, limit: int | None = None) -> np.ndarray:
        lo, hi = self.backward_search(np.asarray(pattern, np.uint8))
        return np.sort(self.locate(lo, hi, limit))

    def pos_to_ref(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Concatenated position -> (ref_index, in-ref position)."""
        pos = np.asarray(pos, dtype=np.int64)
        rid = np.searchsorted(self.ref_offsets, pos, side="right") - 1
        return rid, pos - self.ref_offsets[rid]

    # -- serialization (cereal-blob analog, fm_indexer.h:44-56) ----------
    def save(self, directory: str | os.PathLike, indicator: str) -> str:
        path = os.path.join(str(directory), indicator + self.EXTENSION)
        np.savez_compressed(
            path + ".npz" if not path.endswith(".npz") else path,
            bwt=self.bwt, occ=self.occ, counts=self.counts,
            sa_ranks=self.sa_ranks, sa_vals=self.sa_vals, n=np.int64(self.n),
            ref_names=np.array(self.ref_names, dtype=object),
            ref_offsets=self.ref_offsets, allow_pickle=True)
        return path + ".npz"

    @classmethod
    def load(cls, directory: str | os.PathLike, indicator: str) -> "FMIndex":
        path = os.path.join(str(directory), indicator + cls.EXTENSION + ".npz")
        z = np.load(path, allow_pickle=True)
        return cls(bwt=z["bwt"], occ=z["occ"], counts=z["counts"],
                   sa_ranks=z["sa_ranks"], sa_vals=z["sa_vals"], n=int(z["n"]),
                   ref_names=[str(s) for s in z["ref_names"]],
                   ref_offsets=z["ref_offsets"])


class BiFMIndex:
    """Bidirectional FM-index: forward + reversed-text FM-indexes with
    synchronized ranges (seqan3 ``bi_fm_index`` analog). extend_left
    steps the forward index; extend_right steps the reverse index; both
    keep the twin range in sync via symbol-count bookkeeping."""

    def __init__(self, fwd: FMIndex, rev: FMIndex):
        self.fwd = fwd
        self.rev = rev

    @classmethod
    def build(cls, records: list[FastaRecord]) -> "BiFMIndex":
        rev_records = [FastaRecord(r.id, r.codes[::-1].copy()) for r in records]
        return cls(FMIndex.build(records), FMIndex.build(rev_records))

    def init_range(self):
        return (0, self.fwd.n + 1, 0, self.rev.n + 1)

    def _step(self, idx: FMIndex, lo: int, hi: int, c: int):
        nlo = int(idx.counts[c] + idx.rank(c, np.int64(lo)))
        nhi = int(idx.counts[c] + idx.rank(c, np.int64(hi)))
        return nlo, nhi

    def extend_left(self, state, c: int):
        lo, hi, rlo, rhi = state
        # count symbols smaller than c inside [lo, hi) to shift the twin
        smaller = 0
        for d in range(c):
            dlo, dhi = self._step(self.fwd, lo, hi, d)
            smaller += dhi - dlo
        nlo, nhi = self._step(self.fwd, lo, hi, c)
        width = nhi - nlo
        return (nlo, nhi, rlo + smaller, rlo + smaller + width)

    def extend_right(self, state, c: int):
        lo, hi, rlo, rhi = state
        smaller = 0
        for d in range(c):
            dlo, dhi = self._step(self.rev, rlo, rhi, d)
            smaller += dhi - dlo
        nrlo, nrhi = self._step(self.rev, rlo, rhi, c)
        width = nrhi - nrlo
        return (lo + smaller, lo + smaller + width, nrlo, nrhi)

    def save(self, directory, indicator):
        self.fwd.save(directory, indicator + ".fwd")
        self.rev.save(directory, indicator + ".rev")

    @classmethod
    def load(cls, directory, indicator):
        return cls(FMIndex.load(directory, indicator + ".fwd"),
                   FMIndex.load(directory, indicator + ".rev"))


class FMIndexer:
    """Whole-genome FM-index builder (fm_indexer.h:14-79): reads the
    FASTA, builds the (bidirectional) index, serializes it."""

    EXTENSION = FMIndex.EXTENSION

    def __init__(self, bidirectional: bool = True):
        self.bidirectional = bidirectional
        self._index = None

    def index(self, fasta_records: list[FastaRecord],
              directory: str | os.PathLike, indicator: str) -> int:
        idx = (BiFMIndex.build(fasta_records) if self.bidirectional
               else FMIndex.build(fasta_records))
        idx.save(directory, indicator)
        self._index = idx
        return len(fasta_records)

    def reset(self) -> None:
        self._index = None


class BucketFMIndexer:
    """Per-bucket FM-indexes (bucket_fm_indexer.h:6-25), one artifact
    holding every bucket's arrays. EXTENSION ``.bfmi``."""

    EXTENSION = ".bfmi"

    def __init__(self, cfg: MapperConfig):
        self.cfg = cfg
        self.buckets: list[FMIndex] = []

    def index(self, records: list[FastaRecord],
              directory: str | os.PathLike, indicator: str) -> int:
        from bucketmap_tpu_torch.index.builder import iterate_buckets
        self.buckets = [
            FMIndex.build([FastaRecord(f"{rid}|{start}", codes.copy())])
            for rid, start, codes in iterate_buckets(records, self.cfg)]
        arrays: dict[str, np.ndarray] = {"n_buckets": np.int64(len(self.buckets))}
        for i, b in enumerate(self.buckets):
            arrays[f"bwt_{i}"] = b.bwt
            arrays[f"occ_{i}"] = b.occ
            arrays[f"counts_{i}"] = b.counts
            arrays[f"sar_{i}"] = b.sa_ranks
            arrays[f"sav_{i}"] = b.sa_vals
            arrays[f"meta_{i}"] = np.array([b.n], np.int64)
            arrays[f"name_{i}"] = np.array(b.ref_names, dtype=object)
            arrays[f"offs_{i}"] = b.ref_offsets
        np.savez_compressed(
            os.path.join(str(directory), indicator + self.EXTENSION + ".npz"),
            **arrays, allow_pickle=True)
        return len(self.buckets)

    @classmethod
    def load(cls, cfg: MapperConfig, directory, indicator) -> "BucketFMIndexer":
        z = np.load(os.path.join(str(directory), indicator + cls.EXTENSION + ".npz"),
                    allow_pickle=True)
        out = cls(cfg)
        for i in range(int(z["n_buckets"])):
            out.buckets.append(FMIndex(
                bwt=z[f"bwt_{i}"], occ=z[f"occ_{i}"], counts=z[f"counts_{i}"],
                sa_ranks=z[f"sar_{i}"], sa_vals=z[f"sav_{i}"],
                n=int(z[f"meta_{i}"][0]),
                ref_names=[str(s) for s in z[f"name_{i}"]],
                ref_offsets=z[f"offs_{i}"]))
        return out


# ---------------------------------------------------------------------------
# Batched exact search on a device
# ---------------------------------------------------------------------------

def exact_search_batch(index: FMIndex, patterns: np.ndarray,
                       lengths: np.ndarray, device="cuda"
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Backward-search B patterns at once on `device` (raises where CUDA
    is asked for and absent).

    patterns: (B, m) uint8 codes (left-aligned); lengths: (B,).
    Returns (lo, hi) int64 arrays — the SA range per pattern.

    Step j consumes column len-1-j of every lane whose pattern is that
    long; a lane whose range went empty (lo == hi) keeps stepping, as in
    the JAX function, so its (lo, hi) are the JAX function's, not the
    (lo, lo) at which `FMIndex.backward_search` stops. Steps past the
    longest pattern change no lane and are not run.
    """
    dev = resolve_device(device)
    bwt, occ_t, counts = index.device_tables(dev)
    lens_np = np.asarray(lengths, np.int64)
    pats = torch.from_numpy(np.ascontiguousarray(patterns, np.uint8)).to(dev)
    lens = torch.from_numpy(lens_np.copy()).to(dev)
    B, m = pats.shape
    state = torch.empty((2, B), dtype=torch.int64, device=dev)
    state[0] = 0
    state[1] = index.n + 1
    steps = min(m, int(lens_np.max())) if B else 0
    if steps > 0:
        j = torch.arange(steps, device=dev)
        cols = (lens[:, None] - 1 - j).clamp(0, m - 1)
        c_all = pats.gather(1, cols).to(torch.int64)          # (B, steps)
        active = j < lens[:, None]
        # JAX's gathers clamp: counts[c] at c > 4 reads counts[4]
        base_all = counts[c_all.clamp_max(4)]
        occ_col = c_all.clamp_max(3)
        offs = torch.arange(_CP, device=dev)
        last_bwt, last_cp = bwt.shape[0] - 1, occ_t.shape[1] - 1
        for t in range(steps):
            c = c_all[:, t]
            cp = torch.div(state, _CP, rounding_mode="floor")   # (2, B)
            start = cp * _CP
            pos = start[..., None] + offs
            # the gathers clamp as JAX's do (only a code past the alphabet
            # takes a rank past n + 1); the mask uses the unclamped pos
            win = bwt[pos.clamp_max(last_bwt)]
            hit = (win == c[:, None]) & (pos < state[..., None])
            new = (base_all[:, t] + occ_t[occ_col[:, t], cp.clamp_max(last_cp)]
                   + hit.sum(-1))
            state = torch.where(active[:, t], new, state)
    out = state.cpu().numpy()
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Approximate mapper (C14) and locator (C15)
# ---------------------------------------------------------------------------

def semiglobal_edit(read: np.ndarray, window: np.ndarray) -> tuple[int, int]:
    """Min edit distance of `read` against ANY substring of `window`
    (free leading/trailing gaps in the window) and the substring's end.

    Row-vectorized DP: O(len(read)) numpy passes of width len(window).
    Returns (distance, end_in_window)."""
    lw = len(window)
    j = np.arange(lw + 1, dtype=np.int64)
    prev = np.zeros(lw + 1, dtype=np.int64)   # dp[0][j] = 0: free start
    for i in range(1, len(read) + 1):
        base = np.empty(lw + 1, dtype=np.int64)
        base[0] = i                            # read[:i] vs empty window
        # diagonal (match/mismatch) and vertical (gap in window) moves
        base[1:] = np.minimum(prev[:-1] + (window != read[i - 1]), prev[1:] + 1)
        # horizontal chain cur[j] = min(base[j], cur[j-1]+1)
        #   = j + running-min of (base[j'] - j') over j' <= j
        prev = j + np.minimum.accumulate(base - j)
    end = int(np.argmin(prev))
    return int(prev[end]), end


@dataclasses.dataclass
class FMHit:
    ref_id: int
    position: int
    errors: int


class FMIndexMapper:
    """Whole-genome approximate read mapper over the FM-index
    (fm_index_mapper.h:19-73). Pigeonhole search: split the read into
    max_errors+1 seeds, exact-search every seed of every read in ONE
    batched device call, then verify candidate windows host-side with a
    banded edit DP. hit_all_best semantics: keep only minimal-error hits."""

    def __init__(self, index: FMIndex, max_errors: int = 1,
                 max_locate_per_seed: int = 64, device="cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.max_errors = max_errors
        self.max_locate = max_locate_per_seed
        # concatenated text for verification windows
        self._text = None

    def _ensure_text(self):
        if self._text is None:
            # reconstruct text from BWT via LF walk is O(n); callers that
            # built from records should set .text directly
            raise RuntimeError("set mapper.text (np.uint8 codes) before mapping")

    @property
    def text(self) -> np.ndarray:
        self._ensure_text()
        return self._text

    @text.setter
    def text(self, v: np.ndarray) -> None:
        self._text = np.asarray(v, dtype=np.uint8)

    def seed_batch(self, codes: np.ndarray, lengths: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(patterns (B*ns, L) uint8, lengths (B*ns,), offsets in the read
        (B*ns,)): each read cut evenly into ns = max_errors + 1 seeds,
        read r's seed s in row r*ns + s."""
        B, L = codes.shape
        ns = self.max_errors + 1
        seed_pats = np.zeros((B * ns, L), dtype=np.uint8)
        seed_lens = np.zeros(B * ns, dtype=np.int64)
        seed_offs = np.zeros(B * ns, dtype=np.int64)
        for r in range(B):
            ln = int(lengths[r])
            bounds = np.linspace(0, ln, ns + 1).astype(np.int64)
            for s in range(ns):
                a, b = int(bounds[s]), int(bounds[s + 1])
                seed_pats[r * ns + s, : b - a] = codes[r, a:b]
                seed_lens[r * ns + s] = b - a
                seed_offs[r * ns + s] = a
        return seed_pats, seed_lens, seed_offs

    def map_reads(self, codes: np.ndarray, lengths: np.ndarray) -> list[list[FMHit]]:
        """codes: (B, L) uint8; lengths: (B,). Returns best hits per read."""
        self._ensure_text()
        B = codes.shape[0]
        e = self.max_errors
        ns = e + 1
        seed_pats, seed_lens, seed_offs = self.seed_batch(codes, lengths)
        lo, hi = exact_search_batch(self.index, seed_pats, seed_lens,
                                    self.device)

        results: list[list[FMHit]] = []
        n = self.index.n
        for r in range(B):
            ln = int(lengths[r])
            read = codes[r, :ln]
            best: dict[tuple[int, int], int] = {}
            seen_starts: set[int] = set()
            for s in range(ns):
                i = r * ns + s
                if lo[i] >= hi[i] or seed_lens[i] == 0:
                    continue
                pos = self.index.locate(int(lo[i]), int(hi[i]),
                                        limit=self.max_locate)
                for p in np.asarray(pos):
                    start = int(p) - int(seed_offs[i])
                    if start < -e or start > n - ln + e or start in seen_starts:
                        continue
                    seen_starts.add(start)
                    w0 = max(0, start - e)
                    w1 = min(n, start + ln + e)
                    window = self._text[w0:w1]
                    d, _end = semiglobal_edit(read, window)
                    if d > e:
                        continue
                    # alignment begin: reversed semi-global gives the start
                    _d2, end2 = semiglobal_edit(read[::-1], window[::-1])
                    begin = w0 + (len(window) - end2)
                    rid, rpos = self.index.pos_to_ref(np.int64(begin))
                    key = (int(rid), int(rpos))
                    if key not in best or d < best[key]:
                        best[key] = d
            if not best:
                results.append([])
                continue
            mn = min(best.values())
            results.append([FMHit(k[0], k[1], v) for k, v in sorted(best.items())
                            if v == mn])
        return results


class FMIndexLocator:
    """Reference ``locator/fm_index_locator.h`` is an empty class (C15).

    We keep the row alive as the locator-interface adapter over
    FMIndexMapper: initialize() builds/loads the whole-genome index,
    locate() maps a FASTQ and returns per-read hits."""

    def __init__(self, max_errors: int = 1, device="cuda"):
        self.max_errors = max_errors
        self.device = resolve_device(device)
        self.mapper: FMIndexMapper | None = None

    def initialize(self, records: list[FastaRecord],
                   directory: str | os.PathLike, indicator: str) -> None:
        idx = FMIndex.build(records)
        idx.save(directory, indicator)
        self.mapper = FMIndexMapper(idx, max_errors=self.max_errors,
                                    device=self.device)
        self.mapper.text = np.concatenate([r.codes for r in records]) \
            if records else np.zeros(0, np.uint8)

    def locate(self, codes: np.ndarray, lengths: np.ndarray):
        assert self.mapper is not None, "initialize() first"
        return self.mapper.map_reads(codes, lengths)
