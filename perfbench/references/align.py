"""BucketMap's aligned records of a read (upstream's `bucketmap_align`,
locator/bucket_locator.h:520-589): the plain reference of the mixes
that map with `"align": true`, in NumPy, from the genome alone.

Every located (strand, bucket) pair of the read, unmerged, as
`core/reference.py` finds them (`candidates`, `locate`), goes through a
banded semi-global edit alignment: global in the read, free end gaps
on the text only, match 0 and mismatch, insertion and deletion -1. The
record carries that alignment's begin and CIGAR; MAPQ is 60 + score,
wrapped as the upstream's size_t below -60. A record whose MAPQ is
under the configuration's quality_threshold is dropped, unless its
score is under -60: then its MAPQ is (60 + score) & 0xFF, its CIGAR
'*', and it is kept.

The alignment's geometry is the program's, written out here from its
definition (`BandedAligner`, ops/align.py of both packages):

  the query is the read (reads up to 2 * read_len: longer reads take
    the segment-stitched path, which this reference does not cover),
    in a chunk matrix Q = min(chunk width, 2 * read_len) wide, which
    the DP's runs path packs 16 bases a word: its query width is
    q = 16 * ceil(Q / 16);
  band and lo (the diagonals j - i in [-lo, band - lo)) from
    band_geometry(q, indel_rate);
  the text window is wmax = q + band bases of the bucket's packed
    copy (zeros past its end), from word offset // 16, clamped so that
    wmax // 16 + 2 words fit in the widest bucket's words, plus a base
    shift clamped to 16 * (wmax // 16 + 2) - wmax: near a packed
    bucket's end the window starts left of the offset, by an amount
    that depends on Q, so a read's records depend on the width of its
    chunk (`depends`);
  the text is the window's first width = min(len + 1 + trunc(indel_rate
    * len), bucket length - offset) bases, reverse-complemented for a
    reverse-strand pair, sentinel past width, left-padded by lo;
  row 0 is 0 on the text columns 0..width; a cell is the best of the
    diagonal, the cell above (one more query base, 'I') and the run of
    cells to its left ('D'), ties to the diagonal, then up, then left;
  the traceback starts at the final row's first maximum and follows
    the directions to row 0; the begin is the final column - lo; a row
    scoring under -60 is not traced (begin at its first maximum);
  POS = bucket_ordinal * bucket_len + offset + begin + 1 on both
    strands (the upstream's POS quirk, kept), SEQ and QUAL the read's.

The program traces each row by jumps over same-direction chains of at
most 63 cells, 64 jumps (192 at the legacy band of 128), and keeps at
most 128 runs; a sub-batch in which a row overflows that budget is run
again through the cell-by-cell path (`ops_reruns`), whose window is Q +
band (not q + band) bases and whose traceback takes a fixed
ceil((Q + 2 lo) / 4) * 4 steps from the first maximum, rows under -60
included (their begin moves; their CIGAR stays '*'). This reference
follows that path for a read whose own pair overflows; where another
read's pair sends the sub-batch down it, this read's records under -60
and its windows shifted at a bucket's end may differ from the ones
given here (the run's `ops_reruns` counter says whether it happened).
"""

from __future__ import annotations

import math

import numpy as np

from core.reference import Params, ReferenceIndex

NEG = -(10 ** 8)
BAND, LO = 128, 32            # the legacy geometry, and the widest
MAX_ROW_RUNS = 128
RUN_CAP = 63                  # cells a direction byte's run counts at most
_OPS = b"?MID"
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def band_geometry(Q: int, indel_rate: float) -> tuple[int, int]:
    """(band, lo) of a query width Q: the diagonals an alignment can
    reach (window slack plus net-indel drift), Q rounded up to 64; the
    legacy (128, 32) where that would be wider."""
    qb = -(-Q // 64) * 64
    drift = int(math.ceil(indel_rate * qb)) + 8
    lo = -(-drift // 8) * 8
    hi = 1 + int(indel_rate * qb) + drift
    band = max(32, -(-(lo + hi) // 16) * 16)
    if lo > LO or band > BAND:
        return BAND, LO
    return band, lo


def jump_budget(band: int) -> int:
    """The jumps a row's traceback may take on the runs path."""
    return 192 if band >= BAND else 64


def window_start(offset: int, wmax: int, words: int) -> int:
    """The first base, in bucket coordinates, of a wmax-base window."""
    wn = wmax // 16 + 2
    off = max(offset, 0)
    word0 = min(max(off // 16, 0), max(0, words - wn))
    return word0 * 16 + min(max(off - word0 * 16, 0), 16 * wn - wmax)


def dp(textp: np.ndarray, query: np.ndarray, width: np.ndarray, band: int,
       lo: int) -> tuple[np.ndarray, np.ndarray]:
    """The banded DP of P texts against one query of n bases: (H (n + 1,
    P, band) scores, dirs (n + 1, P, band) uint8: 1 diagonal, 2 up, 3
    left, 0 none). textp (P, >= n + band - 1) is the text left-padded
    by lo; cell (i, d) is text column j = i + d - lo, valid for 0 <= j
    <= width."""
    n = len(query)
    P = textp.shape[0]
    d = np.arange(band, dtype=np.int64)
    w = width.astype(np.int64)[:, None, None]
    j = np.arange(n + 1)[None, :, None] + d - lo          # (1, n + 1, band)
    invalid = ((j < 0) | (j > w)).transpose(1, 0, 2)     # (n + 1, P, band)
    win = np.lib.stride_tricks.sliding_window_view(textp, band, axis=1)
    sub = (win[:, :n, :] != query[:, None]).transpose(1, 0, 2)
    H = np.zeros((n + 1, P, band), np.int64)
    H[0][invalid[0]] = NEG
    diag = np.empty((P, band), np.int64)
    up = np.empty((P, band), np.int64)
    for i in range(1, n + 1):
        prev, m = H[i - 1], H[i]
        np.subtract(prev, sub[i - 1], out=diag)
        up[:, :-1] = prev[:, 1:]
        up[:, -1] = NEG
        up -= 1
        np.maximum(diag, up, out=m)
        m += d
        np.maximum.accumulate(m, axis=1, out=m)
        m -= d
        np.copyto(m, NEG, where=invalid[i])
    diag = H[:-1] - sub
    upv = np.concatenate([H[:-1, :, 1:], np.full((n, P, 1), NEG, np.int64)],
                         axis=2) - 1
    m = H[1:]
    dirs = np.zeros((n + 1, P, band), np.uint8)
    dirs[1:] = np.where(m == diag, 1, np.where(m == upv, 2, 3))
    dirs[1:][m <= NEG // 2] = 0
    return H, dirs


def trace_runs(dirs: bytes, band: int, n: int, d: int, jumps: int):
    """The runs path's traceback of one row from (n, d): (runs [(length,
    op)], final d, whether it ended at row 0 within `jumps` jumps)."""
    i, ops = n, []
    while i > 0:
        op = dirs[i * band + min(max(d, 0), band - 1)]
        if op == 0:
            break
        ops.append(op)
        if op != 3:
            i -= 1
        if op == 2:
            d += 1
        elif op == 3:
            d -= 1
    runs = to_runs(reversed(ops))
    used = sum(-(-length // RUN_CAP) for length, _ in runs)
    return runs, d, i == 0 and used <= jumps


def trace_cells(dirs: bytes, band: int, n: int, d: int, steps: int):
    """The cell-by-cell path's traceback of one row from (n, d), `steps`
    steps: (op codes in traceback order, 0 where idle, final d)."""
    i, ops = n, []
    for _ in range(steps):
        op = dirs[i * band + min(max(d, 0), band - 1)] if i > 0 else 0
        ops.append(op)
        if i > 0 and op != 3:
            i -= 1
        if op == 2:
            d += 1
        elif op == 3:
            d -= 1
    return ops, d


def to_runs(ops) -> list:
    """[[length, op]] of op codes in query order, 0 skipped."""
    runs: list[list[int]] = []
    for op in ops:
        if not op:
            continue
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])
    return runs


def cigar(runs) -> bytes:
    return b"".join(b"%d%c" % (length, _OPS[op]) for length, op in runs)


class Aligned:
    depends = ("chunk_width",)

    def __init__(self, index: ReferenceIndex, quality_threshold: int):
        self.index = index
        self.pr = index.pr
        self.names = index.names
        self.layout = index.layout
        self.qt = int(quality_threshold)
        self.words = -(-int(index.layout["length"].max()) // 16)

    def located(self, codes: np.ndarray, quality: int):
        """The read's located pairs, unmerged: [(bucket, offset,
        is_rc)], original strand first."""
        ix, pr = self.index, self.pr
        L = len(codes)
        sl = min(L, pr.read_len)
        seg = codes[:sl]
        qual = np.full(sl, quality - 33, np.int64)
        out = []
        for rc, cands in zip((False, True), ix.candidates(seg, qual)):
            for b in cands:
                got = ix.locate(seg, qual, int(b), rc)
                if got is not None:
                    out.append((int(b), got[0] - (L - sl) if rc else got[0],
                                rc))
        return out

    def texts(self, pairs, L: int, qw: int, band: int, lo: int):
        """(textp (P, lo + qw + band) uint8, width (P,)) of the pairs'
        windows for a query width qw."""
        lay, pr = self.layout, self.pr
        wmax = qw + band
        textp = np.full((len(pairs), lo + wmax), 4, np.uint8)
        width = np.zeros(len(pairs), np.int64)
        j = np.arange(wmax)
        for p, (b, off, rc) in enumerate(pairs):
            length = int(lay["length"][b])
            g0 = window_start(off, wmax, self.words)
            win = np.zeros(wmax, np.uint8)
            stop = min(g0 + wmax, length)
            if stop > g0:
                s = int(lay["start"][b])
                win[:stop - g0] = self.index.genome.codes(
                    int(lay["rec"][b]), s + g0, s + stop)
            w = min(L + 1 + int(pr.indel_rate * L), length - off)
            if rc:
                win = 3 - win[np.clip(w - 1 - j, 0, wmax - 1)]
            textp[p, lo:] = np.where(j < w, win, 4)
            width[p] = w
        return textp, width

    def align(self, pairs, codes: np.ndarray, Q: int,
              rerun: bool | None = None):
        """[(score, begin, runs or None for '*')] of each pair: on the
        runs path, or on the cell-by-cell path where `rerun` says so
        (by default, where one of the pairs overflows the runs path)."""
        L = len(codes)
        q = -(-Q // 16) * 16
        band, lo = band_geometry(q, self.pr.indel_rate)
        textp, width = self.texts(pairs, L, q, band, lo)
        H, dirs = dp(textp, codes, width, band, lo)
        jumps = jump_budget(band)
        out, overflow = [], False
        for p in range(len(pairs)):
            final = H[L, p]
            score = int(final.max())
            d = int(np.argmax(final))
            if score < -60:
                out.append((score, d - lo, None))
                continue
            runs, d, ok = trace_runs(dirs[:, p, :].tobytes(), band, L, d,
                                     jumps)
            overflow |= not ok or len(runs) > MAX_ROW_RUNS
            out.append((score, d - lo, runs))
        if not (overflow if rerun is None else rerun):
            return out
        # the sub-batch runs again cell by cell, at the chunk's Q
        textp, width = self.texts(pairs, L, Q, band, lo)
        H, dirs = dp(textp, codes, width, band, lo)
        max_ops = Q + 2 * lo
        out = []
        for p in range(len(pairs)):
            final = H[L, p]
            score = int(final.max())
            ops, d = trace_cells(dirs[:, p, :].tobytes(), band, L,
                                 int(np.argmax(final)), -(-max_ops // 4) * 4)
            runs = to_runs(reversed(ops[:max_ops])) if score >= -60 else None
            out.append((score, d - lo, runs))
        return out

    def records(self, codes, quality: int, name: bytes, instance) -> list:
        """The SAM records of one read, sorted, as the program writes
        them for an instance of it in a chunk of that width."""
        return self.aligned(codes, quality, name, int(instance.chunk_width))

    def aligned(self, codes, quality: int, name: bytes, chunk_width: int,
                rerun: bool | None = None) -> list:
        """`records` at a chunk width, on the path `rerun` names (see
        `align`)."""
        pr = self.pr
        L = len(codes)
        if L > 2 * pr.read_len:
            raise ValueError(f"a read of {L} bases takes the stitched path")
        pairs = self.located(codes, quality)
        if not pairs:
            return []
        Q = min(chunk_width, 2 * pr.read_len)
        seq = _ACGT[codes].tobytes()
        qs = bytes([quality]) * L
        out = []
        for (b, off, rc), (score, begin, runs) in zip(
                pairs, self.align(pairs, np.asarray(codes, np.uint8), Q,
                                  rerun)):
            mapq = 60 + score
            if score < -60:
                mapq &= 0xFF
            elif mapq < self.qt:
                continue
            pos = (int(self.layout["ordinal"][b]) * pr.bucket_len + off
                   + begin + 1)
            out.append(b"\t".join([
                name, b"16" if rc else b"0",
                self.names[int(self.layout["rec"][b])].encode(),
                b"%d" % pos, b"%d" % mapq, cigar(runs) if runs else b"*",
                b"*", b"0", b"0", seq, qs]))
        return sorted(out)


def ensure(cache_dir: str, state_dir: str, config: dict, genome):
    """Its state is `core/reference.py`'s, in `cache_dir/reference`;
    `state_dir` is not used."""
    index, built = ReferenceIndex.ensure(cache_dir, Params(config["mapper"]),
                                         genome)
    return Aligned(index, config["mapper"]["quality_threshold"]), built
