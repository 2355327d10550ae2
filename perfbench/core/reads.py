"""The read pool of a run: reads drawn from `--seed` with their truth,
rendered once as FASTQ bytes that the feeder cycles through.

The draw follows the upstream short-read simulator's model
(tools/short_read_simulator.h, as the port's `sim/simulator.py` copies
it): a bucket uniform over the genome's buckets, a start uniform in
[0, bucket length - read_len - 1), Poisson counts of deletions,
insertions and substitutions applied in that order at uniform positions
of the current sequence (a substitution always changes the base), half
of the reads reverse-complemented, constant quality. It is vectorized
over the reads, one round of edits at a time, so a pool of a million
reads takes seconds.

Every read is named by its instance number in the stream, zero-padded:
to NAME_DIGITS digits, and with two more zeros for each base the read
is shorter than the pool's longest, so that every record has the same
size. The pool is rendered once, as an (N, record) byte matrix, and
each pass over it rewrites only the last NAME_DIGITS digits of the
names, a slice at a time as the slice is written.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from core.genome import Genome

NAME_DIGITS = 10
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CHUNK = 1 << 16


@dataclasses.dataclass
class Pool:
    buf: np.ndarray         # (N * record,) uint8: every record, pass 0
    record: int             # bytes of every record
    lengths: np.ndarray     # (N,) int32
    truth_ref: np.ndarray   # (N,) int32 reference (record) index
    truth_pos: np.ndarray   # (N,) int64 1-based forward position
    truth_rc: np.ndarray    # (N,) bool
    sample: np.ndarray      # (S,) int64 pool indices the check compares
    sample_codes: list      # S uint8 code arrays, as written (FASTQ strand)
    quality: int            # the constant quality character

    @property
    def n(self) -> int:
        return len(self.lengths)

    def offset(self, i: int) -> int:
        """The byte at which record i starts."""
        return i * self.record

    def name(self, i: int, inst: int) -> bytes:
        """The name of pool read i as instance inst."""
        pad = self.record - 2 * int(self.lengths[i]) - NAME_DIGITS - 6
        return b"0" * pad + b"%0*d" % (NAME_DIGITS, inst)

    def set_names(self, k: int, lo: int, hi: int) -> None:
        """Rewrite the names of reads [lo, hi) for pass k over the pool:
        read i is instance k * N + i."""
        m = self.buf.reshape(self.n, self.record)
        pad = (self.record - 2 * self.lengths[lo:hi].astype(np.int64)
               - NAME_DIGITS - 6)
        inst = k * self.n + np.arange(lo, hi, dtype=np.int64)
        for p in np.unique(pad):
            rows = np.flatnonzero(pad == p)
            m[lo + rows, 1 + p:1 + p + NAME_DIGITS] = name_digits(inst[rows])


def name_digits(inst: np.ndarray) -> np.ndarray:
    """(n, NAME_DIGITS) ASCII digits of instance numbers."""
    p = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    return (48 + (inst[:, None] // p) % 10).astype(np.uint8)


def _gather_reads(genome: Genome, rec, gstart, rl: int, out) -> None:
    """out[i, :rl] = the rl bases from gstart[i] of record rec[i], read
    from the packed words a byte (four bases) at a time."""
    lut = ((np.arange(256)[:, None] >> (2 * np.arange(4))) & 3) \
        .astype(np.uint8)
    nb = (rl + 3) // 4 + 1
    for r in range(len(genome.words)):
        wb = genome.words[r].view(np.uint8)
        rows = np.flatnonzero(rec == r)
        for s in range(0, len(rows), _CHUNK):
            rr = rows[s:s + _CHUNK]
            g = gstart[rr]
            idx = np.minimum((g >> 2)[:, None] + np.arange(nb), len(wb) - 1)
            bases = lut[wb[idx]].reshape(len(rr), 4 * nb)
            sh = g & 3
            for k in range(4):
                sel = np.flatnonzero(sh == k)
                out[rr[sel], :rl] = bases[sel, k:k + rl]


def _edit_rounds(codes, lengths, rows, counts, rng, kind: str) -> None:
    """Apply counts[i] edits of one kind to each of the rows, one round
    of one edit a row at a time, each at a uniform position of the
    row's current sequence."""
    W = codes.shape[1]
    col = np.arange(W)
    for k in range(int(counts.max()) if len(counts) else 0):
        r = rows[counts > k]
        L = lengths[r].astype(np.int64)
        p = (rng.random(len(r)) * L).astype(np.int64)
        if kind == "sub":
            codes[r, p] = (codes[r, p] + rng.integers(1, 4, len(r))) % 4
            continue
        seq = codes[r]
        if kind == "del":
            src = col[None, :] + (col[None, :] >= p[:, None])
            seq = np.take_along_axis(seq, np.minimum(src, W - 1), axis=1)
            lengths[r] -= 1
        else:
            new = rng.integers(0, 4, len(r)).astype(np.uint8)
            src = col[None, :] - (col[None, :] > p[:, None])
            seq = np.take_along_axis(seq, src, axis=1)
            seq[np.arange(len(r)), p] = new
            lengths[r] += 1
        seq[col[None, :] >= lengths[r][:, None]] = 0
        codes[r] = seq


def draw(genome: Genome, layout: dict, bucket_len: int, traffic: dict,
         seed: int, sample_reads: int) -> Pool:
    """traffic: the mix's "reads" object (pool, read_len, rates,
    revcomp_share, quality)."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    n = int(traffic["pool"])
    rl = int(traffic["read_len"])
    nb = len(layout["rec"])
    b = rng.integers(0, nb, n)
    blen = layout["length"][b]
    start = rng.integers(0, np.maximum(blen - rl - 1, 1)) * (blen > rl + 1)
    n_sub = rng.poisson(traffic["substitution_rate"] * rl, n)
    n_ins = rng.poisson(traffic["insertion_rate"] * rl, n)
    n_del = rng.poisson(traffic["deletion_rate"] * rl, n)
    rc = rng.random(n) < traffic["revcomp_share"]
    rec = layout["rec"][b]

    width = rl + int(n_ins.max() if n else 0)
    codes = np.zeros((n, width), np.uint8)
    _gather_reads(genome, rec, layout["start"][b] + start, rl, codes)
    lengths = np.full(n, rl, np.int32)
    # deletions, insertions, then substitutions (short_read_simulator.h
    # :114-116)
    for kind, cnt in (("del", n_del), ("ins", n_ins), ("sub", n_sub)):
        rows = np.flatnonzero(cnt > 0)
        _edit_rounds(codes, lengths, rows, cnt[rows], rng, kind)
    for L in np.unique(lengths):
        r = np.flatnonzero(rc & (lengths == L))
        codes[r, :L] = 3 - codes[r, L - 1::-1] if L else codes[r, :0]

    quality = ord(traffic["quality"])
    buf, record = render(codes, lengths, quality)
    # the reads the check compares: drawn from the seed, with the
    # longest read of the pool among them
    sample = np.sort(rng.choice(n, size=min(sample_reads, n), replace=False))
    longest = int(np.argmax(lengths))
    if longest not in set(sample.tolist()):
        sample[0] = longest
        sample = np.sort(sample)
    sample_codes = [codes[i, :lengths[i]].copy() for i in sample]
    return Pool(buf=buf, record=record, lengths=lengths,
                truth_ref=rec.astype(np.int32),
                truth_pos=layout["ordinal"][b] * bucket_len + start + 1,
                truth_rc=rc, sample=sample.astype(np.int64),
                sample_codes=sample_codes, quality=quality)


def render(codes: np.ndarray, lengths: np.ndarray, quality: int):
    """FASTQ bytes of every read, named for pass 0, as one record size:
    (buf, record). A record is '@' name '\\n' seq '\\n+\\n' qual '\\n'."""
    n = len(lengths)
    lmax = int(lengths.max()) if n else 0
    record = 2 * lmax + NAME_DIGITS + 6
    m = np.full((n, record), quality, np.uint8)
    m[:, 0] = ord("@")
    inst = np.arange(n, dtype=np.int64)
    for L in np.unique(lengths):
        rows = np.flatnonzero(lengths == L)
        pad = 2 * (lmax - int(L))
        h = 1 + pad + NAME_DIGITS
        m[rows, 1:1 + pad] = ord("0")
        for s in range(0, len(rows), _CHUNK):
            rr = rows[s:s + _CHUNK]
            m[rr, 1 + pad:h] = name_digits(inst[rr])
            m[rr, h + 1:h + 1 + L] = _ACGT[codes[rr, :L]]
        m[rows, h] = ord("\n")
        m[rows, h + 1 + L] = ord("\n")
        m[rows, h + 2 + L] = ord("+")
        m[rows, h + 3 + L] = ord("\n")
    m[:, record - 1] = ord("\n")
    return m.reshape(-1), record
