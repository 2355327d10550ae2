"""The yardstick of the kernels: the card's peaks and the bytes and
operations each kernel call needs, from its shapes.

Frozen from the port's chip_smoke.py bounds (`coarse_bound`,
`search_bound`) and the published peaks of one NVIDIA H100 SXM (80 GB
of HBM at 3.35 TB/s; 16.7 T int32 operations a second, the rate the
port's kernel table uses). A kernel's least time is the larger of its
bytes over the bandwidth and its operations over the rate; its share of
the roofline is that time over the time the trace gives it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12


def least_seconds(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)


def coarse_score_call(batch: int, s: int, words: int, rows: int,
                      nq: int) -> tuple[float, float]:
    """(bytes, int ops) of one coarse_score launch over a batch of reads:
    R = 2 * batch * s sample rows of nq q-gram row indices each. The
    distinct occupancy rows are read once (at most the table's `rows`,
    which a full batch nearly covers), the row indices once, the three
    outputs (max, count and `planes` bit planes per read-strand word);
    an AND per gathered row word, 3 ops per plane per sample word for
    the ripple-carry count, 4 per plane per output word for max and
    count."""
    b2 = 2 * batch
    r = b2 * s
    planes = s.bit_length()
    nbytes = (min(r * nq, rows) * words * 4 + r * nq * 4
              + b2 * words * 4 * (2 + planes))
    nops = r * words * (nq - 1 + 3 * planes) + b2 * words * 4 * planes
    return float(nbytes), float(nops)


def fine_search_pairs(pairs: int, reads: int, p: int,
                      max_occ: int = 8) -> tuple[float, float]:
    """(bytes, int ops) of the fine search over `pairs` voted (read,
    strand, bucket) lanes of `reads` reads: per (pair, sample) its
    window of three 128-slot table rows (512 bytes each), one 32-byte
    sector of the prefix table and its two max_occ-slot int32 outputs;
    per pair its bucket, strand and read (17 bytes); per read its
    samples and length. 4 ops per window slot (mask, compare, range)."""
    windows = pairs * p
    nbytes = (windows * (3 * 512 + 32 + 2 * max_occ * 4) + pairs * 17
              + reads * (p * 16 + 4))
    return float(nbytes), float(windows * 384 * 4)
