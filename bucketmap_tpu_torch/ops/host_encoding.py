"""Host half of the 2-bit DNA encoding, k-mer hashing and quality
windows, in numpy.

The port's copy of the numpy paths of `bucketmap_tpu/ops/encoding.py`
(the device half is `ops/encoding.py`, on torch tensors). Numeric
conventions match the reference so that hashes agree:
  * base ranks A=0, C=1, G=2, T=3 (SeqAn3 dna4 rank order),
  * k-mer hash = big-endian base-4 number: hash(s) = sum_i s[i] * 4^(k-1-i)
    (seqan3::views::kmer_hash as used in bucket_indexer.h:57,
    q_gram_mapper.h:431),
  * k-mer quality = rolling sum of phred ranks over each k-window
    (views::kmer_quality, quality_filter.h:611-631).
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code lookup. Unknown characters (incl. 'N') map to 0 ('A'):
# the reference is dna4-only and its datasets are N-stripped
# (benchmark/delete_invalid_bases.sh); seqan3 dna4 converts N->A the same way.
_ASCII_TO_CODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _ASCII_TO_CODE[ord(_c)] = _i
    _ASCII_TO_CODE[ord(_c.lower())] = _i
_CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_ascii(buf: bytes | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes (A=0 C=1 G=2 T=3)."""
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, dtype=np.uint8)
    return _ASCII_TO_CODE[arr]


def decode_to_ascii(codes: np.ndarray) -> bytes:
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes()


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes into uint32 words, 16 bases/word, LSB-first.

    Base j lives in word j//16 at bit 2*(j%16). The tail word is
    zero-padded (padding decodes as 'A'; callers mask by length).
    """
    codes = np.asarray(codes, dtype=np.uint32)
    n = codes.shape[-1]
    pad = (-n) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(codes.shape[:-1] + (pad,), dtype=np.uint32)], axis=-1)
    c = codes.reshape(codes.shape[:-1] + (-1, 16))
    shifts = (2 * np.arange(16, dtype=np.uint32))[tuple([None] * (c.ndim - 1))]
    return np.bitwise_or.reduce(c << shifts, axis=-1).astype(np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """uint32 words -> (..., n) base codes (uint32)."""
    words = words.astype(np.uint32)
    shifts = np.arange(16, dtype=np.uint32) * 2
    bases = (words[..., :, None] >> shifts[None, :]) & np.uint32(3)
    flat = bases.reshape(bases.shape[:-2] + (-1,))
    return flat[..., :n]


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mer hashes of a code array: out[i] = hash(codes[i:i+k]).

    Log-shift combine; output length is len(codes) - k + 1 along the
    last axis. Positions are only valid where the window fits inside the
    *true* (unpadded) sequence — callers mask.
    """
    h = codes.astype(np.uint32)
    width = 1  # number of bases currently encoded in h[i]
    while width < k:
        step = min(width, k - width)
        # h_new[i] = hash of width+step bases: h[i] followed by the step-base
        # suffix of h[i+step] (its low 2*step bits cover [i+width, i+width+step)).
        n = h.shape[-1]
        mask = np.uint32(4**step - 1)
        h = (h[..., : n - step] << np.uint32(2 * step)) | (h[..., step:] & mask)
        width += step
    return h


def revcomp_hash(h: np.ndarray, k: int) -> np.ndarray:
    """Hash of the reverse complement of each k-mer hash (utils.h:291-302):
    complement each 2-bit base (~b & 3) and reverse base order; uint32."""
    h = np.asarray(h, dtype=np.uint32)
    out = np.zeros_like(h)
    for i in range(k):
        base = (~(h >> np.uint32(2 * i))) & np.uint32(3)
        out = out | (base << np.uint32(2 * (k - 1 - i)))
    return out


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a base-code sequence (host side)."""
    return (3 - np.asarray(codes, dtype=np.uint8))[..., ::-1]


def window_quality_sums(qual_ranks: np.ndarray, k: int) -> np.ndarray:
    """Rolling sum of phred ranks over every k-window (views::kmer_quality,
    quality_filter.h:611-631). Output length = len - k + 1 on the last axis."""
    q = qual_ranks.astype(np.int32)
    zero = np.zeros(q.shape[:-1] + (1,), dtype=np.int32)
    cs = np.cumsum(np.concatenate([zero, q], axis=-1), axis=-1)
    return cs[..., k:] - cs[..., : -k]


def read_pack_words(read_len: int, k: int) -> tuple[int, int]:
    """(code_words, qmask_words) per read in the packed transfer layout."""
    cw = (read_len + 15) // 16
    qw = (read_len - k + 1 + 31) // 32
    return cw, qw


def pack_reads(codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray,
               k: int, min_kmer_quality: int) -> np.ndarray:
    """Host-side transfer packing: (B, cw + qw + 1) uint32 holding
    [2-bit codes | per-k-window quality-gate bitmask | length].

    The device only needs the bases and the boolean gate sum(qual ranks
    over k) >= min_kmer_quality: 0.19 B/base packed against ~2 B/base for
    raw codes and qualities, in one array and so one transfer.
    """
    B, L = codes.shape
    cw, qw = read_pack_words(L, k)
    out = np.empty((B, cw + qw + 1), dtype=np.uint32)
    out[:, :cw] = pack_2bit(codes)
    qok = window_quality_sums(quals, k) >= min_kmer_quality   # (B, K)
    K = L - k + 1
    pad = (-K) % 32
    if pad:
        qok = np.concatenate(
            [qok, np.zeros((B, pad), dtype=bool)], axis=1)
    bits = qok.reshape(B, qw, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    out[:, cw:cw + qw] = np.bitwise_or.reduce(bits << shifts, axis=2)
    out[:, cw + qw] = lengths.astype(np.uint32)
    return out
