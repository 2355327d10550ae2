"""Device half of the 2-bit encoding and k-mer hashing, on torch tensors.

Counterpart of `bucketmap_tpu/ops/encoding.py` (unpack_2bit :57,
kmer_hashes :66, revcomp_hash :97, unpack_reads :158), with the same
numeric conventions: base ranks A=0 C=1 G=2 T=3, big-endian base-4
hashes, 16 bases per packed word LSB-first. Hashes and packed words are
int64 holding the unsigned 32-bit value, so shifts need no masking. The
host half (pack_reads, window_quality_sums) is `ops/host_encoding.py`.
"""

from __future__ import annotations

import torch

from bucketmap_tpu_torch.ops.host_encoding import read_pack_words
from bucketmap_tpu_torch.device import MASK32


def unpack_2bit(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., nw) packed words (int32 bits or int64) -> (..., n) uint8 codes."""
    w = words.to(torch.int64) & MASK32
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=words.device)
    bases = ((w[..., :, None] >> shifts) & 3).to(torch.uint8)
    return bases.reshape(*bases.shape[:-2], -1)[..., :n]


def kmer_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = hash(codes[..., i:i+k]) as int64, by log-shift combine;
    the last axis shrinks to len - k + 1. Windows that run past a read's
    true length are the caller's to mask."""
    h = codes.to(torch.int64)
    width = 1
    while width < k:
        step = min(width, k - width)
        n = h.shape[-1]
        h = (h[..., : n - step] << (2 * step)) | (h[..., step:] & (4**step - 1))
        width += step
    return h


def revcomp_hash(h: torch.Tensor, k: int) -> torch.Tensor:
    """Hash of the reverse complement of each k-mer hash (int64)."""
    out = torch.zeros_like(h)
    for i in range(k):
        base = (~(h >> (2 * i))) & 3
        out = out | (base << (2 * (k - 1 - i)))
    return out


def unpack_reads(packed: torch.Tensor, read_len: int, k: int):
    """Inverse of the host transfer packing (encoding.pack_reads):
    (B, cw + qw + 1) words -> (codes (B, L) uint8, qual_ok (B, K) bool,
    lengths (B,) int32)."""
    cw, qw = read_pack_words(read_len, k)
    K = read_len - k + 1
    p = packed.to(torch.int64) & MASK32
    codes = unpack_2bit(p[:, :cw], read_len)
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (p[:, cw:cw + qw, None] >> shifts) & 1
    qual_ok = bits.reshape(p.shape[0], qw * 32)[:, :K] != 0
    lengths = p[:, cw + qw].to(torch.int32)
    return codes, qual_ok, lengths
