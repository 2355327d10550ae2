"""On-device construction of the tiled packed fine index.

Counterpart of `bucketmap_tpu/index/device_build.py:
build_fine_index_on_device`. Per chunk of buckets: unpack the 2-bit
sequences, hash every k-mer, stable-sort the hashes carrying their
positions (invalid positions hold the 0xFFFFFFFF sentinel and sort
last), pack each slot as (position << low_bits) | low bits of the hash,
and find each 12-bit prefix's first slot with a batched searchsorted.
The slots are stored tiled as (N, Tp, 128) with at least two spare
128-slot rows, so a 3-row fine window never leaves a bucket's table;
the slot order is the host build's (np.argsort(kind="stable")). A row
range builds one bucket shard's table, as
`build_fine_index_on_device_sharded` does on each device of a mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bucketmap_tpu_torch.index.builder import BucketIndex
from bucketmap_tpu_torch.device import i64_to_i32, resolve_device, upload_u32
from bucketmap_tpu_torch.ops.encoding import kmer_hashes, unpack_2bit

SENTINEL = 0xFFFFFFFF
# word columns (32 buckets each) per chunk of the occupancy build
OCCUPANCY_GROUPS = 32


def tiled_rows(lpos: int) -> int:
    """Sub-tile rows per bucket: whole 128-slot rows plus 2 spare, rounded
    up to a multiple of 8 (device_build.py:112)."""
    return -(-(-(-lpos // 128) + 2) // 8) * 8


def _build_chunk(packed_rows, lengths_rows, k: int, lb: int, low_bits: int):
    """(R, Wb) packed buckets -> (fine_packed (R, lpos) int32, fine_ptab
    (R, 4097) int32, count of real slots equal to the sentinel, max
    segment length)."""
    dev = packed_rows.device
    codes = unpack_2bit(packed_rows, lb)
    h = kmer_hashes(codes, k)                                   # (R, lpos)
    del codes
    pos = torch.arange(h.shape[1], dtype=torch.int64, device=dev)
    invalid = pos[None, :] > (lengths_rows[:, None].to(torch.int64) - k)
    h = torch.where(invalid, SENTINEL, h)
    sh, spos = torch.sort(h, dim=1, stable=True)
    del h, invalid
    sinvalid = sh == SENTINEL
    slots = ((spos << low_bits) & SENTINEL) | (sh & ((1 << low_bits) - 1))
    # a real slot equal to the sentinel would read as "no occurrence"
    n_bad = ((slots == SENTINEL) & ~sinvalid).sum()
    fine_packed = i64_to_i32(torch.where(sinvalid, SENTINEL, slots))
    prefix = torch.where(sinvalid, 4096, sh >> low_bits)
    pvals = torch.arange(4097, dtype=torch.int64, device=dev)
    ptab = torch.searchsorted(prefix.contiguous(),
                              pvals.expand(prefix.shape[0], 4097).contiguous(),
                              side="left")
    max_seg = (ptab[:, 1:] - ptab[:, :-1]).max()
    return fine_packed, ptab.to(torch.int32), n_bad, max_seg


def packed_fine_applies(k: int, lb: int) -> bool:
    """Whether the packed slot encoding holds query seed k over packed
    bucket rows of lb bases (device_build.py:97-104): k <= 15 (so the
    sentinel is no hash), 0 <= 2k-12 <= 16, and every position fits
    32 - low_bits bits."""
    low_bits = 2 * k - 12
    return k < 16 and 0 <= low_bits <= 16 and \
        lb - k + 1 <= (1 << (32 - low_bits))


def build_fine_index_on_device(index: BucketIndex, device,
                               row_chunk: int = 1024, rows=None, group=None):
    """Device-resident (fine_packed (N, Tp, 128) int32, fine_ptab (N, 4097)
    int32, search_steps, low_bits) built from index.buckets_packed, or
    None when the packed encoding does not apply (packed_fine_applies).

    rows = (r0, r1) builds only bucket rows [r0, r1), one bucket shard's
    table (build_fine_index_on_device_sharded): rows at or past n_buckets
    are padding, every slot the sentinel and ptab all zero. With a
    process group, search_steps comes from the max segment over the
    group's ranks and the sentinel check covers all of them, as the JAX
    sharded build takes its max over every shard."""
    dev = resolve_device(device)
    cfg = index.config
    k = cfg.query_seed
    n = index.n_buckets
    lb = index.buckets_packed.shape[1] * 16
    if not packed_fine_applies(k, lb):
        return None
    lpos = lb - k + 1
    low_bits = 2 * k - 12
    r0, r1 = (0, n) if rows is None else rows
    Tp = tiled_rows(lpos)
    fp = torch.full((r1 - r0, Tp * 128), -1, dtype=torch.int32, device=dev)
    pt = torch.zeros((r1 - r0, 4097), dtype=torch.int32, device=dev)
    lengths = torch.from_numpy(
        np.asarray(index.bucket_lengths, np.int64)).to(dev)
    n_bad = torch.zeros((), dtype=torch.int64, device=dev)
    max_seg = torch.ones((), dtype=torch.int64, device=dev)
    for s in range(r0, min(r1, n), row_chunk):
        e = min(s + row_chunk, r1, n)
        chunk = upload_u32(np.asarray(index.buckets_packed[s:e]), dev)
        fpc, ptc, bad, ms = _build_chunk(chunk, lengths[s:e], k, lb, low_bits)
        fp[s - r0:e - r0, :lpos] = fpc
        pt[s - r0:e - r0] = ptc
        n_bad += bad
        max_seg = torch.maximum(max_seg, ms)
        del fpc, ptc, chunk
    if group is not None:
        dist.all_reduce(n_bad, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(max_seg, op=dist.ReduceOp.MAX, group=group)
    if int(n_bad):
        raise ValueError(f"{int(n_bad)} fine slots equal the 0xFFFFFFFF "
                         f"sentinel; the packed fine index cannot hold them")
    steps = int(max(1, int(max_seg))).bit_length()
    return fp.reshape(r1 - r0, Tp, 128), pt, steps, low_bits


def check_fine_sentinel(fine_packed: np.ndarray, fine_ptab: np.ndarray) -> None:
    """Raise when a real slot of a host (N, Tp, 128) table is 0xFFFFFFFF:
    slots [0, ptab[:, 4096]) of each bucket are real."""
    n = fine_packed.shape[0]
    flat = np.asarray(fine_packed).reshape(n, -1).view(np.uint32)
    real = np.arange(flat.shape[1])[None, :] < np.asarray(fine_ptab)[:, 4096:4097]
    bad = int(((flat == np.uint32(SENTINEL)) & real).sum())
    if bad:
        raise ValueError(f"{bad} fine slots equal the 0xFFFFFFFF sentinel; "
                         f"the packed fine index cannot hold them")


def _occupancy_chunk(packed_rows, lengths_rows, k2r, q: int, lb: int,
                     g_rows: int) -> torch.Tensor:
    """(G*32, Wb) packed buckets, 32 per word column -> (g_rows, G) int64
    words (device_build.py:238-269). Per group: the keys row << 5 | lane
    of every sampled q-gram, sorted, duplicates dropped, and 1 << lane
    prefix-summed in int64; each row's word is the difference of the sum
    at the searchsorted bounds of the row grid (distinct bits, so the sum
    is the OR)."""
    dev = packed_rows.device
    G = packed_rows.shape[0] // 32
    h = kmer_hashes(unpack_2bit(packed_rows, lb), q)            # (G*32, lpos)
    row = k2r[h]
    pos = torch.arange(h.shape[1], dtype=torch.int64, device=dev)
    invalid = (pos[None, :] > (lengths_rows[:, None] - q)) | (row < 0)
    lane = torch.arange(h.shape[0], dtype=torch.int64, device=dev)[:, None] % 32
    del h
    key = torch.where(invalid, SENTINEL, (row << 5) | lane).reshape(G, -1)
    del row, invalid
    sk = torch.sort(key, dim=1).values
    del key
    prev = torch.cat([torch.full((G, 1), SENTINEL, dtype=torch.int64,
                                 device=dev), sk[:, :-1]], dim=1)
    vals = torch.where((sk != prev) & (sk != SENTINEL), 1 << (sk & 31), 0)
    del prev
    S = torch.cat([torch.zeros((G, 1), dtype=torch.int64, device=dev),
                   torch.cumsum(vals, dim=1)], dim=1)
    grid = torch.arange(g_rows + 1, dtype=torch.int64, device=dev) << 5
    bnd = torch.searchsorted(sk, grid.expand(G, -1).contiguous(), side="left")
    return (torch.gather(S, 1, bnd[:, 1:])
            - torch.gather(S, 1, bnd[:, :-1])).T


def build_occupancy_on_device(index: BucketIndex, device):
    """The q-gram occupancy table (g_rows + 1, w) int32 words on `device`,
    built from index.buckets_packed (device_build.py:275-333): the table
    the coarse stage would otherwise upload, its all-ones sentinel row
    included, OCCUPANCY_GROUPS word columns at a time. None for
    index_seed > 10 (the row grid would dominate), as in the JAX package.
    kmer_to_row is the raw row map: -1 marks an unsampled q-gram, which
    sets no bit."""
    dev = resolve_device(device)
    cfg = index.config
    q = cfg.index_seed
    g_rows = index.qgram_words.shape[0] - 1
    if q > 10 or g_rows <= 0:
        return None
    n = index.n_buckets
    w = -(-n // 32)
    lb = index.buckets_packed.shape[1] * 16
    k2r = torch.from_numpy(np.asarray(index.kmer_to_row, np.int64)).to(dev)
    lengths = np.asarray(index.bucket_lengths, np.int64)
    out = torch.zeros((g_rows + 1, w), dtype=torch.int32, device=dev)
    for c0 in range(0, w, OCCUPANCY_GROUPS):
        gc = min(OCCUPANCY_GROUPS, w - c0)
        r0, r1 = c0 * 32, min((c0 + gc) * 32, n)
        rows = torch.zeros((gc * 32, lb // 16), dtype=torch.int32, device=dev)
        rows[:r1 - r0] = upload_u32(np.asarray(index.buckets_packed[r0:r1]),
                                    dev)
        lens = torch.zeros(gc * 32, dtype=torch.int64, device=dev)
        lens[:r1 - r0] = torch.from_numpy(lengths[r0:r1]).to(dev)
        words = _occupancy_chunk(rows, lens, k2r, q, lb, g_rows)
        out[:g_rows, c0:c0 + gc] = i64_to_i32(words)
        del rows, words
    out[g_rows] = -1
    return out
