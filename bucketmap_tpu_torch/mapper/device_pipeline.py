"""The per-batch device map step on one device.

Counterpart of `bucketmap_tpu/mapper/device_pipeline.py:DeviceMapper`
without the mesh and remote-link branches. One step takes a batch of
packed reads (encoding.pack_reads layout) and returns one int32 result
vector, word for word the JAX step's:

  coarse scoring -> locator sampling -> compaction of the valid
  (read, strand, candidate) lanes by scatter-by-rank -> chunked packed
  vote -> compaction of the accepted lanes into the packed result.

Where the JAX step skips vote chunks whose lanes are all padding with
lax.cond, this step reads the valid-lane total to the host once per
batch and votes only the live chunks; the results are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from bucketmap_tpu.index.builder import BucketIndex
from bucketmap_tpu.ops.encoding import pack_reads
from bucketmap_tpu_torch.device import (MASK32, host_tensor, i64_to_i32,
                                        resolve_device, u32_to_i32,
                                        upload_u32)
from bucketmap_tpu_torch.index.device_build import (build_fine_index_on_device,
                                                    check_fine_sentinel)
from bucketmap_tpu_torch.ops.coarse import CoarseMapper, coarse_tables
from bucketmap_tpu_torch.ops.encoding import unpack_reads
from bucketmap_tpu_torch.ops.vote import (MAX_OCC, FineLocator,
                                          locator_sample_tab)


def build_tables(index: BucketIndex, device) -> dict:
    """All device tables of the step: the coarse tables uploaded from the
    host index, the fine tables built on the device."""
    dev = resolve_device(device)
    built = build_fine_index_on_device(index, dev)
    if built is None:
        raise NotImplementedError(
            "the packed fine index does not apply to this configuration "
            "(needs query_seed <= 15 and 0 <= 2*query_seed - 12 <= 16); "
            "the other vote paths are ROADMAP queue 1 item 9")
    fp, pt, steps, low_bits = built
    tables = coarse_tables(index, dev)
    tables.update(fine_packed=fp, fine_ptab=pt, search_steps=steps,
                  low_bits=low_bits,
                  locator_sample_tab=locator_sample_tab(index, dev))
    return tables


def tables_from_numpy(arrays: dict, device) -> dict:
    """The step's tables from host arrays, e.g. the ones a JAX DeviceMapper
    holds: "qgram_words" (G1, w) uint32, "kmer_to_row" (4^q,) with
    unsampled q-grams already sent to the sentinel row, "dist_tab" uint8,
    "mapper_sample_tab" and "locator_sample_tab" int32, the tiled
    "fine_packed" (N, Tp, 128) uint32, "fine_ptab" (N, 4097) int32, and
    the ints "search_steps" and "low_bits"."""
    dev = resolve_device(device)
    fp = np.asarray(arrays["fine_packed"])
    pt = np.asarray(arrays["fine_ptab"])
    if fp.ndim != 3 or fp.shape[2] != 128:
        raise ValueError("fine_packed must be the tiled (N, Tp, 128) table")
    check_fine_sentinel(fp, pt)

    def t(a, dtype):
        return host_tensor(np.asarray(a, dtype)).to(dev)

    return {
        "qgram_words": upload_u32(np.asarray(arrays["qgram_words"]), dev),
        "kmer_to_row": t(arrays["kmer_to_row"], np.int64),
        "dist_tab": t(arrays["dist_tab"], np.uint8),
        "mapper_sample_tab": t(arrays["mapper_sample_tab"], np.int64),
        "locator_sample_tab": t(arrays["locator_sample_tab"], np.int64),
        "fine_packed": upload_u32(fp, dev),
        "fine_ptab": t(pt, np.int32),
        "search_steps": int(arrays["search_steps"]),
        "low_bits": int(arrays["low_bits"]),
    }


class DeviceMapper:
    def __init__(self, index: BucketIndex, device, batch_size: int = 8192,
                 pairs_per_read: int = 4, vote_chunk: int = 1024,
                 tables: dict | None = None):
        self.device = resolve_device(device)
        self.index = index
        self.cfg = index.config
        self.batch_size = batch_size
        self.vote_chunk = vote_chunk
        if tables is None:
            tables = build_tables(index, self.device)
        self.coarse = CoarseMapper(index, self.device, tables)
        self.fine = FineLocator(index, self.device, tables)
        p = batch_size * pairs_per_read
        self.lane_budget = (p + vote_chunk - 1) // vote_chunk * vote_chunk
        self.out_cap = self._pick_out_cap(batch_size)
        self._init_pack_bits(batch_size)

    def _init_pack_bits(self, rows: int):
        """Bit layout of a packed accepted lane (2 uint32 words):
          w0 = lane | votes << la | bucket_hi << (la + 8)
          w1 = offset | bucket_lo << ob
        lane < rows*2*C (la bits), votes clipped to 8 bits, offset < the
        packed bucket row length (ob bits), the bucket split around the
        32-ob boundary."""
        C = self.cfg.max_candidate_buckets
        nl = max(2, rows * 2 * C)
        self._lane_bits = (nl - 1).bit_length()
        lb = self.index.buckets_packed.shape[1] * 16
        self._off_bits = max(1, int(lb).bit_length())
        nb = max(2, self.index.n_buckets)
        bucket_bits = (nb - 1).bit_length()
        bhi_bits = max(0, bucket_bits - (32 - self._off_bits))
        assert self._lane_bits + 8 + bhi_bits <= 32, \
            (self._lane_bits, self._off_bits, bucket_bits)

    def _pick_out_cap(self, rows: int) -> int:
        """Accepted-lane budget per batch: ~1 location per read on real
        genomes, so 2x rows; overflow re-dispatches the batch split."""
        cap = min(self.lane_budget, max(4 * self.cfg.max_candidate_buckets,
                                        -(-2 * rows // 128) * 128))
        # votes are clipped to 8 bits in the packed lane (_init_pack_bits)
        assert self.cfg.locator_samples * MAX_OCC <= 255
        return cap

    # ------------------------------------------------------------------
    def compact_lanes(self, packed: torch.Tensor) -> dict:
        """Coarse query, locator sampling and compaction of the valid
        (read, strand, candidate) lanes into the lane budget by
        scatter-by-rank (valid lanes first, in lane order; slot P is the
        drop slot, and slots past total_valid read lane 0)."""
        cfg = self.cfg
        C = cfg.max_candidate_buckets
        P = self.lane_budget
        dev = self.device
        codes, qual_ok, lengths = unpack_reads(packed, cfg.read_len,
                                               cfg.query_seed)
        cand, counts, _ = self.coarse.query(codes, qual_ok, lengths)
        samp_hash, samp_idx = self.fine.prepare(codes, qual_ok, lengths)
        flat = cand.reshape(-1)
        lane = torch.arange(flat.shape[0], dtype=torch.int64, device=dev)
        valid = flat >= 0
        rank = torch.cumsum(valid.to(torch.int64), dim=0)
        dst = torch.where(valid & (rank - 1 < P), rank - 1, P)
        sel = torch.zeros(P + 1, dtype=torch.int64, device=dev)
        sel = sel.scatter(0, dst, lane)[:P]
        return {
            "counts": counts, "sel": sel, "total_valid": int(rank[-1]),
            "lane_read": sel // (2 * C), "lane_rc": ((sel // C) % 2).bool(),
            "lane_bucket": flat[sel].clamp(min=0).to(torch.int64),
            "samp_hash": samp_hash, "samp_idx": samp_idx, "lengths": lengths,
        }

    def chunk_args(self, lanes: dict, ci: int):
        """FineLocator.vote arguments of vote chunk ci."""
        ch = self.vote_chunk
        sl = slice(ci * ch, (ci + 1) * ch)
        rd = lanes["lane_read"][sl]
        return (lanes["lane_bucket"][sl], lanes["lane_rc"][sl],
                lanes["samp_hash"][rd], lanes["samp_idx"][rd],
                lanes["lengths"][rd])

    def step_packed(self, packed: torch.Tensor) -> torch.Tensor:
        """packed: (B, cw+qw+1) packed reads on the device. Returns the
        packed int32 result vector (see _pack_result). Vote chunks are
        live while their first lane is below total_valid; dead chunks
        read zeros, as the JAX step's cond does."""
        P = self.lane_budget
        ch = self.vote_chunk
        dev = self.device
        lanes = self.compact_lanes(packed)
        total_valid = lanes["total_valid"]
        off = torch.zeros(P, dtype=torch.int32, device=dev)
        votes = torch.zeros(P, dtype=torch.int32, device=dev)
        acc = torch.zeros(P, dtype=torch.int32, device=dev)
        for ci in range(min(P // ch, -(-total_valid // ch))):
            sl = slice(ci * ch, (ci + 1) * ch)
            off[sl], votes[sl], acc[sl] = self.fine.vote(
                *self.chunk_args(lanes, ci))
        acc = acc.bool() & (torch.arange(P, device=dev) < total_valid)
        return self._pack_result(acc, lanes["sel"], lanes["lane_bucket"], off,
                                 votes, total_valid, lanes["counts"])

    def _pack_result(self, acc, sel, bucket, off, votes, total_valid: int,
                     counts) -> torch.Tensor:
        """One int32 vector, the inverse of decode_out:
          [0]=n_accept [1]=total_valid [2]=local_valid (= total_valid)
          [3]=out_cap [4:8]=0
          [8 : 8+B]          counts (B, 2) as c0 << 16 | c1
          [8+B : 8+B+2*cap]  accepted lanes, 2 words each (_init_pack_bits)
        Slots past n_accept repeat lane 0, as in the JAX step."""
        P = acc.shape[0]
        OC = self.out_cap
        dev = acc.device
        la, ob = self._lane_bits, self._off_bits
        arank = torch.cumsum(acc.to(torch.int64), dim=0)
        dst = torch.where(acc & (arank - 1 < OC), arank - 1, OC)
        aord = torch.zeros(OC + 1, dtype=torch.int64, device=dev).scatter(
            0, dst, torch.arange(P, dtype=torch.int64, device=dev))[:OC]
        bsel = sel[aord] & MASK32
        bbk = bucket[aord] & MASK32
        boff = off[aord].to(torch.int64) & MASK32
        bv = votes[aord].to(torch.int64).clamp(0, 255)
        blo_bits = 32 - ob
        w0 = bsel | (bv << la) | ((bbk >> blo_bits) << (la + 8))
        w1 = boff | ((bbk & ((1 << blo_bits) - 1)) << ob)
        out2 = i64_to_i32(torch.stack([w0, w1], dim=1).reshape(-1))
        cw = i64_to_i32((counts[:, 0].to(torch.int64) << 16)
                        | counts[:, 1].to(torch.int64))
        hdr = torch.tensor([total_valid, total_valid, OC, 0, 0, 0, 0],
                           dtype=torch.int32, device=dev)
        return torch.cat([arank[-1:].to(torch.int32), hdr, cw, out2])

    def decode_out(self, vec) -> dict:
        """Host-side inverse of _pack_result: accepted lanes (lane_read,
        lane_rc, lane_bucket, offset, votes), counts (B, 2), total_valid,
        local_valid and n_accept (one shard)."""
        if isinstance(vec, torch.Tensor):
            vec = vec.cpu().numpy()
        vec = np.ascontiguousarray(vec, dtype=np.int32)
        B = self.batch_size
        C = self.cfg.max_candidate_buckets
        la, ob = self._lane_bits, self._off_bits
        vl = 8 + B + 2 * self.out_cap
        assert vec.shape[0] == vl, (vec.shape, vl)
        na, total_valid, lv = int(vec[0]), int(vec[1]), int(vec[2])
        cwu = vec[8: 8 + B].view(np.uint32)
        counts = np.stack([cwu >> 16, cwu & 0xFFFF], axis=1).astype(np.int32)
        out2 = vec[8 + B:].view(np.uint32).reshape(self.out_cap, 2)
        out2 = out2[: min(na, self.out_cap)]
        w0, w1 = out2[:, 0], out2[:, 1]
        lane = (w0 & np.uint32((1 << la) - 1)).astype(np.int64)
        bucket = ((w1 >> np.uint32(ob)).astype(np.int64)
                  | ((w0 >> np.uint32(la + 8)).astype(np.int64) << (32 - ob)))
        return {
            "lane_read": lane // (2 * C),
            "lane_rc": (lane // C) % 2 == 1,
            "lane_bucket": bucket,
            "offset": (w1 & np.uint32((1 << ob) - 1)).astype(np.int64),
            "votes": ((w0 >> np.uint32(la)) & np.uint32(0xFF)).astype(np.int64),
            "counts": counts,
            "total_valid": total_valid,
            "local_valid": np.array([lv], np.int32),
            "n_accept": np.array([na], np.int32),
        }

    # ------------------------------------------------------------------
    def pack(self, codes: np.ndarray, quals: np.ndarray,
             lengths: np.ndarray) -> torch.Tensor:
        """Host batch -> packed reads on the device (encoding.pack_reads
        layout; the native C packing when available, else numpy)."""
        from bucketmap_tpu.io import native
        packed = native.pack_reads(codes, quals, np.asarray(lengths),
                                   self.cfg.query_seed,
                                   self.cfg.mapper_min_kmer_quality)
        if packed is None:
            packed = pack_reads(codes, quals, np.asarray(lengths),
                                self.cfg.query_seed,
                                self.cfg.mapper_min_kmer_quality)
        return host_tensor(u32_to_i32(packed)).to(self.device)

    def step(self, codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray):
        """Pack and upload a host batch and run the step; returns the
        device result vector."""
        return self.step_packed(self.pack(codes, quals, lengths))
