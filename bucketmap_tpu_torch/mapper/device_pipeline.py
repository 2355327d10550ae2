"""The per-batch device map step, on one device or over a mesh.

Counterpart of `bucketmap_tpu/mapper/device_pipeline.py:DeviceMapper`
without the remote-link branches. One step takes a batch of packed reads
(encoding.pack_reads layout) and returns one int32 result vector, word
for word the JAX step's:

  coarse scoring -> locator sampling -> compaction of the valid
  (read, strand, candidate) lanes by scatter-by-rank -> chunked vote on
  the fine tables' path -> compaction of the accepted lanes into the
  packed result.

Where the JAX step skips vote chunks whose lanes are all padding with
lax.cond, this step reads the valid-lane total to the host once per
batch and votes only the live chunks; the results are the same.

Mesh mode (mesh=parallel.sharding.make_mesh(...), one rank per shard):
each rank maps its data shard's rows against its bucket shard's
occupancy columns and fine tables. The ranks of a bucket group agree on
each read-strand's max hit count (all-reduce MAX) and at-max count
(all-reduce SUM), extract their local at-max buckets and merge the
per-shard lists (all-gather + top-k); each rank then votes the pairs
whose bucket it owns. The per-rank vectors are all-gathered, so every
rank holds the JAX mesh step's concatenated vector and decodes it alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bucketmap_tpu_torch.index.builder import BucketIndex
from bucketmap_tpu_torch.ops.host_encoding import pack_reads
from bucketmap_tpu_torch.device import (MASK32, host_tensor, i64_to_i32,
                                        resolve_device, u32_to_i32,
                                        upload_u32)
from bucketmap_tpu_torch.index.device_build import (build_fine_index_on_device,
                                                    build_occupancy_on_device,
                                                    check_fine_sentinel,
                                                    packed_fine_applies)
from bucketmap_tpu_torch.ops.coarse import CoarseMapper, coarse_tables
from bucketmap_tpu_torch.ops.encoding import unpack_reads
from bucketmap_tpu_torch.ops.vote import (MAX_OCC, FineLocator,
                                          locator_sample_tab, tally)
from bucketmap_tpu_torch.parallel.distributed import global_read_batch
from bucketmap_tpu_torch.utils.debug import no_stage


def shard_geometry(index: BucketIndex, Db: int) -> tuple[int, int, int]:
    """(wr, npf, n_pad_global) of a Db-way bucket split: wr occupancy words
    and npf = 32*wr bucket rows per shard, n_pad_global = npf*Db
    (device_pipeline.py:213-220, with no 1024-word rounding)."""
    wr = -(-index.qgram_words.shape[1] // Db)
    return wr, 32 * wr, 32 * wr * Db


FINE_BUILDS = ("auto", "device", "host")
OCCUPANCY_BUILDS = ("host", "device")
# host arrays past the last bucket, as the JAX mesh pads its shards
# (device_pipeline.py:243-258)
FILLS = {"fine_packed": 0xFFFFFFFF, "fine_ptab": 0, "fine_low": 0xFFFF,
         "fine_pos": -1, "buckets_packed": 0, "bucket_lengths": 0}


def default_fine_max_gb(device) -> float | None:
    """The device fine build's budget: half the card's memory on CUDA
    (the JAX package's 8 GB of a 16 GB v5e, device_pipeline.py:162,
    scaled to the card), none on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory / 2 / 2**30


def builds_fine_on_device(index: BucketIndex, device, fine_build: str = "auto",
                          fine_max_gb: float | None = None,
                          nrows: int | None = None) -> bool:
    """Whether build_tables builds the tiled fine table on the device:
    fine_build "device", or "auto" where the packed encoding applies and
    its 4 bytes per slot of nrows buckets (default all) fit fine_max_gb
    (default: default_fine_max_gb)."""
    k = index.config.query_seed
    lb = index.buckets_packed.shape[1] * 16
    nrows = index.n_buckets if nrows is None else nrows
    budget = default_fine_max_gb(device) if fine_max_gb is None else fine_max_gb
    fits = budget is None or 4 * nrows * lb <= budget * 2**30
    return fine_build == "device" or (fine_build == "auto" and fits
                                      and packed_fine_applies(k, lb))


def host_fine_arrays(index: BucketIndex) -> dict:
    """The fine tables a host-built index carries (None where it has none)
    under tables_from_numpy's names."""
    return {"fine_packed": index.fine_packed, "fine_ptab": index.fine_ptab,
            "fine_low": index.fine_low, "fine_pos": index.fine_pos,
            "buckets_packed": index.buckets_packed,
            "bucket_lengths": index.bucket_lengths,
            "search_steps": index.fine_search_steps,
            "low_bits": index.fine_low_bits}


def _host_rows(a, rows, fill) -> np.ndarray:
    """Rows [r0, r1) of a host table; rows past its end hold `fill`."""
    if rows is None:
        return np.asarray(a)
    r0, r1 = rows
    out = np.full((r1 - r0,) + a.shape[1:], fill, dtype=a.dtype)
    hi = min(r1, a.shape[0])
    if hi > r0:
        out[:hi - r0] = a[r0:hi]
    return out


def fine_tables_from_numpy(arrays: dict, device, rows=None) -> dict:
    """Upload the tables of the first vote path that the host `arrays`
    allow, in the JAX order (ops/vote.py:vote_path): "fine_packed"
    ((N, lpos) as the host build leaves it, or the device build's tiled
    (N, Tp, 128)) with "fine_ptab"; else "fine_ptab", "fine_low" and
    "fine_pos"; else "fine_pos" and "buckets_packed"; else
    "buckets_packed" and "bucket_lengths" for the scan. rows = (r0, r1)
    takes one bucket shard's rows, padded with FILLS. A "buckets_packed"
    given as a device tensor (all rows, int32 words) is used as it is."""
    dev = resolve_device(device)
    have = {k for k, v in arrays.items() if v is not None}
    if "fine_packed" in have:
        names = ("fine_packed", "fine_ptab")
    elif "fine_ptab" in have:
        names = ("fine_ptab", "fine_low", "fine_pos")
    elif "fine_pos" in have:
        names = ("fine_pos", "buckets_packed")
    else:
        names = ("buckets_packed", "bucket_lengths")
    out = {"search_steps": int(arrays.get("search_steps") or 0),
           "low_bits": int(arrays.get("low_bits") or 0)}
    host = {}
    for n in names:
        if isinstance(arrays[n], torch.Tensor):
            if rows is not None:
                raise ValueError(f"a device {n} holds every row; a bucket "
                                 f"shard takes host rows")
            out[n] = arrays[n]
        else:
            host[n] = _host_rows(np.asarray(arrays[n]), rows, FILLS[n])
    fp = host.get("fine_packed")
    if fp is not None and fp.ndim == 3:
        if fp.shape[2] != 128:
            raise ValueError("a tiled fine_packed must be (N, Tp, 128)")
        check_fine_sentinel(fp, host["fine_ptab"])
    for n, a in host.items():
        if n in ("fine_packed", "buckets_packed"):
            out[n] = upload_u32(a, dev)
        else:
            out[n] = host_tensor(a.astype(
                np.int64 if n == "bucket_lengths" else np.int32)).to(dev)
    return out


def build_tables(index: BucketIndex, device, mesh=None,
                 fine_build: str = "auto", fine_max_gb: float | None = None,
                 occupancy_build: str = "host",
                 buckets_packed: torch.Tensor | None = None) -> dict:
    """All device tables of the step. With a mesh, this rank's bucket
    shard: its occupancy columns and its npf fine rows.

    fine_build picks the fine tables (device_pipeline.py:146-184):
    "device" builds the tiled packed table on the device and raises where
    the packed encoding does not apply; "host" uploads the index's host
    tables (ops/vote.py:vote_path), or none, for the scan; "auto" is
    "device" where the encoding applies and its 4 bytes per slot fit
    fine_max_gb (default: default_fine_max_gb), else "host". The JAX
    package also skips the device build on the CPU and under 64 MiB, to
    spare uploads over its remote-TPU link; the port has no such link and
    does not copy those rules.

    occupancy_build: "host" uploads the host table, "device" builds it on
    the device from the packed sequences (single device only).

    buckets_packed: a device copy of index.buckets_packed (int32 words)
    that the scan and sorted votes read instead of uploading their own,
    e.g. the aligner's (single device only)."""
    if fine_build not in FINE_BUILDS:
        raise ValueError(f"fine_build must be one of {FINE_BUILDS}, "
                         f"got {fine_build!r}")
    if occupancy_build not in OCCUPANCY_BUILDS:
        raise ValueError(f"occupancy_build must be one of {OCCUPANCY_BUILDS},"
                         f" got {occupancy_build!r}")
    dev = resolve_device(device)
    n = index.n_buckets
    shard = rows = group = qw = None
    if mesh is not None:
        if occupancy_build == "device":
            raise ValueError("occupancy_build='device' builds a single "
                             "device's table; a mesh uploads its shards")
        wr, npf, _ = shard_geometry(index, mesh.Db)
        shard = (mesh.bi, wr)
        rows = (mesh.bi * npf, (mesh.bi + 1) * npf)
        group = mesh.bucket_group
    if occupancy_build == "device":
        qw = build_occupancy_on_device(index, dev)
        if qw is None:
            raise ValueError("occupancy_build='device' needs index_seed <= 10")
    tables = coarse_tables(index, dev, shard=shard, qgram_words=qw)
    nrows = n if rows is None else rows[1] - rows[0]
    if builds_fine_on_device(index, dev, fine_build, fine_max_gb, nrows):
        built = build_fine_index_on_device(index, dev, rows=rows, group=group)
        if built is None:
            k = index.config.query_seed
            lb = index.buckets_packed.shape[1] * 16
            raise ValueError(
                f"fine_build='device': the packed fine index does not apply "
                f"to query_seed {k} over {lb}-base buckets (needs k <= 15, "
                f"0 <= 2k-12 <= 16 and positions within 32 - (2k-12) bits)")
        fp, pt, steps, low_bits = built
        tables.update(fine_packed=fp, fine_ptab=pt, search_steps=steps,
                      low_bits=low_bits)
    else:
        arrays = host_fine_arrays(index)
        if buckets_packed is not None:
            arrays["buckets_packed"] = buckets_packed
        tables.update(fine_tables_from_numpy(arrays, dev, rows))
    tables["locator_sample_tab"] = locator_sample_tab(index, dev)
    return tables


def tables_from_numpy(arrays: dict, device) -> dict:
    """The step's tables from host arrays, e.g. the ones a JAX DeviceMapper
    holds: "qgram_words" (G1, w) uint32, "kmer_to_row" (4^q,) with
    unsampled q-grams already sent to the sentinel row, "dist_tab" uint8,
    "mapper_sample_tab" and "locator_sample_tab" int32, and the fine
    tables of any vote path as fine_tables_from_numpy takes them, with
    the ints "search_steps" and "low_bits"."""
    dev = resolve_device(device)

    def t(a, dtype):
        return host_tensor(np.asarray(a, dtype)).to(dev)

    tables = fine_tables_from_numpy(arrays, dev)
    tables.update({
        "qgram_words": upload_u32(np.asarray(arrays["qgram_words"]), dev),
        "kmer_to_row": t(arrays["kmer_to_row"], np.int64),
        "dist_tab": t(arrays["dist_tab"], np.uint8),
        "mapper_sample_tab": t(arrays["mapper_sample_tab"], np.int64),
        "locator_sample_tab": t(arrays["locator_sample_tab"], np.int64),
    })
    return tables


class DeviceMapper:
    """The batch step on `device`. With a mesh, this rank's shard of the
    mesh step (module docstring); coarse_path picks the coarse branch
    ("fused" or "staged", ops/coarse.py); fine_build, fine_max_gb,
    occupancy_build and buckets_packed pick how the tables are made
    (build_tables) unless `tables` are given. vote_path names the fine
    tables' vote path ("tiled", "packed", "prefix", "sorted" or "scan").

    `stage(name)` is entered around each sub-stage of a step: "unpack",
    "coarse", "select" (with a mesh, its collectives too), "prepare",
    "compact", per live vote chunk "search" and "tally", and "pack". It
    does nothing by default; a profiler swaps in one that times each
    (experiments/profile_step.py, experiments/profile_mesh.py)."""

    def __init__(self, index: BucketIndex, device, batch_size: int = 8192,
                 pairs_per_read: int = 4, vote_chunk: int = 1024,
                 tables: dict | None = None, mesh=None,
                 coarse_path: str = "fused", fine_build: str = "auto",
                 fine_max_gb: float | None = None,
                 occupancy_build: str = "host",
                 buckets_packed: torch.Tensor | None = None):
        self.device = resolve_device(device)
        self.index = index
        self.cfg = index.config
        self.batch_size = batch_size
        self.vote_chunk = vote_chunk
        self.mesh = mesh
        self.stage = no_stage
        if tables is None:
            tables = build_tables(index, self.device, mesh,
                                  fine_build=fine_build,
                                  fine_max_gb=fine_max_gb,
                                  occupancy_build=occupancy_build,
                                  buckets_packed=buckets_packed)
        self.tables = tables
        self.coarse = CoarseMapper(index, self.device, tables,
                                   coarse_path=coarse_path)
        self.fine = FineLocator(index, self.device, tables)
        self.vote_path = self.fine.path
        if mesh is None:
            self.Dd = self.Db = 1
            self._npf = self._n_pad_global = None
        else:
            self._init_mesh()
        p = batch_size * pairs_per_read // self.Db
        if mesh is not None:
            # the per-shard lane budget: the vote chunk shrinks to it
            self.vote_chunk = min(self.vote_chunk, max(32, p))
        self.lane_budget = -(-p // self.vote_chunk) * self.vote_chunk
        if mesh is not None and \
                self.lane_budget < 2 * self.cfg.max_candidate_buckets:
            # a single row must fit one shard's budget (the split retry
            # stops at one row)
            raise ValueError(f"lane budget {self.lane_budget} is below "
                             f"one read's candidates")
        rows = batch_size // self.Dd
        self.out_cap = self._pick_out_cap(rows)
        self._init_pack_bits(rows)

    def _init_mesh(self):
        """Shard geometry (device_pipeline.py:_init_mesh): Dd data shards of
        batch_size/Dd rows, Db bucket shards of npf = 32*wr buckets."""
        self.Dd, self.Db = self.mesh.Dd, self.mesh.Db
        if self.batch_size % self.Dd:
            raise ValueError(f"batch_size {self.batch_size} does not split "
                             f"over {self.Dd} data shards")
        _, self._npf, self._n_pad_global = shard_geometry(self.index, self.Db)

    def _init_pack_bits(self, rows: int):
        """Bit layout of a packed accepted lane (2 uint32 words):
          w0 = lane | votes << la | bucket_hi << (la + 8)
          w1 = offset | bucket_lo << ob
        lane < rows*2*C (la bits), votes clipped to 8 bits, offset < the
        packed bucket row length (ob bits), the bucket split around the
        32-ob boundary; a mesh counts its padded buckets."""
        C = self.cfg.max_candidate_buckets
        nl = max(2, rows * 2 * C)
        self._lane_bits = (nl - 1).bit_length()
        lb = self.index.buckets_packed.shape[1] * 16
        self._off_bits = max(1, int(lb).bit_length())
        nb = max(2, self._n_pad_global or self.index.n_buckets)
        bucket_bits = (nb - 1).bit_length()
        bhi_bits = max(0, bucket_bits - (32 - self._off_bits))
        assert self._lane_bits + 8 + bhi_bits <= 32, \
            (self._lane_bits, self._off_bits, bucket_bits)

    def _pick_out_cap(self, rows: int) -> int:
        """Accepted-lane budget per (shard-local) batch: ~1 location per
        read on real genomes, so 2x rows; overflow re-dispatches the batch
        split."""
        cap = min(self.lane_budget, max(4 * self.cfg.max_candidate_buckets,
                                        -(-2 * rows // 128) * 128))
        # votes are clipped to 8 bits in the packed lane (_init_pack_bits)
        assert self.cfg.locator_samples * MAX_OCC <= 255
        return cap

    # ------------------------------------------------------------------
    def _lanes(self, cand, own, codes, qual_ok, lengths, col0: int = 0,
               nown: int | None = None) -> dict:
        """Locator sampling and compaction of the owned (read, strand,
        candidate) lanes into the lane budget by scatter-by-rank (owned
        lanes first, in lane order; slot P is the drop slot, and slots
        past the owned count read lane 0). The vote's bucket is the
        candidate's row in this shard's tables, [col0, col0 + nown)."""
        C = self.cfg.max_candidate_buckets
        P = self.lane_budget
        dev = self.device
        with self.stage("prepare"):
            samp_hash, samp_idx = self.fine.prepare(codes, qual_ok, lengths)
        with self.stage("compact"):
            flat = cand.reshape(-1)
            lane = torch.arange(flat.shape[0], dtype=torch.int64, device=dev)
            rank = torch.cumsum(own.reshape(-1).to(torch.int64), dim=0)
            dst = torch.where(own.reshape(-1) & (rank - 1 < P), rank - 1, P)
            sel = torch.zeros(P + 1, dtype=torch.int64, device=dev)
            sel = sel.scatter(0, dst, lane)[:P]
            bucket = flat[sel].clamp(min=0).to(torch.int64)
            vote_bucket = bucket if nown is None else \
                (bucket - col0).clamp(0, nown - 1)
            n_valid = int(rank[-1])       # the step's one host sync
        return {
            "sel": sel, "n_valid": n_valid,
            "lane_read": sel // (2 * C), "lane_rc": ((sel // C) % 2).bool(),
            "lane_bucket": bucket, "vote_bucket": vote_bucket,
            "samp_hash": samp_hash, "samp_idx": samp_idx, "lengths": lengths,
        }

    def compact_lanes(self, packed: torch.Tensor) -> dict:
        """Single device: coarse query, then every valid lane is owned.
        The lanes of _lanes plus the per-read candidate counts."""
        cfg = self.cfg
        with self.stage("unpack"):
            codes, qual_ok, lengths = unpack_reads(packed, cfg.read_len,
                                                   cfg.query_seed)
        with self.stage("coarse"):
            cm, cc, planes, _, give_up = self.coarse.score(
                codes, qual_ok, lengths, self.coarse.n_buckets)
        with self.stage("select"):
            cand, counts = self.coarse.select(cm, cc, planes, give_up)
        del cm, cc, planes
        lanes = self._lanes(cand, cand >= 0, codes, qual_ok, lengths)
        lanes["counts"] = counts
        return lanes

    def sharded_lanes(self, packed: torch.Tensor) -> dict:
        """Mesh: local scoring over this rank's bucket columns, the global
        candidate policy through the bucket group's collectives (max and
        at-max count of each read-strand, merge of the per-shard at-max
        lists by top-k of n_pad - bucket), then the lanes of the pairs
        whose bucket this rank owns (_sharded_step_impl)."""
        cfg = self.cfg
        C = cfg.max_candidate_buckets
        mesh = self.mesh
        group = mesh.bucket_group
        n = self.coarse.n_buckets
        npf, n_pad = self._npf, self._n_pad_global
        col0 = mesh.bi * npf
        with self.stage("unpack"):
            codes, qual_ok, lengths = unpack_reads(packed, cfg.read_len,
                                                   cfg.query_seed)
        with self.stage("coarse"):
            cm, cc, planes, _, give_up = self.coarse.score(
                codes, qual_ok, lengths, min(max(n - col0, 0), npf))
        with self.stage("select"):
            gmax = cm.amax(dim=2).contiguous()                      # (B, 2)
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
            ok = (gmax >= cfg.min_coarse_hits) & ~give_up[:, None]
            gcnt = torch.where((cm == gmax[:, :, None]) & ok[..., None], cc,
                               0).sum(dim=2)
            dist.all_reduce(gcnt, op=dist.ReduceOp.SUM, group=group)
            over = gcnt > C                                        # clear
            counts = torch.where(over, 0, gcnt).to(torch.int32)
            cand_l = self.coarse.extract_at_max(planes, gmax, ok & ~over, n,
                                                col0)
            del cm, cc, planes
            vals = torch.where(cand_l >= 0, n_pad - cand_l, 0).contiguous()
            parts = [torch.empty_like(vals) for _ in range(mesh.Db)]
            dist.all_gather(parts, vals, group=group)
            # distinct values but the zeros: top-k order is lax.top_k's
            gvals = torch.topk(torch.cat(parts, dim=-1), C, dim=-1).values
            cand = torch.where(gvals > 0, n_pad - gvals, -1).to(torch.int32)
        lanes = self._lanes(cand, (cand >= col0) & (cand < col0 + npf), codes,
                            qual_ok, lengths, col0, npf)
        lanes["counts"] = counts
        return lanes

    def chunk_lanes(self, lanes: dict, ci: int):
        """FineLocator.search_lanes arguments of vote chunk ci: the chunk's
        lane slices and the step's samples."""
        ch = self.vote_chunk
        sl = slice(ci * ch, (ci + 1) * ch)
        return (lanes["vote_bucket"][sl], lanes["lane_rc"][sl],
                lanes["lane_read"][sl], lanes["samp_hash"],
                lanes["samp_idx"], lanes["lengths"])

    def chunk_args(self, lanes: dict, ci: int):
        """FineLocator.vote arguments of vote chunk ci: each lane's
        samples gathered."""
        bucket, rc, rd, samp_hash, samp_idx, lengths = \
            self.chunk_lanes(lanes, ci)
        return bucket, rc, samp_hash[rd], samp_idx[rd], lengths[rd]

    def _vote_and_pack(self, lanes: dict, total_valid: int,
                       di: int = 0) -> torch.Tensor:
        """Vote the live chunks (first lane below the owned count; dead
        chunks read zeros, as the JAX step's cond does) and pack."""
        P = self.lane_budget
        ch = self.vote_chunk
        dev = self.device
        nv = lanes["n_valid"]
        off = torch.zeros(P, dtype=torch.int32, device=dev)
        votes = torch.zeros(P, dtype=torch.int32, device=dev)
        acc = torch.zeros(P, dtype=torch.int32, device=dev)
        for ci in range(min(P // ch, -(-nv // ch))):
            sl = slice(ci * ch, (ci + 1) * ch)
            with self.stage("search"):
                targs = self.fine.search_lanes(*self.chunk_lanes(lanes, ci))
            with self.stage("tally"):
                off[sl], votes[sl], acc[sl] = tally(*targs)
        with self.stage("pack"):
            acc = acc.bool() & (torch.arange(P, device=dev) < nv)
            return self._pack_result(acc, lanes["sel"], lanes["lane_bucket"],
                                     off, votes, total_valid, nv,
                                     lanes["counts"], di)

    def step_packed(self, packed: torch.Tensor) -> torch.Tensor:
        """packed: (B, cw+qw+1) packed reads on the device, with a mesh this
        rank's B/Dd rows. Returns the packed int32 result vector (see
        _pack_result); with a mesh, every rank's vector in (data, bucket)
        order, on every rank."""
        if self.mesh is None:
            lanes = self.compact_lanes(packed)
            return self._vote_and_pack(lanes, lanes["n_valid"])
        vec = self.sharded_step_packed(packed)
        parts = [torch.empty_like(vec) for _ in range(self.Dd * self.Db)]
        dist.all_gather(parts, vec, group=self.mesh.world_group)
        return torch.cat(parts)

    def sharded_step_packed(self, packed: torch.Tensor) -> torch.Tensor:
        """This rank's result vector of the mesh step; total_valid is the
        owned-lane sum over the world. Every rank makes the same
        collectives in the same order, none inside the vote loop."""
        lanes = self.sharded_lanes(packed)
        total = torch.tensor(lanes["n_valid"], dtype=torch.int64,
                             device=self.device)
        dist.all_reduce(total, op=dist.ReduceOp.SUM,
                        group=self.mesh.world_group)
        return self._vote_and_pack(lanes, int(total), self.mesh.di)

    def _pack_result(self, acc, sel, bucket, off, votes, total_valid: int,
                     local_valid: int, counts, di: int = 0) -> torch.Tensor:
        """One int32 vector, the inverse of decode_out:
          [0]=n_accept [1]=total_valid [2]=local_valid [3]=out_cap
          [4]=data-shard index [5:8]=0
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
        hdr = torch.tensor([total_valid, local_valid, OC, di, 0, 0, 0],
                           dtype=torch.int32, device=dev)
        return torch.cat([arank[-1:].to(torch.int32), hdr, cw, out2])

    def decode_out(self, vec) -> dict:
        """Host-side inverse of _pack_result over the Dd*Db vectors of a
        step, concatenated in (data, bucket) order (one for a single
        device): accepted lanes (lane_read as a row of the whole batch,
        lane_rc, lane_bucket, offset, votes), counts (B, 2), total_valid,
        and local_valid and n_accept per shard."""
        if isinstance(vec, torch.Tensor):
            vec = vec.cpu().numpy()
        vec = np.ascontiguousarray(vec, dtype=np.int32)
        B = self.batch_size
        Dd, Db = self.Dd, self.Db
        Bl = B // Dd
        C = self.cfg.max_candidate_buckets
        la, ob = self._lane_bits, self._off_bits
        vl = 8 + Bl + 2 * self.out_cap
        assert vec.shape[0] == Dd * Db * vl, (vec.shape, Dd, Db, vl)
        counts = np.zeros((B, 2), np.int32)
        cols = {k: [] for k in ("lane_read", "lane_rc", "lane_bucket",
                                "offset", "votes")}
        n_accept = np.zeros(Dd * Db, np.int32)
        local_valid = np.zeros(Dd * Db, np.int32)
        total_valid = 0
        for d in range(Dd * Db):
            v = vec[d * vl:(d + 1) * vl]
            di, bi = divmod(d, Db)
            na, total_valid, lv = int(v[0]), int(v[1]), int(v[2])
            n_accept[d], local_valid[d] = na, lv
            if bi == 0:  # counts are the same on every bucket shard
                cw = v[8: 8 + Bl].view(np.uint32)
                counts[di * Bl:(di + 1) * Bl, 0] = cw >> 16
                counts[di * Bl:(di + 1) * Bl, 1] = cw & 0xFFFF
            out2 = v[8 + Bl:].view(np.uint32).reshape(self.out_cap, 2)
            out2 = out2[: min(na, self.out_cap)]
            w0, w1 = out2[:, 0], out2[:, 1]
            lane = (w0 & np.uint32((1 << la) - 1)).astype(np.int64)
            cols["lane_read"].append(di * Bl + lane // (2 * C))
            cols["lane_rc"].append((lane // C) % 2 == 1)
            cols["lane_bucket"].append(
                (w1 >> np.uint32(ob)).astype(np.int64)
                | ((w0 >> np.uint32(la + 8)).astype(np.int64) << (32 - ob)))
            cols["offset"].append((w1 & np.uint32((1 << ob) - 1))
                                  .astype(np.int64))
            cols["votes"].append(((w0 >> np.uint32(la)) & np.uint32(0xFF))
                                 .astype(np.int64))
        out = {k: np.concatenate(v) for k, v in cols.items()}
        out.update(counts=counts, total_valid=total_valid,
                   local_valid=local_valid, n_accept=n_accept)
        return out

    # ------------------------------------------------------------------
    def pack(self, codes: np.ndarray, quals: np.ndarray,
             lengths: np.ndarray) -> torch.Tensor:
        """Host batch -> packed reads on the device (encoding.pack_reads
        layout; the native C packing when available, else numpy)."""
        from bucketmap_tpu_torch.io import native
        packed = native.pack_reads(codes, quals, np.asarray(lengths),
                                   self.cfg.query_seed,
                                   self.cfg.mapper_min_kmer_quality)
        if packed is None:
            packed = pack_reads(codes, quals, np.asarray(lengths),
                                self.cfg.query_seed,
                                self.cfg.mapper_min_kmer_quality)
        return host_tensor(u32_to_i32(packed)).to(self.device)

    def step(self, codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray):
        """Pack and upload a host batch (with a mesh, this rank's rows of
        it) and run the step; returns the device result vector."""
        if self.mesh is not None:
            codes, quals, lengths = global_read_batch(self.mesh, codes, quals,
                                                      lengths)
        return self.step_packed(self.pack(codes, quals, lengths))
