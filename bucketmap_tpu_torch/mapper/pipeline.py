"""End-to-end mapping on torch: FASTQ -> device step -> [align] -> SAM.

Counterpart of `bucketmap_tpu/mapper/pipeline.py:BucketMapPipeline`.
Reads are cut into read_len segments (long reads into
num_segment_samples windows), mapped in fixed-size batches through the
device step and decoded on the host. Align-free, the locations are
merged per read (filter_best_locations semantics); in align mode every
location goes through the banded aligner, which gives the CIGAR and the
MAPQ. Records are written as SAM through the port's SamWriter and native
formatter, so the bytes match the reference's.

With a mesh (parallel.sharding.make_mesh), every rank parses the same
reads and runs the same batches through the mesh step; the result
vectors are all-gathered, so every rank decodes the same locations and
takes the same split-retry decisions. Only rank 0 aligns (with its own
copy of the genome) and writes the SAM.
"""

from __future__ import annotations

import bisect
import dataclasses
import queue
import threading
import time

import numpy as np

from bucketmap_tpu_torch.index.builder import BucketIndex
from bucketmap_tpu_torch.io.fastq import ReadBatch, iter_fastq_batches
from bucketmap_tpu_torch.io.sam import SamWriter
from bucketmap_tpu_torch.ops.sampler import sample_deterministic
from bucketmap_tpu_torch.device import resolve_device
from bucketmap_tpu_torch.mapper.device_pipeline import (DeviceMapper,
                                                       builds_fine_on_device,
                                                       no_stage)
from bucketmap_tpu_torch.ops.align import BandedAligner


@dataclasses.dataclass
class Location:
    bucket: int
    offset: int          # read start within the bucket
    seg_offset: int
    votes: int
    is_orig: bool


def filter_best_locations(locs: list[Location], read_length: int,
                          indel_rate: float) -> list[Location]:
    """_filter_best_locations (bucket_locator.h:350-405): merge votes onto
    every earlier location with the same (bucket, strand) within
    +-read_len*indel_rate, in sorted key order, then keep every location
    with the max total votes."""
    loc_votes: dict[tuple[int, int, bool], int] = {}
    keys: list[tuple[int, int, bool]] = []   # kept sorted
    for loc in locs:
        key = (loc.bucket, loc.offset, loc.is_orig)
        if not loc_votes:
            loc_votes[key] = loc.votes
            keys.append(key)
        else:
            lo = int(loc.offset - read_length * indel_rate)
            hi = int(loc.offset + read_length * indel_rate)
            a = bisect.bisect_left(keys, (loc.bucket, lo, False))
            b = bisect.bisect_right(keys, (loc.bucket, hi, True))
            found = False
            for k in keys[a:b]:
                if lo <= k[1] <= hi and k[2] == loc.is_orig:
                    loc_votes[k] += loc.votes
                    found = True
            if not found:
                if key in loc_votes:
                    loc_votes[key] += loc.votes
                else:
                    loc_votes[key] = loc.votes
                    bisect.insort(keys, key)
    best: list[Location] = []
    max_votes = 0
    for k in keys:
        v = loc_votes[k]
        if v > max_votes:
            best, max_votes = [], v
        if v == max_votes:
            best.append(Location(k[0], k[1], 0, v, k[2]))
    return best


def default_pair_batch(index: BucketIndex, device, batch_size: int,
                       align: bool = False, fine_build: str = "auto") -> int:
    """bench.py's pair batch (the DP sub-batch, and the vote chunk's cap):
    16384 pairs in align mode, the batch otherwise, and 1024 where the
    vote takes the table-free scan path, whose (vote chunk, bucket_len)
    intermediates it bounds: where no fine table is built on the device
    (device_pipeline.builds_fine_on_device) and the index holds none."""
    scan = not builds_fine_on_device(index, device, fine_build) and all(
        getattr(index, n) is None
        for n in ("fine_packed", "fine_ptab", "fine_pos"))
    return 1024 if scan else 16384 if align else batch_size


class _WriterThread:
    """A named thread that does one batch's jobs in order, fed through a
    4-deep queue: the align-free SAM writer and the align-emit thread.
    Used as a context manager around one batch. Each put is one
    "handoff" span on the caller, and the batch's end (the sentinel and
    the join) one "drain". After a failed job the thread takes the rest
    up to the sentinel and drops them, so a put never blocks; the next
    put, or the batch's end, re-raises the failure on the caller."""

    def __init__(self, name: str, work, stage):
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._work = work
        self._stage = stage
        self._failure: BaseException | None = None
        self._thr = threading.Thread(target=self._loop, name=name)

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            if self._failure is None:
                try:
                    self._work(job)
                except BaseException as e:  # re-raised on the caller
                    self._failure = e

    def put(self, job) -> None:
        if self._failure is not None:
            raise self._failure
        with self._stage("handoff"):
            self._q.put(job)

    def __enter__(self) -> "_WriterThread":
        self._thr.start()
        return self

    def __exit__(self, exc_type, *_):
        with self._stage("drain"):
            self._q.put(None)
            self._thr.join()
        # where the caller raised, its own error goes on
        if exc_type is None and self._failure is not None:
            raise self._failure


@dataclasses.dataclass
class MapStats:
    num_reads: int = 0
    num_bases: int = 0
    reads_with_candidates: int = 0
    candidate_pairs: int = 0
    mapped_locations: int = 0
    # host seconds of segmenting the batches (the "segment" stage)
    segment_seconds: float = 0.0
    # host seconds of the dispatch cycles: step, download, decode, extract
    cycle_seconds: float = 0.0
    # the main thread's CPU seconds inside the "dispatch" stage (a CUDA
    # call that spins while it waits for the device counts as CPU); the
    # rest of that stage's wall time is spent off the CPU, waiting for the
    # interpreter lock or blocked in a CUDA call
    dispatch_cpu_seconds: float = 0.0
    # align-free, the SAM writer thread's seconds (merge, format and
    # write); in align mode, the main thread's align stage
    output_seconds: float = 0.0
    # align mode: located pairs aligned, records dropped under the
    # quality threshold, and records whose score is below -60 (MAPQ
    # wrapped, CIGAR '*', never dropped)
    aligned_pairs: int = 0
    records_below_quality: int = 0
    records_wrapped: int = 0
    # device steps dispatched; of them, single-device steps whose valid
    # lanes exceeded the lane budget, so that they voted past it
    # (decode_out's "grown"), and steps run by the split retry of an
    # overflowing batch (_locate_split)
    steps: int = 0
    grown_steps: int = 0
    split_steps: int = 0
    # FASTQ chunks the reader parsed (map_fastq), and of them those the
    # host library parsed (the rest, numpy's fallback)
    parse_chunks: int = 0
    parse_native_chunks: int = 0


class BucketMapPipeline:
    """fine_build and fine_max_gb pick the step's fine tables
    (mapper/device_pipeline.py:build_tables). `stage(name)` is entered
    once per batch or dispatch chunk, never per read, in each of the
    three host threads; it does nothing by default
    (experiments/profile_driver.py and the benchmark's traced run time
    each). On the thread that calls map_fastq: "wait_reads" (the wait
    for the FASTQ reader's next ReadBatch, or for the stream's end),
    "segment" (a batch's segments, their sort and the dispatch bounds),
    then per dispatch cycle "dispatch" (pack, upload and the step),
    "download" (the device-to-host copy, which waits for the step),
    "decode", "extract" (the split retry of an overflowing batch, with
    its own dispatches, included) and "handoff" (the location chunk put
    on the SAM writer's queue), and once a batch "drain" (the wait for
    the SAM writer to finish it). In align mode the batch's aligned emit
    is "align" instead, once a batch, around the DP sub-batches (the
    aligner's own stages), and inside it "handoff" (each sub-batch's
    records put on the align-emit thread's queue) and "drain" (the wait
    for that thread to finish the batch). On the FASTQ reader thread
    "parse" (a chunk's parse_fastq); on the SAM writer thread "merge"
    (the align-free merge into sorted record arrays) and "sam_write"
    (writing the formatted records; the align-emit thread's writes
    too)."""

    def __init__(self, index: BucketIndex, *, device, align: bool = False,
                 batch_size: int = 512, pair_batch: int = 256,
                 pairs_per_read: int = 4, mesh=None,
                 coarse_path: str = "fused", fine_build: str = "auto",
                 fine_max_gb: float | None = None):
        self.index = index
        self.cfg = index.config
        self.align = align
        self.batch_size = batch_size
        dev = resolve_device(device)
        # rank 0 of a mesh writes the SAM; the other ranks only map
        self.emits = mesh is None or mesh.rank == 0
        self.aligner = (BandedAligner(index, dev, pair_batch=pair_batch)
                        if align and self.emits else None)
        # the scan and sorted votes read the packed genome too: one device
        # copy serves both (pipeline.py:126-133), the fine stage reading
        # the aligner's zero-padded rows unpadded. A mesh's fine copy
        # holds one bucket shard, so the aligner keeps its own there.
        genome = (self.aligner.buckets_packed[:, :self.aligner.words]
                  if self.aligner is not None and mesh is None else None)
        self.device = DeviceMapper(index, dev, batch_size=batch_size,
                                   pairs_per_read=pairs_per_read,
                                   vote_chunk=min(4096, pair_batch, batch_size),
                                   mesh=mesh, coarse_path=coarse_path,
                                   fine_build=fine_build,
                                   fine_max_gb=fine_max_gb,
                                   buckets_packed=genome)
        self._bucket_sam_offset = index.ref_offset_of_bucket()
        # the native formatter's reference names, cut at the first space
        ref_short = [n.split(" ")[0].encode() for n in index.ref_names]
        self._rname_offsets = np.zeros(len(ref_short) + 1, np.int64)
        np.cumsum([len(x) for x in ref_short], out=self._rname_offsets[1:])
        self._rnames = np.frombuffer(b"".join(ref_short), np.uint8)
        self.stage = no_stage

    # ------------------------------------------------------------------
    def _all_segments(self, batch: ReadBatch):
        """Fixed-shape segments of all reads: codes/quals (S, read_len),
        seg_len, seg_read, seg_off. Reads up to 2*read_len are queried on
        their first read_len bases; longer reads expand to
        num_segment_samples windows (q_gram_mapper.h:510-516)."""
        cfg = self.cfg
        rl = cfg.read_len
        lengths = batch.lengths
        n = batch.num_reads
        long_mask = lengths > 2 * rl

        if not long_mask.any():
            seg_read = np.arange(n, dtype=np.int32)
            seg_off = np.zeros(n, dtype=np.int32)
            seg_len = np.minimum(lengths, rl).astype(np.int32)
            if batch.codes.shape[1] == rl:
                codes, quals = batch.codes, batch.quals
            else:
                width = min(batch.codes.shape[1], rl)
                codes = np.zeros((n, rl), np.uint8)
                quals = np.zeros((n, rl), np.uint8)
                codes[:, :width] = batch.codes[:, :width]
                quals[:, :width] = batch.quals[:, :width]
            return codes, quals, seg_len, seg_read, seg_off

        short_idx = np.nonzero(~long_mask)[0]
        rows = [short_idx]
        offs = [np.zeros(len(short_idx), np.int64)]
        for r in np.nonzero(long_mask)[0]:
            starts = sample_deterministic(cfg.num_segment_samples,
                                          int(lengths[r]) - rl - 1)
            rows.append(np.full(len(starts), r, np.int64))
            offs.append(starts.astype(np.int64))
        seg_read = np.concatenate(rows)
        seg_off = np.concatenate(offs)

        seg_len = np.minimum(lengths[seg_read] - seg_off, rl).astype(np.int32)
        col = np.arange(rl)
        src = seg_off[:, None] + col[None, :]
        mask = col[None, :] < seg_len[:, None]
        src = np.where(mask, src, 0)
        codes = np.where(mask, batch.codes[seg_read[:, None], src], 0).astype(np.uint8)
        quals = np.where(mask, batch.quals[seg_read[:, None], src], 0).astype(np.uint8)
        return (codes, quals, seg_len, seg_read.astype(np.int32),
                seg_off.astype(np.int32))

    # ------------------------------------------------------------------
    def locate_chunks(self, batch: ReadBatch, stats: MapStats):
        """Generator of per-dispatch location chunks, each the complete
        location set of a contiguous read range (dispatch bounds never
        split a read's segments): (read, bucket, offset, votes, is_orig,
        seg_offset) sorted by (read, bucket, original strand first)."""
        cfg = self.cfg
        n = batch.num_reads
        t0 = time.perf_counter()
        with self.stage("segment"):
            codes, quals, seg_len, seg_read, seg_off = self._all_segments(
                batch)
            if not np.all(seg_read[:-1] <= seg_read[1:]):
                order = np.argsort(seg_read, kind="stable")
                codes, quals = codes[order], quals[order]
                seg_len, seg_read, seg_off = (seg_len[order], seg_read[order],
                                              seg_off[order])
            S = len(seg_read)
            bs = self.batch_size
            assert bs >= cfg.num_segment_samples
            bounds = []
            s = 0
            while s < S:
                e = min(s + bs, S)
                if e < S and seg_read[e] == seg_read[e - 1]:
                    e_adj = int(np.searchsorted(seg_read, seg_read[e], "left"))
                    if e_adj > s:
                        e = e_adj
                bounds.append((s, e))
                s = e
        stats.segment_seconds += time.perf_counter() - t0

        reads_with_cand = np.zeros(n, dtype=bool)
        for s, e in bounds:
            t0 = time.perf_counter()
            host = self._run(stats, codes, quals, seg_len, s, e)
            stats.cycle_seconds += time.perf_counter() - t0
            t0 = time.perf_counter()
            with self.stage("extract"):
                stats.candidate_pairs += int(host["total_valid"])
                counts = host["counts"][: e - s]
                reads_with_cand[seg_read[s + np.nonzero(
                    counts.sum(axis=1) > 0)[0]]] = True
                if host["overflow"]:
                    # lane/output budget overflow (repetitive genomes): redo
                    # the batch split in half; the per-read budget doubles
                    chunks = self._locate_split(stats, batch, seg_read,
                                                seg_off, seg_len, codes,
                                                quals, s, e)
                else:
                    chunks = [self._extract_chunk(host, s, e, batch, seg_read,
                                                  seg_off, seg_len)]
                r = np.concatenate([c[0] for c in chunks]).astype(np.int64)
                bk = np.concatenate([c[1] for c in chunks])
                off = np.concatenate([c[2] for c in chunks])
                votes = np.concatenate([c[3] for c in chunks]).astype(np.int64)
                orig = np.concatenate([c[4] for c in chunks])
                so = np.concatenate([c[5] for c in chunks]).astype(np.int64)
                order = np.lexsort((~orig, bk, r))
            stats.cycle_seconds += time.perf_counter() - t0
            yield (r[order], bk[order], off[order], votes[order],
                   orig[order], so[order])
        stats.reads_with_candidates += int(reads_with_cand.sum())
        stats.num_reads += n
        stats.num_bases += int(batch.lengths.sum())

    def locate_arrays(self, batch: ReadBatch, stats: MapStats | None = None):
        """Map every read: ((read, bucket, read_offset, votes, is_orig,
        seg_offset) arrays sorted by (read, bucket, original strand
        first), stats) (pipeline.py:316-328)."""
        stats = stats if stats is not None else MapStats()
        chunks = list(self.locate_chunks(batch, stats))
        if chunks:
            out = tuple(np.concatenate([c[i] for c in chunks])
                        for i in range(6))
        else:
            z = np.zeros(0, np.int64)
            out = (z, z, z, z, np.zeros(0, bool), z)
        return out, stats

    def locate_batch(self, batch: ReadBatch, stats: MapStats | None = None):
        """locate_arrays as a list of Locations per read
        (pipeline.py:330-337)."""
        (r, bk, off, votes, orig, so), stats = self.locate_arrays(batch, stats)
        per_read: list[list[Location]] = [[] for _ in range(batch.num_reads)]
        for i in range(len(r)):
            per_read[r[i]].append(Location(int(bk[i]), int(off[i]), int(so[i]),
                                           int(votes[i]), bool(orig[i])))
        return per_read, stats

    def _run(self, stats, codes, quals, seg_len, s, e) -> dict:
        """Pad segment rows [s, e) to the batch size, run the step and
        decode its result on the host."""
        bs = self.batch_size
        pad = bs - (e - s)
        c, q, sl = codes[s:e], quals[s:e], seg_len[s:e]
        if pad:
            c = np.pad(c, ((0, pad), (0, 0)))
            q = np.pad(q, ((0, pad), (0, 0)))
            sl = np.pad(sl, (0, pad))
        with self.stage("dispatch"):
            cpu0 = time.thread_time_ns()
            vec = self.device.step(c, q, sl)
            stats.dispatch_cpu_seconds += (time.thread_time_ns() - cpu0) / 1e9
        with self.stage("download"):
            vec = vec.cpu().numpy()
        with self.stage("decode"):
            host = self.device.decode_out(vec)
        stats.steps += 1
        stats.grown_steps += int(host["grown"])
        return host

    def _extract_chunk(self, host, s, e, batch, seg_read, seg_off, seg_len):
        """Accepted lanes of one decoded step -> location arrays in read
        coordinates (fold-back, bucket_locator.h:671-693)."""
        srow = s + host["lane_read"]
        keep = srow < e  # drop padded segment rows
        srow = srow[keep]
        r = seg_read[srow]
        so = seg_off[srow]
        sl = seg_len[srow]
        x = host["offset"][keep]
        rc = host["lane_rc"][keep]
        read_off = np.where(rc, x - (batch.lengths[r] - so - sl), x - so)
        return (r, host["lane_bucket"][keep].astype(np.int64),
                read_off.astype(np.int64), host["votes"][keep], ~rc, so)

    def _locate_split(self, stats, batch, seg_read, seg_off, seg_len, codes,
                      quals, s, e):
        """Overflow fallback, where a step's budgets are fixed (a mesh, or
        accepted lanes past out_cap on one device): re-run [s, e) as two
        halves (a single row can never overflow: lane_budget >= 2 *
        max_candidate_buckets)."""
        mid = (s + e) // 2
        parts = ((s, mid), (mid, e)) if e - s > 1 else ((s, e),)
        chunks = []
        for a, b in parts:
            if a == b:
                continue
            host = self._run(stats, codes, quals, seg_len, a, b)
            stats.split_steps += 1
            if host["overflow"] and b - a > 1:
                chunks.extend(self._locate_split(stats, batch, seg_read,
                                                 seg_off, seg_len, codes,
                                                 quals, a, b))
            else:
                chunks.append(self._extract_chunk(host, a, b, batch, seg_read,
                                                  seg_off, seg_len))
        return chunks

    # ------------------------------------------------------------------
    def map_fastq(self, fastq_path, sam_path,
                  quality_threshold: int | None = None,
                  reads_per_chunk: int = 1 << 17) -> MapStats:
        """Streamed file mapping: a reader thread parses the next chunk of
        reads_per_chunk reads while the current one maps. In align mode
        records below quality_threshold (default cfg.quality_threshold)
        are dropped."""
        qt = self._threshold(quality_threshold)
        stats = MapStats()
        writer = self._writer(sam_path)
        q: queue.Queue = queue.Queue(maxsize=1)
        rerr: list[BaseException] = []
        stop = threading.Event()

        def _reader():
            try:
                for b in iter_fastq_batches(fastq_path,
                                            reads_per_batch=reads_per_chunk,
                                            stage=self.stage, stats=stats):
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised on the main thread
                rerr.append(e)
            finally:
                stop.set()

        def _next_batch() -> ReadBatch | None:
            """The reader's next ReadBatch, or None at the stream's end."""
            while True:
                try:
                    return q.get(timeout=0.25)
                except queue.Empty:
                    if stop.is_set() and q.empty():
                        return None

        thr = threading.Thread(target=_reader, name="bmtorch-fastq-reader")
        thr.start()
        try:
            while True:
                with self.stage("wait_reads"):
                    batch = _next_batch()
                if batch is None:
                    break
                self._map_batch(writer, batch, qt, stats)
                del batch
        finally:
            stop.set()
            thr.join()
            if writer is not None:
                writer.close()
        if rerr:
            raise rerr[0]
        return stats

    def map_reads(self, batch: ReadBatch, sam_path,
                  quality_threshold: int | None = None) -> MapStats:
        """Map one in-memory ReadBatch."""
        qt = self._threshold(quality_threshold)
        stats = MapStats()
        writer = self._writer(sam_path)
        try:
            self._map_batch(writer, batch, qt, stats)
        finally:
            if writer is not None:
                writer.close()
        return stats

    def _writer(self, sam_path) -> SamWriter | None:
        if not self.emits:
            return None
        return SamWriter(sam_path, list(self.index.ref_names),
                         self.index.sam_ref_lengths())

    def _threshold(self, quality_threshold: int | None) -> int:
        return (self.cfg.quality_threshold if quality_threshold is None
                else quality_threshold)

    def _map_batch(self, writer, batch: ReadBatch, qt, stats) -> None:
        """Locate, merge and write one ReadBatch; a writer thread merges
        and formats earlier chunks while the device maps the next. Align
        mode locates the whole batch first and then aligns all its
        locations in sub-batches. A mesh rank other than 0 maps the batch
        and writes nothing."""
        if not self.emits:
            for _ in self.locate_chunks(batch, stats):
                pass
            return
        if self.align:
            chunk, _ = self.locate_arrays(batch, stats)
            t0 = time.perf_counter()
            self._align_emit(writer, batch, chunk, qt, stats)
            stats.output_seconds += time.perf_counter() - t0
            return

        def merge_emit(chunk):
            t0 = time.perf_counter()
            self._merge_emit(writer, batch, chunk, stats)
            stats.output_seconds += time.perf_counter() - t0

        with _WriterThread("bmtorch-sam-writer", merge_emit,
                           self.stage) as out:
            for chunk in self.locate_chunks(batch, stats):
                out.put(chunk)

    def _align_emit(self, writer, batch, chunk, qt, stats):
        """Align every location of a batch and write the records: long
        reads (> 2*read_len) segment by segment, the others whole."""
        lr, lbk, loff, _, lorig, lso = chunk
        with self.stage("align"):
            long_mask = batch.lengths[lr] > 2 * self.cfg.read_len
            if long_mask.any():
                self._align_long_emit(
                    writer, batch, lr[long_mask], lbk[long_mask],
                    loff[long_mask], lorig[long_mask], lso[long_mask],
                    qt, stats)
            if not long_mask.all():
                sm = ~long_mask
                self._align_stream_emit(writer, batch, lr[sm], lbk[sm],
                                        loff[sm], lorig[sm], qt, stats)

    def _merge_emit(self, writer, batch, chunk, stats):
        """Merge and write the records of one location chunk (align-free):
        reads with one location pass through, 2-location reads take the
        vectorized form of the merge, longer runs the literal
        filter_best_locations."""
        lr, lbk, loff, lvotes, lorig, _ = chunk
        with self.stage("merge"):
            rec_read, rec_bucket, rec_off, rec_votes, rec_orig = \
                self._merge(batch, lr, lbk, loff, lvotes, lorig)
        rec_flag = np.where(rec_orig, 0, 16).astype(np.int32)
        rec_pos0 = self._bucket_sam_offset[rec_bucket] + rec_off
        rec_mapq = np.minimum(60, 6 * rec_votes).astype(np.int32)
        stats.mapped_locations += len(rec_read)
        self._emit_records(writer, batch, rec_read, rec_flag, rec_bucket,
                           rec_pos0, rec_mapq, None)

    def _merge(self, batch, lr, lbk, loff, lvotes, lorig):
        """The align-free merge of one location chunk: (read, bucket,
        offset, votes, is_orig) record arrays sorted by read."""
        cfg = self.cfg
        multi_mask = np.zeros(len(lr), bool)
        if len(lr) > 1:
            same = lr[1:] == lr[:-1]
            multi_mask[1:] |= same
            multi_mask[:-1] |= same
        s_r = lr[~multi_mask]
        s_bk = lbk[~multi_mask]
        s_off = loff[~multi_mask]
        s_votes = lvotes[~multi_mask]
        s_orig = lorig[~multi_mask]

        m_read, m_bk, m_off, m_votes, m_orig = [], [], [], [], []
        if multi_mask.any():
            mr = lr[multi_mask]
            mbk, moff = lbk[multi_mask], loff[multi_mask]
            mv, mo = lvotes[multi_mask], lorig[multi_mask]
            starts = np.nonzero(np.diff(mr, prepend=-1))[0]
            ends = np.append(starts[1:], len(mr))
            pairable = (ends - starts) == 2
            p2 = starts[pairable]
            if len(p2):
                # same bucket+strand within +-read_len*indel_rate: votes
                # sum onto the first; else the max-vote side(s), ties in
                # (bucket, offset, strand) key order
                i1, i2 = p2, p2 + 1
                x = batch.lengths[mr[i1]] * cfg.indel_rate
                lo = np.trunc(moff[i2] - x)
                hi = np.trunc(moff[i2] + x)
                merged = ((mbk[i1] == mbk[i2]) & (mo[i1] == mo[i2])
                          & (lo <= moff[i1]) & (moff[i1] <= hi))
                k1_first = ((mbk[i1] < mbk[i2])
                            | ((mbk[i1] == mbk[i2])
                               & ((moff[i1] < moff[i2])
                                  | ((moff[i1] == moff[i2])
                                     & (~mo[i1] | mo[i2])))))
                vsum = mv[i1] + mv[i2]
                for sel1, sel2, v1 in (
                        (merged, None, vsum),
                        (~merged & (mv[i1] > mv[i2]), None, mv[i1]),
                        (~merged & (mv[i2] > mv[i1]), "i2", None),
                        (~merged & (mv[i1] == mv[i2]) & k1_first, "both12", None),
                        (~merged & (mv[i1] == mv[i2]) & ~k1_first, "both21",
                         None)):
                    idx = np.nonzero(sel1)[0]
                    if not len(idx):
                        continue
                    a1, a2 = i1[idx], i2[idx]
                    if sel2 is None:
                        picks = [(a1, v1[idx])]
                    elif sel2 == "i2":
                        picks = [(a2, mv[a2])]
                    else:
                        first, second = (a1, a2) if sel2 == "both12" else (a2, a1)
                        picks = [(first, mv[first]), (second, mv[second])]
                    for aa, vv in picks:
                        m_read.extend(mr[aa]); m_bk.extend(mbk[aa])
                        m_off.extend(moff[aa]); m_votes.extend(vv)
                        m_orig.extend(mo[aa])
            for a, b in zip(starts[~pairable], ends[~pairable]):
                r = int(mr[a])
                locs = [Location(int(mbk[i]), int(moff[i]), 0, int(mv[i]),
                                 bool(mo[i])) for i in range(a, b)]
                for loc in filter_best_locations(
                        locs, int(batch.lengths[r]), cfg.indel_rate):
                    m_read.append(r)
                    m_bk.append(loc.bucket)
                    m_off.append(loc.offset)
                    m_votes.append(loc.votes)
                    m_orig.append(loc.is_orig)

        rec_read = np.concatenate([s_r, np.asarray(m_read, np.int64)])
        rec_bucket = np.concatenate([s_bk, np.asarray(m_bk, np.int64)])
        rec_off = np.concatenate([s_off, np.asarray(m_off, np.int64)])
        rec_votes = np.concatenate([s_votes, np.asarray(m_votes, np.int64)])
        rec_orig = np.concatenate([s_orig, np.asarray(m_orig, bool)])
        order = np.argsort(rec_read, kind="stable")
        rec_read, rec_bucket, rec_off = (rec_read[order], rec_bucket[order],
                                         rec_off[order])
        rec_votes, rec_orig = rec_votes[order], rec_orig[order]
        return rec_read, rec_bucket, rec_off, rec_votes, rec_orig

    def _align_long_emit(self, writer, batch, lr, lbk, loff, lorig, lso, qt,
                         stats):
        """Segment-stitched alignment of long reads (> 2*read_len), as the
        reference does it (`_align_long_emit` there): every segment
        location is aligned at its own voted offset (runs path, no
        size_t-wrap rule), then per (read, bucket, strand) the segments
        within a read length of each other form one mapping. Its start
        comes from the boundary segment's DP begin (true forward-genome
        coordinates on both strands), its CIGAR is the segments' runs
        joined by gap filler (min(g_r, g_t) M plus |g_r - g_t| I or D),
        reversed for the reverse strand, and its MAPQ is
        clip(60 + floor(120 * sum(score) / sum(seg_len)), 0, 60)."""
        cfg = self.cfg
        rl = cfg.read_len
        n = len(lr)
        if n == 0:
            return
        stats.aligned_pairs += n
        lens = batch.lengths[lr].astype(np.int64)
        so = lso.astype(np.int64)
        sl = np.minimum(lens - so, rl).astype(np.int64)
        off_j = np.where(lorig, loff + so,
                         loff + (lens - so - sl)).astype(np.int64)
        col = np.arange(rl)
        mask = col[None, :] < sl[:, None]
        src = np.where(mask, so[:, None] + col[None, :], 0)
        qcodes = np.where(mask, batch.codes[lr[:, None], src], 0) \
            .astype(np.uint8)

        sc = np.zeros(n, np.int64)
        bg = np.zeros(n, np.int64)
        nM = np.zeros(n, np.int64)
        nI = np.zeros(n, np.int64)
        nD = np.zeros(n, np.int64)
        seg_runs: list = [None] * n

        def emit_runs(s, e, sc_, bg_, nr, runs, row_off):
            sc[s:e] = sc_
            bg[s:e] = bg_
            tot = int(row_off[-1])
            ops_f = (runs[:tot] & 3).astype(np.int64)
            lens_f = (runs[:tot] >> 2).astype(np.int64)
            row_id = np.repeat(np.arange(e - s), np.diff(row_off))
            for code, acc in ((1, nM), (2, nI), (3, nD)):
                acc[s:e] = np.bincount(
                    row_id, weights=np.where(ops_f == code, lens_f, 0),
                    minlength=e - s)
            for i in range(e - s):
                r0, r1 = int(row_off[i]), int(row_off[i + 1])
                seg_runs[s + i] = [(int(a), int(o)) for a, o in
                                   zip(lens_f[r0:r1], ops_f[r0:r1])]

        # segments at long-read error rates carry many runs: a larger
        # budget, and no size_t-wrap rule (a segment scoring below -60 is
        # still a traceback the stitcher needs)
        self.aligner.align_batch_runs_stream(
            qcodes, sl.astype(np.int32), lbk.astype(np.int32),
            off_j.astype(np.int32), ~lorig, emit_runs,
            run_cap_per_pair=48, wrap_star=False)

        blen = np.asarray(self.index.bucket_lengths)[lbk]
        width = np.minimum(sl + 1 + (cfg.indel_rate * sl).astype(np.int64),
                           blen - off_j)
        # stitching coordinate p grows along the stored read direction
        # (forward: p = absolute position; reverse: p = -absolute)
        begin_p = np.where(lorig, off_j + bg, -(off_j + width - 1 - bg))
        TL = nM + nD
        seg_ok = (nM + nI) == sl                  # traceback spans the segment

        rec_read, rec_flag, rec_bucket = [], [], []
        rec_pos0, rec_mapq, rec_cigar = [], [], []
        op_char = {1: b"M", 2: b"I", 3: b"D"}
        gkeys = np.stack([lr, lbk, lorig.astype(np.int64)], axis=1)
        bounds = np.nonzero(np.any(np.diff(gkeys, axis=0) != 0, axis=1))[0] + 1
        bounds = np.concatenate([[0], bounds, [n]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            grp = np.arange(a, b)[np.argsort(loff[a:b], kind="stable")]
            rlen = int(lens[a])
            # a gap in loff beyond a read length starts a new mapping
            cl_start = 0
            cuts = list(np.nonzero(np.diff(loff[grp]) > rlen)[0] + 1) + [len(grp)]
            for cut in cuts:
                members = grp[cl_start:cut]
                cl_start = cut
                members = members[np.argsort(so[members], kind="stable")]
                _, keep = np.unique(so[members], return_index=True)
                members = members[np.sort(keep)]
                valid = members[seg_ok[members]]
                if len(valid) == 0:
                    continue
                cov = int(sl[valid].sum())
                rate = float(sc[valid].sum()) / max(1, cov)
                mapq = max(0, min(60, 60 + int(np.floor(120.0 * rate))))
                if mapq < qt:
                    stats.records_below_quality += 1
                    continue
                runs: list[tuple[int, int]] = []
                first = valid[0]
                pcur = int(begin_p[first] - so[first])
                rcur = 0
                for j in valid:
                    g_r = int(so[j]) - rcur
                    g_t = max(0, int(begin_p[j]) - pcur)
                    m = min(g_r, g_t)
                    if m:
                        runs.append((m, 1))
                    if g_r > g_t:
                        runs.append((g_r - g_t, 2))
                    elif g_t > g_r:
                        runs.append((g_t - g_r, 3))
                    runs.extend(seg_runs[j])
                    rcur = int(so[j] + sl[j])
                    pcur = int(begin_p[j] + TL[j])
                tail = rlen - rcur
                if tail > 0:
                    runs.append((tail, 1))
                    pcur += tail
                is_fwd = bool(lorig[first])
                if is_fwd:
                    pos0 = int(begin_p[first] - so[first])
                else:
                    # leftmost forward-genome base = the last position in
                    # the stored direction; the CIGAR in reference order
                    pos0 = -(pcur - 1)
                    runs = runs[::-1]
                merged: list[tuple[int, int]] = []
                for cnt, op in runs:
                    if merged and merged[-1][1] == op:
                        merged[-1] = (merged[-1][0] + cnt, op)
                    else:
                        merged.append((cnt, op))
                rec_read.append(int(lr[first]))
                rec_flag.append(0 if is_fwd else 16)
                rec_bucket.append(int(lbk[first]))
                rec_pos0.append(max(0, pos0))
                rec_mapq.append(mapq)
                rec_cigar.append(b"".join(
                    str(c).encode() + op_char[o] for c, o in merged))

        stats.mapped_locations += len(rec_read)
        if rec_read:
            rb = np.asarray(rec_bucket, np.int64)
            self._emit_records(
                writer, batch, np.asarray(rec_read, np.int64),
                np.asarray(rec_flag, np.int32), rb,
                self._bucket_sam_offset[rb] + np.asarray(rec_pos0, np.int64),
                np.asarray(rec_mapq, np.int32), rec_cigar)

    def _align_stream_emit(self, writer, batch, lr, lbk, loff, lorig, qt,
                           stats):
        """Align the locations of reads up to 2*read_len and write their
        records as sub-batches land, on the align-emit thread. MAPQ is 60 +
        score as the reference's size_t: scores below -60 wrap (mod 256)
        and bypass the threshold, with CIGAR '*'."""
        if not len(lr):
            return
        bucket_sam_off = self._bucket_sam_offset
        out = _WriterThread(
            "bmtorch-align-emit",
            lambda job: self._emit_records(writer, batch, *job), self.stage)

        def emit(s, e, scores, begins, cbuf, coffs):
            mapq = 60 + scores.astype(np.int64)
            mapq = np.where(mapq < 0, mapq & 0xFF, mapq)
            wrapped = scores < -60
            keep = np.where(wrapped, True, mapq >= qt)
            kidx = np.nonzero(keep)[0]
            rec_read = lr[s:e][keep]
            rec_bucket = lbk[s:e][keep]
            rec_flag = np.where(lorig[s:e][keep], 0, 16).astype(np.int32)
            rec_pos0 = (bucket_sam_off[rec_bucket] + begins[keep]
                        + loff[s:e][keep])
            rec_mapq = mapq[keep].astype(np.int32)
            # the kept rows' CIGAR byte spans
            klens = coffs[kidx + 1] - coffs[kidx]
            koffs = np.zeros(len(kidx) + 1, np.int64)
            np.cumsum(klens, out=koffs[1:])
            if len(kidx) and koffs[-1]:
                src = (np.repeat(coffs[kidx] - koffs[:-1], klens)
                       + np.arange(koffs[-1], dtype=np.int64))
                kbuf = np.frombuffer(cbuf, np.uint8)[src].tobytes()
            else:
                kbuf = b""
            stats.mapped_locations += len(rec_read)
            stats.aligned_pairs += e - s
            stats.records_wrapped += int(wrapped.sum())
            stats.records_below_quality += e - s - len(kidx)
            out.put((rec_read, rec_flag, rec_bucket, rec_pos0, rec_mapq,
                     (kbuf, koffs)))

        lri = lr.astype(np.int32)
        # in a batch with long reads the code matrix is as wide as the
        # longest; these reads are <= 2*read_len
        qc = batch.codes[lri]
        qc = np.ascontiguousarray(qc[:, :min(qc.shape[1], 2 * self.cfg.read_len)])
        with out:
            self.aligner.align_batch_stream(
                qc, batch.lengths[lri], lbk.astype(np.int32),
                loff.astype(np.int32), ~lorig, emit)

    def _emit_records(self, writer, batch, rec_read, rec_flag, rec_bucket,
                      rec_pos0, rec_mapq, rec_cigar):
        """Format and write records: the native C formatter when
        available, else SamWriter line by line. rec_cigar: (cigar_buf
        bytes, (n+1,) offsets) spans (an empty span is '*'), a list of
        bytes per record, or None for all '*'."""
        from bucketmap_tpu_torch.io import native

        if isinstance(rec_cigar, list):
            offs = np.zeros(len(rec_cigar) + 1, np.int64)
            np.cumsum([len(c) for c in rec_cigar], out=offs[1:])
            rec_cigar = (b"".join(rec_cigar), offs)
        if native.available() and len(rec_read):
            rid = self.index.bucket_ref[np.asarray(rec_bucket, np.int64)]
            rr = np.asarray(rec_read, np.int32)
            out = native.format_sam_records(
                rr, batch.id_offsets, np.ascontiguousarray(batch.ids_buf, np.uint8),
                np.asarray(rec_flag, np.int32), rid.astype(np.int32),
                self._rname_offsets, self._rnames,
                np.asarray(rec_pos0, np.int64), np.asarray(rec_mapq, np.int32),
                (np.zeros(len(rec_read) + 1, np.int64) if rec_cigar is None
                 else rec_cigar[1]),
                np.frombuffer((rec_cigar[0] if rec_cigar else b"") or b"\0",
                              np.uint8),
                rr, batch.lengths[rr].astype(np.int32),
                batch.seq_ascii, batch.qual_ascii)
            if out is not None:
                with self.stage("sam_write"):
                    writer.write_bytes(out)
                return
        bucket_names = self.index.bucket_names
        with self.stage("sam_write"):
            for i in range(len(rec_read)):
                r = int(rec_read[i])
                seq = batch.seq_ascii[r, : batch.lengths[r]].tobytes().decode()
                qual = batch.qual_ascii[r, : batch.lengths[r]].tobytes() \
                    .decode()
                cig = "*" if rec_cigar is None else (
                    rec_cigar[0][rec_cigar[1][i]:rec_cigar[1][i + 1]].decode()
                    or "*")
                writer.write(batch.ids[r], int(rec_flag[i]),
                             bucket_names[int(rec_bucket[i])],
                             int(rec_pos0[i]), int(rec_mapq[i]), seq, qual,
                             cig)
