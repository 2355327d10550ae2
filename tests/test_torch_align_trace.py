"""The port's align mode under the stage hook, and its counters.

A recording hook on `BucketMapPipeline.stage` sees "align" once a batch
on the calling thread, around the batch's DP sub-batches, with
"handoff" (one a sub-batch's records put on the align-emit thread's
queue) and "drain" (once a batch) inside it; the SAM is byte for byte
the same with and without the hook. `MapStats` counts the aligned
pairs (the aligner's `pairs`), the records dropped under the quality
threshold and the wrapped ones (score under -60), each equal to a count
made here from `align_batch_cigars`' scores on the same located pairs;
the aligner's `dp_*` counts are the runs-path launches' shapes. The
world is the port's own (config, index build, simulator) plus three
reads near a bucket's end in a chunk whose 290-base read widens the DP
query, which shifts their windows out of the band (wrapped records):
no JAX is needed here."""

import collections

import numpy as np
import pytest

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index.builder import build_index
from bucketmap_tpu_torch.io.fastq import iter_fastq_batches
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from bucketmap_tpu_torch.ops.align import band_geometry, run_budget
from bucketmap_tpu_torch.sim.simulator import ShortReadSimulator, repeat_genome
from test_torch_trace import Recorder

CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=8)
READS, PER_CHUNK, BATCH, PAIRS = 600, 250, 128, 64
QT = 55
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_align_trace")
    genome = repeat_genome(120_000, seed=21, n_refs=2)
    index = build_index(genome, CFG)
    sim = ShortReadSimulator(CFG, substitution_rate=0.01,
                             insertion_rate=0.001, deletion_rate=0.001,
                             seed=32)
    sim.read(genome)
    fastq = sim.generate(d, "reads", READS)["fastq"]
    codes = genome[0].codes
    with open(fastq, "ab") as f:
        for name, s, n in (("wide", 30_000, 290), ("end0", 4_000, 150),
                           ("end1", 8_100, 150), ("end2", 12_180, 150)):
            f.write(b"@%s\n%s\n+\n%s\n" % (name.encode(),
                                            ACGT[codes[s:s + n]].tobytes(),
                                            b"E" * n))
    pipe = BucketMapPipeline(index, device="cpu", align=True,
                             batch_size=BATCH, pair_batch=PAIRS)
    c0 = dict(pipe.aligner.counts)
    plain = pipe.map_fastq(fastq, d / "plain.sam", quality_threshold=QT,
                           reads_per_chunk=PER_CHUNK)
    counts = {k: v - c0[k] for k, v in pipe.aligner.counts.items()}
    rec = Recorder()
    pipe.stage = rec
    stats = pipe.map_fastq(fastq, d / "traced.sam", quality_threshold=QT,
                           reads_per_chunk=PER_CHUNK)
    return {"pipe": pipe, "fastq": fastq, "plain": plain, "stats": stats,
            "counts": counts, "spans": rec.spans,
            "sam": (d / "traced.sam").read_bytes(),
            "plain_sam": (d / "plain.sam").read_bytes()}


def test_align_spans_once_a_batch(world):
    n = collections.Counter(name for _, name, _, _ in world["spans"])
    batches = -(-(READS + 4) // PER_CHUNK)
    assert n["align"] == n["drain"] == n["segment"] == batches
    # one handoff a DP sub-batch (every one took the runs path)
    assert n["handoff"] == world["counts"]["sub_batches"] > batches
    assert world["counts"]["ops_reruns"] == 0
    assert {th for th, name, _, _ in world["spans"]
            if name in ("align", "handoff", "drain")} == {"main"}
    # handoff and drain lie inside the batch's align span
    aligns = [(a, b) for th, name, a, b in world["spans"] if name == "align"]
    for th, name, a, b in world["spans"]:
        if name in ("handoff", "drain"):
            assert any(a0 <= a and b <= b1 for a0, b1 in aligns), name


def test_align_sam_equal_with_and_without_the_hook(world):
    assert world["sam"] == world["plain_sam"]
    assert world["stats"].num_reads == world["plain"].num_reads == READS + 4
    assert world["stats"].aligned_pairs == world["plain"].aligned_pairs


def _recount(world):
    """(pairs, below the threshold, wrapped, the dp_* counts) from
    align_batch_cigars' scores on each chunk's located pairs, and from
    the chunk's query width q and its launch geometry."""
    pipe = world["pipe"]
    pairs = below = wrapped = 0
    dp = collections.Counter()
    for batch in iter_fastq_batches(world["fastq"],
                                    reads_per_batch=PER_CHUNK):
        (lr, bk, off, _, orig, _), _ = pipe.locate_arrays(batch)
        qc = np.ascontiguousarray(
            batch.codes[lr][:, :min(batch.codes.shape[1], 2 * CFG.read_len)])
        qlen = batch.lengths[lr]
        sc, _, _, _ = pipe.aligner.align_batch_cigars(
            qc, qlen, bk.astype(np.int32), off.astype(np.int32), ~orig)
        pairs += len(sc)
        wrapped += int((sc < -60).sum())
        below += int(((sc >= -60) & (60 + sc.astype(np.int64) < QT)).sum())
        q = -(-qc.shape[1] // 16) * 16
        band, lo = band_geometry(q, CFG.indel_rate)
        launched = -(-len(sc) // PAIRS) * PAIRS
        rows = int(np.minimum(qlen, q).sum())
        dp.update({"dp_launched_rows": launched, "dp_rows": rows,
                   "dp_row_text": launched * (lo + q + band),
                   "dp_row_query": launched * q,
                   "dp_row_runs": launched * run_budget(band)[1],
                   "dp_row_band": rows * band})
    return pairs, below, wrapped, dict(dp)


def test_align_counters(world):
    stats, counts = world["stats"], world["counts"]
    pairs, below, wrapped, dp = _recount(world)
    assert stats.aligned_pairs == counts["pairs"] == pairs
    assert stats.records_below_quality == below > 0
    assert stats.records_wrapped == wrapped > 0
    cigars = [line.split(b"\t")[5] for line in world["sam"].split(b"\n")
              if line and not line.startswith(b"@")]
    assert cigars.count(b"*") == wrapped
    assert {k: counts[k] for k in dp} == dp
