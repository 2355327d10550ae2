"""Long reads at the reference's long-read flags (-s 30 -e 0.9 -n 0.1
-p 20 -u 5; tests/test_long_reads.py's MapperConfig): the port's SAM
byte for byte the JAX pipeline's, align-free and in the segment-stitched
align mode, on a few 2-3 kbp reads that map as num_segment_samples
segments each. The JAX side locates op by op: its XLA compile at 30
samples per read-strand takes minutes on the CPU. Its location chunks
are made once per read set and fed to each JAX pipeline's emit."""

import contextlib
import copy

import jax
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.io.fastq import read_fastq as jax_read_fastq
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu.mapper.pipeline import MapStats as JaxMapStats
from bucketmap_tpu.sim.simulator import LongReadSimulator, repeat_genome
from bucketmap_tpu_torch.io.fastq import read_fastq
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from bucketmap_tpu_torch.ops.align import band_geometry
from test_torch_host import port_index

CFG = MapperConfig(bucket_len=16384, read_len=300, query_seed=12,
                   mapper_samples=30, seed_miss_rate=0.9, indel_rate=0.1,
                   locator_samples=20, quality_threshold=5)


@pytest.fixture(scope="module")
def ont(tmp_path_factory):
    """errors -> (directory, the JAX pipeline, built once with its aligner,
    FASTQ of six 2-3 kbp reads at that substitution, insertion and
    deletion rate each, the JAX pipeline's location chunks of those
    reads)."""
    d = tmp_path_factory.mktemp("ont")
    genome = repeat_genome(200_000, seed=61, n_refs=2)
    index = build_index(genome, CFG)
    worlds = {}

    def make(errors):
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            mp.setenv("BMTPU_DEVICE_FINE", "1")
            if "pipe" not in worlds:
                worlds["pipe"] = JaxPipeline(index, align=True, batch_size=64,
                                             pair_batch=64)
            if errors not in worlds:
                sim = LongReadSimulator(genome, mean_len=2500, sd_len=300,
                                        min_len=2000, substitution_rate=errors,
                                        insertion_rate=errors,
                                        deletion_rate=errors, seed=62)
                fastq = sim.generate(d, f"ont{errors}", 6)["fastq"]
                chunks = list(worlds["pipe"].locate_chunks(
                    jax_read_fastq(fastq), JaxMapStats()))
                worlds[errors] = fastq, chunks
        return (d, worlds["pipe"]) + worlds[errors]

    return make


def jax_sam(pipe, chunks, fastq, sam, align: bool) -> bytes:
    """The JAX pipeline's SAM of `fastq` from its location chunks, through
    a copy of `pipe` in the given mode: the align-free emit op by op (its
    compile would outlast it), the aligner jitted."""
    jp = copy.copy(pipe)
    jp.align = align
    jp.locate_chunks = lambda batch, stats: iter(chunks)
    with contextlib.nullcontext() if align else jax.disable_jit():
        jp.map_reads(jax_read_fastq(fastq), sam)
    return sam.read_bytes()


@pytest.mark.parametrize("errors", [0.0, 0.02])
def test_long_read_sam_matches_jax_at_reference_flags(ont, errors):
    d, jp, fastq, chunks = ont(errors)
    batch = read_fastq(fastq)
    assert (batch.lengths > 2 * CFG.read_len).all()
    want = jax_sam(jp, chunks, fastq, d / f"jax{errors}.sam", False)
    stats = BucketMapPipeline(port_index(jp.index), device="cpu",
                              batch_size=64, pair_batch=64).map_reads(
        batch, d / f"port{errors}.sam")
    assert (d / f"port{errors}.sam").read_bytes() == want
    assert stats.num_reads == 6 and stats.mapped_locations >= 5


def test_long_read_align_sam_matches_jax_at_reference_flags(ont, monkeypatch):
    """The stitched align mode at indel rate 0.1: every segment location
    goes through the run-path DP at the legacy band (128, lo 32) with a
    48-run budget and no size_t-wrap rule, then the stitcher joins each
    (read, bucket, strand) group's segments into one record."""
    d, jp, fastq, chunks = ont(0.02)
    want = jax_sam(jp, chunks, fastq, d / "jax_align.sam", True)
    pipe = BucketMapPipeline(port_index(jp.index), device="cpu", align=True,
                             batch_size=64, pair_batch=64)
    calls = []
    stream = pipe.aligner.align_batch_runs_stream

    def record(qcodes, *a, **kw):
        calls.append((qcodes.shape[1], kw))
        return stream(qcodes, *a, **kw)

    monkeypatch.setattr(pipe.aligner, "align_batch_runs_stream", record)
    stats = pipe.map_reads(read_fastq(fastq), d / "port_align.sam")
    assert (d / "port_align.sam").read_bytes() == want
    assert calls == [(CFG.read_len, {"run_cap_per_pair": 48,
                                     "wrap_star": False})]
    assert band_geometry(-(-CFG.read_len // 16) * 16, CFG.indel_rate) == \
        (128, 32)
    records = [ln.split(b"\t") for ln in want.splitlines()
               if not ln.startswith(b"@")]
    assert stats.num_reads == 6 and len(records) >= 5
    assert all(b"I" in r[5] and b"D" in r[5] for r in records)
