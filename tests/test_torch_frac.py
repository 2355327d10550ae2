"""FracMinHash (-f 0.25) through the whole pipeline: the port's SAM byte
for byte the JAX pipeline's, align-free and in align mode, on an index
that keeps a quarter of the q-grams (the others map to no occupancy
row); and the names and flags of the port's bench worlds, which must
stay bench.py's so that one cache serves both packages. The JAX side
locates once (a module fixture) and feeds its location chunks to each
mode's emit."""

import copy

import numpy as np
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.io.fastq import read_fastq as jax_read_fastq
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu.mapper.pipeline import MapStats as JaxMapStats
from bucketmap_tpu.sim.simulator import ShortReadSimulator, repeat_genome
from bucketmap_tpu_torch import world
from bucketmap_tpu_torch.config import MapperConfig as PortConfig
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from test_torch_host import port_index

CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=6, kmer_fraction=0.25)


@pytest.fixture(scope="module")
def frac_world(tmp_path_factory):
    """(directory, the JAX pipeline, built once with its aligner, FASTQ of
    128 reads, the JAX pipeline's location chunks of those reads)."""
    d = tmp_path_factory.mktemp("torch_frac")
    genome = repeat_genome(200_000, seed=71, n_refs=2)
    index = build_index(genome, CFG)
    sim = ShortReadSimulator(CFG, substitution_rate=0.01, insertion_rate=0.001,
                             deletion_rate=0.001, seed=72)
    sim.read(genome)
    fastq = sim.generate(d, "frac", 128)["fastq"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BMTPU_DEVICE_FINE", "1")
        pipe = JaxPipeline(index, align=True, batch_size=128, pair_batch=64)
    chunks = list(pipe.locate_chunks(jax_read_fastq(fastq), JaxMapStats()))
    return d, pipe, fastq, chunks


@pytest.mark.parametrize("align", [False, True])
def test_frac_sam_matches_jax_pipeline(frac_world, align):
    d, pipe, fastq, chunks = frac_world
    index = pipe.index
    absent = np.asarray(index.kmer_to_row) < 0
    assert 0.6 < absent.mean() < 0.9       # FracMinHash dropped most q-grams
    tag = "align" if align else "free"
    jp = copy.copy(pipe)
    jp.align = align
    jp.locate_chunks = lambda batch, stats: iter(chunks)
    jp.map_fastq(fastq, d / f"jax_{tag}.sam")
    stats = BucketMapPipeline(port_index(index), device="cpu", align=align,
                              batch_size=128, pair_batch=64).map_fastq(
        fastq, d / f"port_{tag}.sam")
    want = (d / f"jax_{tag}.sam").read_bytes()
    assert (d / f"port_{tag}.sam").read_bytes() == want
    assert stats.num_reads == 128 and stats.mapped_locations > 64


def test_world_names_and_ont_flags_are_bench_pys(tmp_path):
    """bench.py's cache names (idx_{gtag}, reads_g{gtag}m_r{n}[_long],
    gtag = {mbp:g}rep2[_f{f:g}]) and its long-read flags, as literals."""
    assert world.index_name(1700) == "idx_1700rep2"
    assert world.index_name(3100, 0.25) == "idx_3100rep2_f0.25"
    assert world.ont_config(PortConfig(bucket_len=65536, read_len=300)) == \
        PortConfig(bucket_len=65536, read_len=300, mapper_samples=30,
                   seed_miss_rate=0.9, indel_rate=0.1, locator_samples=20,
                   quality_threshold=5)
    cache = str(tmp_path)
    genome = world.bench_genome(0.2)
    index, fastq, gt, _ = world.bench_world(cache, 0.2, 16, log=str,
                                            genome=genome, kmer_fraction=0.25)
    assert index.config.kmer_fraction == 0.25
    assert (tmp_path / "idx_0.2rep2_f0.25.bmtpu.json").exists()
    assert fastq == str(tmp_path / "reads_g0.2rep2_f0.25m_r16.fastq")
    assert gt == str(tmp_path / "reads_g0.2rep2_f0.25m_r16"
                                ".position_ground_truth")
    fastq, gt, _ = world.bench_reads(cache, 2, 0.2, genome, long=True,
                                     log=str)
    assert fastq == str(tmp_path / "reads_g0.2rep2m_r2_long.fastq")
    lens = [len(ln) - 1 for i, ln in enumerate(open(fastq)) if i % 4 == 1]
    assert len(lens) == 2 and all(5000 <= n <= 16500 for n in lens)
    assert open(gt).read().count("\n") == 2
