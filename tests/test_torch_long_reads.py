"""Long reads at the reference's long-read flags (-s 30 -e 0.9 -n 0.1
-p 20 -u 5; tests/test_long_reads.py's MapperConfig): the port's
align-free SAM byte for byte the JAX pipeline's, on a few 2-3 kbp reads
that map as num_segment_samples segments each. The JAX side runs op by
op: its XLA compile at 30 samples per read-strand takes minutes on the
CPU."""

import jax
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.io.fastq import read_fastq as jax_read_fastq
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu.sim.simulator import LongReadSimulator, repeat_genome
from bucketmap_tpu_torch.io.fastq import read_fastq
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from test_torch_host import port_index

CFG = MapperConfig(bucket_len=16384, read_len=300, query_seed=12,
                   mapper_samples=30, seed_miss_rate=0.9, indel_rate=0.1,
                   locator_samples=20, quality_threshold=5)


@pytest.mark.parametrize("errors", [0.0, 0.02])
def test_long_read_sam_matches_jax_at_reference_flags(tmp_path, monkeypatch,
                                                      errors):
    genome = repeat_genome(200_000, seed=61, n_refs=2)
    index = build_index(genome, CFG)
    sim = LongReadSimulator(genome, mean_len=2500, sd_len=300, min_len=2000,
                            substitution_rate=errors, insertion_rate=errors,
                            deletion_rate=errors, seed=62)
    fastq = sim.generate(tmp_path, "ont", 6)["fastq"]
    batch = read_fastq(fastq)
    assert (batch.lengths > 2 * CFG.read_len).all()
    monkeypatch.setenv("BMTPU_DEVICE_FINE", "1")
    with jax.disable_jit():
        JaxPipeline(index, batch_size=64, pair_batch=64).map_reads(
            jax_read_fastq(fastq), tmp_path / "jax.sam")
    stats = BucketMapPipeline(port_index(index), device="cpu", batch_size=64,
                              pair_batch=64).map_reads(batch,
                                                       tmp_path / "port.sam")
    want = (tmp_path / "jax.sam").read_bytes()
    assert (tmp_path / "port.sam").read_bytes() == want
    assert stats.num_reads == 6 and stats.mapped_locations >= 5
