"""The port's on-device occupancy build against the host build and the
JAX device build, bit for bit: at FracMinHash f = 1 (identity row map)
and f = 0.5 (unsampled q-grams set no bit), with bucket counts that are
not a multiple of 32 and chunks of word columns whose last one is short;
None where index_seed > 10; and the step on the built table equal to the
step on the uploaded one."""

import jax
import numpy as np
import pytest

from __graft_entry__ import _batch, _tiny_world
from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.index.device_build import \
    build_occupancy_on_device as jax_build
from bucketmap_tpu.sim.simulator import random_genome, repeat_genome
from bucketmap_tpu_torch.index import device_build
from bucketmap_tpu_torch.index.device_build import build_occupancy_on_device
from bucketmap_tpu_torch.mapper.device_pipeline import DeviceMapper
from test_torch_host import port_index


def _index(frac, genome_len, q=6, repeats=False):
    cfg = MapperConfig(bucket_len=1024, read_len=100, index_seed=q,
                       query_seed=max(q, 10), kmer_fraction=frac)
    make = repeat_genome if repeats else random_genome
    return build_index(make(genome_len, seed=5, n_refs=3), cfg)


@pytest.mark.parametrize("frac,genome_len,groups,repeats", [
    (1.0, 45_000, 1, False),     # 45 buckets: two word columns, one short
    (0.5, 45_000, 1, False),
    (1.0, 80_000, 2, True),      # 79 buckets over three columns
    (0.5, 110_000, 2, True),     # a short last chunk of columns
])
def test_occupancy_build_matches_host_and_jax(frac, genome_len, groups,
                                              repeats, monkeypatch):
    index = _index(frac, genome_len, repeats=repeats)
    n = index.n_buckets
    assert n % 32 != 0
    k2r = np.asarray(index.kmer_to_row)
    assert (k2r < 0).any() == (frac < 1)
    monkeypatch.setattr(device_build, "OCCUPANCY_GROUPS", groups)
    got = build_occupancy_on_device(port_index(index), "cpu")
    assert got.dtype.is_signed and got.shape == index.qgram_words.shape
    words = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, index.qgram_words)
    np.testing.assert_array_equal(words, np.asarray(jax_build(index)))
    assert (words[-1] == 0xFFFFFFFF).all()


def test_occupancy_build_out_of_scope():
    assert build_occupancy_on_device(port_index(_index(1.0, 12_000, q=11)),
                                     "cpu") is None


def test_step_on_device_occupancy_matches_jax():
    """occupancy_build="device" gives the JAX step's vector (the JAX
    mapper uploads its host table on the CPU) and refuses a mesh."""
    cfg, index, sim = _tiny_world()
    batch = _batch(sim, cfg, 32)
    from bucketmap_tpu.mapper.device_pipeline import DeviceMapper as JaxMapper
    want = np.asarray(jax.device_get(
        JaxMapper(index, batch_size=32, vote_chunk=32).step(*batch)))
    tindex = port_index(index)
    dm = DeviceMapper(tindex, "cpu", batch_size=32, vote_chunk=32,
                      occupancy_build="device")
    np.testing.assert_array_equal(
        dm.tables["qgram_words"].numpy().view(np.uint32), index.qgram_words)
    np.testing.assert_array_equal(dm.step(*batch).numpy(), want)
    from bucketmap_tpu_torch.parallel.sharding import Mesh
    with pytest.raises(ValueError, match="single"):
        DeviceMapper(tindex, "cpu", batch_size=32, occupancy_build="device",
                     mesh=Mesh(1, 1, 0, 0, None, None, None))
    q11 = port_index(_index(1.0, 12_000, q=11))
    with pytest.raises(ValueError, match="index_seed <= 10"):
        DeviceMapper(q11, "cpu", batch_size=32, occupancy_build="device")
