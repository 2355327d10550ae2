"""The torch port's on-device fine-index build against the JAX device
build and the host build, bit for bit: the tiled (N, Tp, 128)
fine_packed, the (N, 4097) fine_ptab, search_steps and low_bits."""

import numpy as np
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index import builder
from bucketmap_tpu.index.device_build import \
    build_fine_index_on_device as jax_build
from bucketmap_tpu.sim.simulator import random_genome, repeat_genome
from bucketmap_tpu_torch.index.device_build import (build_fine_index_on_device,
                                                    check_fine_sentinel)
from test_torch_host import port_index


def _index(genome_len=30_000, k=8, repeats=False, seed=3):
    cfg = MapperConfig(bucket_len=2048, read_len=100, index_seed=5,
                       query_seed=k)
    make = repeat_genome if repeats else random_genome
    return builder.build_index(make(genome_len, seed=seed, n_refs=2), cfg)


@pytest.mark.parametrize("genome_len,k,repeats", [
    (30_000, 8, False),
    (2048 * 3 + 500, 8, False),     # a short last bucket
    (40_000, 12, True),             # the production k, repeat structure
])
def test_device_build_matches_jax_and_host(genome_len, k, repeats):
    index = _index(genome_len, k, repeats)
    fp, pt, steps, low_bits = build_fine_index_on_device(port_index(index),
                                                         "cpu", row_chunk=3)
    jfp, jpt, jsteps, jlow = jax_build(index, row_chunk=4)
    np.testing.assert_array_equal(fp.numpy().view(np.uint32), np.asarray(jfp))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    assert (steps, low_bits) == (jsteps, jlow)

    host = _index(genome_len, k, repeats)
    builder.build_fine_index(host)
    lpos = host.fine_packed.shape[1]
    flat = fp.numpy().view(np.uint32).reshape(fp.shape[0], -1)
    np.testing.assert_array_equal(flat[:, :lpos], host.fine_packed)
    assert (flat[:, lpos:] == 0xFFFFFFFF).all()
    assert fp.shape[1] * 128 - lpos >= 256      # two spare window rows
    np.testing.assert_array_equal(pt.numpy(), host.fine_ptab)
    assert steps == host.fine_search_steps
    assert low_bits == host.fine_low_bits


def test_device_build_gates_unsupported_k():
    assert build_fine_index_on_device(port_index(_index(10_000, k=16)),
                                      "cpu") is None


def test_sentinel_guard():
    index = _index(20_000)
    fp, pt, _, _ = build_fine_index_on_device(port_index(index), "cpu")
    fp, pt = fp.numpy().view(np.uint32).copy(), pt.numpy()
    check_fine_sentinel(fp, pt)                  # padding may be 0xFFFFFFFF
    fp[1, 0, 5] = 0xFFFFFFFF                     # a real slot may not
    with pytest.raises(ValueError, match="sentinel"):
        check_fine_sentinel(fp, pt)
