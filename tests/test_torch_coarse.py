"""The torch port's coarse stage against the JAX package, exactly:

  * coarse_score_plain (the coarse-score kernel's plain version) against
    _coarse_score_pallas in interpret mode and against _chunk_scan_jnp
    over the gathered presence words;
  * the port's CoarseMapper (candidates, counts, good k-mer counts)
    against the JAX CoarseMapper.query_batch, at 6 and 8 samples and at
    32 (six bit planes, past the five that s <= 31 needs).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.ops.coarse import (CoarseMapper as JaxCoarse,
                                      _chunk_scan_jnp, _coarse_score_pallas)
from bucketmap_tpu.sim.simulator import (ShortReadSimulator, random_genome,
                                         repeat_genome)
from bucketmap_tpu_torch.ops.coarse import CoarseMapper, coarse_score_plain
from test_torch_host import port_index


def _table(rng, G1, w):
    """Sparse random occupancy words with an all-ones sentinel last row."""
    a = rng.integers(0, 2**32, (G1, w), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (G1, w), dtype=np.uint64).astype(np.uint32)
    tab = a & b | (rng.integers(0, 2**32, (G1, w), dtype=np.uint64)
                   .astype(np.uint32) & np.uint32(0x0F0F0F0F))
    tab[-1] = 0xFFFFFFFF
    return tab


@pytest.mark.parametrize("s,bound_off", [(15, 17), (6, 200), (32, 17),
                                         (40, 200)])
def test_coarse_score_plain_matches_pallas_and_chunk_scan(s, bound_off):
    rng = np.random.default_rng(s)
    G1, S8, nq, B2 = 64, 8, 4, 8
    w = S8 * 128
    tab = _table(rng, G1, w)
    rows = rng.integers(0, G1, (B2 * s, nq)).astype(np.int32)
    rows[::5, 1] = G1 - 1                     # sentinel rows
    bound = w * 32 - 32 * bound_off - 13      # mid-word boundary
    got = coarse_score_plain(torch.from_numpy(tab.view(np.int32)),
                             torch.from_numpy(rows), bound, s)
    want = _coarse_score_pallas(jnp.asarray(tab.reshape(G1, S8, 128)),
                                jnp.asarray(rows), jnp.int32(bound), s,
                                block_rows=4, interpret=True)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(wnt).view(np.int32))
    # the same words through the unfused reference: presence = AND of rows
    presence = np.bitwise_and.reduce(tab[rows.reshape(B2, s, nq)], axis=2)
    cm, cc, planes = _chunk_scan_jnp(
        jnp.asarray(presence.reshape(B2, 1, s, w)), jnp.int32(bound))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cm)[:, 0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(cc)[:, 0])
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32),
                                  np.asarray(planes)[:, 0])


CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=8, kmer_fraction=1.0)


def _world(name):
    if name == "random":
        return CFG, random_genome(80_000, seed=11, n_refs=2)
    if name == "random_s32":
        # 32 samples: six bit planes per count
        return (dataclasses.replace(CFG, mapper_samples=32),
                random_genome(80_000, seed=11, n_refs=2))
    if name == "repeats":
        # repeats + a small candidate cap: reads cleared for too many ties
        return (MapperConfig(bucket_len=1024, read_len=100, index_seed=5,
                             query_seed=8, mapper_samples=6,
                             max_candidate_buckets=4),
                repeat_genome(40_000, seed=7, n_refs=2))
    # FracMinHash f=0.5: a non-identity row map and its sentinel rows
    return (MapperConfig(bucket_len=4096, read_len=150, index_seed=6,
                         query_seed=9, mapper_samples=8, kmer_fraction=0.5),
            random_genome(60_000, seed=12, n_refs=1))


@pytest.mark.parametrize("name", ["random", "repeats", "frac", "random_s32"])
def test_coarse_mapper_matches_jax(name):
    cfg, genome = _world(name)
    index = build_index(genome, cfg)
    sim = ShortReadSimulator(cfg, substitution_rate=0.01, insertion_rate=0.002,
                             deletion_rate=0.002, seed=5)
    sim.read(genome)
    n = 64
    codes = np.zeros((n, cfg.read_len), np.uint8)
    quals = np.full((n, cfg.read_len), 36, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        c, *_ = sim.sample()
        c = c[: cfg.read_len]
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    quals[-4:] = 0                      # low-quality reads give up
    lengths[-6] = 5                     # shorter than k: no k-mers at all
    # XLA's CPU compile of the JAX query grows steeply with s (5 s at
    # s = 16, 30 s at 24, over ten minutes at 32): run it op by op there
    eager = jax.disable_jit() if cfg.mapper_samples >= 32 else \
        contextlib.nullcontext()
    with eager:
        want = JaxCoarse(index).query_batch(codes, quals, lengths)
    got = CoarseMapper(port_index(index), "cpu").query_batch(codes, quals,
                                                             lengths)
    for g, w, what in zip(got, want, ("cand", "counts", "num_good")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=what)
    assert (got[1] > 0).any()
