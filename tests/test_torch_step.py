"""The torch port's device step against JAX DeviceMapper.step, word for
word: the packed result vector (header, per-read candidate counts and
the accepted lanes, garbage slots included) on the same batch. The JAX
step takes its tiled packed vote path (BMTPU_DEVICE_FINE=1); the port
gets its tables once from its own device build and once carried over
from the JAX step's tables (tables_from_numpy). The index reaches the
port through index_from_arrays."""

import numpy as np
import jax
import pytest

from __graft_entry__ import _batch, _tiny_world
from bucketmap_tpu.mapper.device_pipeline import DeviceMapper as JaxMapper
from bucketmap_tpu_torch.mapper.device_pipeline import (DeviceMapper,
                                                        tables_from_numpy)
from test_torch_host import port_index

B = 64
STEP = dict(batch_size=B, vote_chunk=32)


def _jax_tables(jm) -> dict:
    coarse, fine = jm.coarse, jm.fine
    return {
        "qgram_words": np.asarray(coarse.qgram_words),
        "kmer_to_row": np.asarray(coarse.kmer_to_row),
        "dist_tab": np.asarray(coarse._index_args()[2]),
        "mapper_sample_tab": np.asarray(coarse.sample_tab),
        "locator_sample_tab": np.asarray(fine.sample_tab),
        "fine_packed": np.asarray(fine.fine_packed),
        "fine_ptab": np.asarray(fine.fine_ptab),
        "search_steps": fine.search_steps,
        "low_bits": fine.low_bits,
    }


@pytest.fixture(scope="module", params=["tiny", "repeats"])
def world(request):
    """One world, one batch, and the JAX step's result on it for a normal
    lane budget (4 pairs per read) and an overflowing one (1 per read)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BMTPU_DEVICE_FINE", "1")
    try:
        cfg, index, sim = _tiny_world(repeats=request.param == "repeats")
        codes, quals, lengths = _batch(sim, cfg, B)
        lengths[-3:] = 0                      # padding rows of a short batch
        out = {}
        for ppr in (4, 1):
            jm = JaxMapper(index, pairs_per_read=ppr, **STEP)
            assert jm._vote_path == "packed" and jm.fine.fine_packed.ndim == 3
            out[ppr] = (jm, np.asarray(jax.device_get(
                jm.step(codes, quals, lengths))))
        yield port_index(index), (codes, quals, lengths), out
    finally:
        mp.undo()


@pytest.mark.parametrize("tables", ["own_build", "from_jax"])
@pytest.mark.parametrize("ppr", [4, 1])
def test_step_vector_matches_jax(world, tables, ppr):
    """At 4 pairs per read the vectors are equal word for word. At 1 the
    JAX step overflows its lane budget and drops lanes (its pipeline then
    maps the batch again in halves); the port's step grows past its
    budget and holds every lane, so its decoded vector equals that of
    the JAX step at 4 pairs per read, which holds them all."""
    index, batch, out = world
    jm, want = out[ppr]
    tabs = None if tables == "own_build" else \
        tables_from_numpy(_jax_tables(jm), "cpu")
    dm = DeviceMapper(index, "cpu", pairs_per_read=ppr, tables=tabs, **STEP)
    got = dm.step(*batch).numpy()
    assert got.dtype == np.int32
    assert want[0] > 0                        # some lanes were accepted
    if ppr == 1:
        assert want[1] > jm.lane_budget       # the JAX step overflowed
        jm, want = out[4]
        assert want[1] <= jm.lane_budget and want[0] <= jm.out_cap
        assert got[2] > dm.lane_budget and got[3] > dm.out_cap   # grown
    else:
        np.testing.assert_array_equal(got, want)
    host, jhost = dm.decode_out(got), jm.decode_out(want)
    for key in ("lane_read", "lane_rc", "lane_bucket", "offset", "votes",
                "counts", "local_valid", "n_accept"):
        np.testing.assert_array_equal(host[key], jhost[key], err_msg=key)
    assert host["total_valid"] == jhost["total_valid"]


def test_decode_reads_a_grown_capacity(world):
    """decode_out reads each vector's output capacity from its header: a
    vector whose capacity is above out_cap, its slots past n_accept
    padding, decodes to the lanes of the vector it was made from."""
    index, batch, _ = world
    dm = DeviceMapper(index, "cpu", pairs_per_read=4, **STEP)
    vec = dm.step(*batch).numpy()
    assert vec[3] == dm.out_cap and len(vec) == 8 + B + 2 * dm.out_cap
    cap = dm.out_cap + 128
    grown = np.concatenate([vec, np.full(2 * 128, -1, np.int32)])
    grown[3] = cap
    host, want = dm.decode_out(grown), dm.decode_out(vec)
    assert list(host["out_cap"]) == [cap] and list(want["out_cap"]) == \
        [dm.out_cap]
    for key in ("lane_read", "lane_rc", "lane_bucket", "offset", "votes",
                "counts", "local_valid", "n_accept"):
        np.testing.assert_array_equal(host[key], want[key], err_msg=key)
    assert len(host["lane_read"]) == vec[0] > 0
    for cut in (grown[:-2], np.concatenate([grown, vec[:1]])):
        with pytest.raises(ValueError):
            dm.decode_out(cut)
