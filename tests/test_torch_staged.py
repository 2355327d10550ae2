"""The staged coarse branch of the torch port against the JAX package,
exactly:

  * presence_gather_plain (the presence-gather kernel's plain version)
    against _presence_gather_pallas in interpret mode, repeated rows
    included;
  * chunk_scan_plain (the chunk-scan kernel's plain version) against
    _chunk_scan_pallas in interpret mode and _chunk_scan_jnp: equal on the
    first w words, and the JAX tile padding reads -1 / 32 / 0;
  * CoarseMapper(coarse_path="staged") against the fused query and the
    JAX query_batch;
  * the staged single-device step vector against the JAX step, word for
    word.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _batch, _tiny_world
from bucketmap_tpu.mapper.device_pipeline import DeviceMapper as JaxMapper
from bucketmap_tpu.ops.coarse import (CoarseMapper as JaxCoarse,
                                      _chunk_scan_jnp, _chunk_scan_pallas,
                                      _presence_gather_pallas)
from bucketmap_tpu_torch.mapper.device_pipeline import DeviceMapper
from bucketmap_tpu_torch.ops.coarse import (CoarseMapper, chunk_scan,
                                            chunk_scan_plain, presence_gather,
                                            presence_gather_plain)
from test_torch_host import port_index


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("R,nq", [(240, 4), (60, 4), (480, 2), (30, 7),
                                  (17, 4)])
def test_presence_gather_plain_matches_pallas(R, nq):
    rng = np.random.default_rng(R * 10 + nq)
    G1, wq = 513, 1024                 # the Pallas side needs wq % 1024 == 0
    tab = rng.integers(0, 2**32, (G1, wq), dtype=np.uint32)
    rows = rng.integers(0, G1, (R, nq)).astype(np.int32)
    want = _presence_gather_pallas(jnp.asarray(tab).reshape(G1, wq // 128, 128),
                                   jnp.asarray(rows), interpret=True)
    got = presence_gather_plain(_t(tab), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_presence_gather_plain_repeated_rows():
    """Every sample on the all-ones sentinel row, and rows repeated within
    a sample."""
    rng = np.random.default_rng(4)
    G1, wq = 64, 1024
    tab = rng.integers(0, 2**32, (G1, wq), dtype=np.uint32)
    tab[-1] = 0xFFFFFFFF
    rows = np.full((96, 4), G1 - 1, np.int32)
    rows[::3, 2] = 5
    rows[1::3, :2] = 7
    want = _presence_gather_pallas(jnp.asarray(tab).reshape(G1, wq // 128, 128),
                                   jnp.asarray(rows), n_slots=2, interpret=True)
    got = presence_gather_plain(_t(tab), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert (got[::3].numpy().view(np.uint32) == tab[5]).all()


@pytest.mark.parametrize("s,w,bound", [
    (15, 200, 200 * 32 - 45),          # mid-word boundary, padded tile
    (8, 128, 128 * 32),                # no boundary, no padding
    (6, 40, 13 * 32),                  # word-aligned boundary, w < 128
    (31, 130, 0),                      # everything masked: -1 / 32
    (32, 130, 130 * 32 - 45),          # six planes
    (40, 40, 35 * 32 + 7),             # six planes, mid-word boundary
])
def test_chunk_scan_plain_matches_pallas_and_jnp(s, w, bound):
    rng = np.random.default_rng(s + w)
    B = 8
    presence = (rng.integers(0, 2**32, (B, 2, s, w), dtype=np.uint32)
                | rng.integers(0, 2**32, (B, 2, s, w), dtype=np.uint32))
    presence[0, 1] = 0xFFFFFFFF        # the sentinel-row pattern
    got = chunk_scan_plain(_t(presence), bound)
    pallas = _chunk_scan_pallas(jnp.asarray(presence), jnp.int32(bound),
                                block_rows=16, interpret=True)
    plain = _chunk_scan_jnp(jnp.asarray(presence), jnp.int32(bound))
    for want in (pallas, plain):
        cm, cc, planes = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got[0].numpy(), cm[..., :w])
        np.testing.assert_array_equal(got[1].numpy(), cc[..., :w])
        np.testing.assert_array_equal(got[2].numpy().view(np.uint32),
                                      planes[..., :w])
        # the JAX tile padding can give no candidate
        assert (cm[..., w:] == -1).all() and (cc[..., w:] == 32).all()
        assert (planes[..., w:] == 0).all()
    assert got[2].shape == (B, 2, s.bit_length(), w)


def test_staged_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        presence_gather(meta(8, 40), meta(30, 4))
    with pytest.raises(ValueError, match="CUDA"):
        chunk_scan(meta(4, 2, 15, 40), 1000)


@pytest.mark.parametrize("repeats", [False, True])
def test_staged_query_matches_fused_and_jax(repeats):
    cfg, index, sim = _tiny_world(repeats=repeats)
    codes, quals, lengths = _batch(sim, cfg, 48)
    quals[-3:] = 0                     # low-quality reads give up
    want = JaxCoarse(index).query_batch(codes, quals, lengths)
    tindex = port_index(index)
    fused = CoarseMapper(tindex, "cpu").query_batch(codes, quals, lengths)
    staged = CoarseMapper(tindex, "cpu", coarse_path="staged").query_batch(
        codes, quals, lengths)
    for s, f, w, what in zip(staged, fused, want,
                             ("cand", "counts", "num_good")):
        np.testing.assert_array_equal(s, f, err_msg=what)
        np.testing.assert_array_equal(s, np.asarray(w), err_msg=what)
    assert (staged[1] > 0).any()
    with pytest.raises(ValueError, match="coarse_path"):
        CoarseMapper(tindex, "cpu", coarse_path="unfused")


@pytest.mark.parametrize("ppr", [4, 1])
def test_staged_step_vector_matches_jax(monkeypatch, ppr):
    """The single-device step through the staged branch, with a lane budget
    that holds (4 pairs per read): the JAX step's vector word for word;
    and one that overflows (1), which the JAX step truncates and the
    port's step grows past: its decoded vector is the JAX step's at 4
    pairs per read, which holds every lane."""
    monkeypatch.setenv("BMTPU_DEVICE_FINE", "1")
    cfg, index, sim = _tiny_world(repeats=True)
    B = 64
    codes, quals, lengths = _batch(sim, cfg, B)
    lengths[-3:] = 0
    jm = JaxMapper(index, batch_size=B, pairs_per_read=ppr, vote_chunk=32)
    want = np.asarray(jax.device_get(jm.step(codes, quals, lengths)))
    dm = DeviceMapper(port_index(index), "cpu", batch_size=B,
                      pairs_per_read=ppr, vote_chunk=32, coarse_path="staged")
    got = dm.step(codes, quals, lengths).numpy()
    if ppr == 1:
        assert want[1] > jm.lane_budget       # the JAX step overflowed
        jm = JaxMapper(index, batch_size=B, pairs_per_read=4, vote_chunk=32)
        want = np.asarray(jax.device_get(jm.step(codes, quals, lengths)))
        assert want[1] <= jm.lane_budget and want[0] <= jm.out_cap
        host, jhost = dm.decode_out(got), jm.decode_out(want)
        for key in ("lane_read", "lane_rc", "lane_bucket", "offset",
                    "votes", "counts", "local_valid", "n_accept"):
            np.testing.assert_array_equal(host[key], jhost[key],
                                          err_msg=key)
        assert host["total_valid"] == jhost["total_valid"]
    else:
        np.testing.assert_array_equal(got, want)
    assert want[0] > 0
