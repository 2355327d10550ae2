"""The torch port's fine stage against the JAX package, exactly:

  * tally_plain (the tally kernel's plain version) against
    _tally_pallas_call in interpret mode and the jnp fori_loop tally;
  * fine_window_plain (the fine-window kernel's plain version) against
    _fine_window_pallas in interpret mode, on globally sorted windows;
  * the port's FineLocator (sampling and the tiled packed vote) against
    the JAX FineLocator on the tiled table.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_fine_index, build_index
from bucketmap_tpu.io.fasta import FastaRecord
from bucketmap_tpu.ops.encoding import window_quality_sums
from bucketmap_tpu.ops.vote import (FineLocator as JaxFine,
                                    _fine_window_pallas, _tally_pallas_call)
from bucketmap_tpu.sim.simulator import ShortReadSimulator, random_genome
from bucketmap_tpu_torch.index.device_build import build_fine_index_on_device
from bucketmap_tpu_torch.ops.vote import (FineLocator, fine_window_plain,
                                          locator_sample_tab, tally_plain)
from test_torch_host import port_index


def _proposals(rng, P, p, O, tandem: bool):
    """Random proposals with exact ties, +-indel neighbours and, for the
    tandem shape, many near-identical proposals per sample."""
    prop = rng.integers(-300, 2000, (P, p, O)).astype(np.int32)
    valid = rng.random((P, p, O)) < 0.35
    valid[:, :, 0] |= rng.random((P, p)) < 0.9
    if tandem:
        base = rng.integers(0, 1500, (P, 1, 1))
        jitter = rng.integers(-6, 7, (P, p, O))
        close = rng.random((P, p, O)) < 0.85
        prop = np.where(close, base + jitter, prop).astype(np.int32)
    else:
        # exact repeats of a pair's first proposal: exact-merge ties
        same = rng.random((P, p, O)) < 0.3
        prop = np.where(same, prop[:, :1, :1], prop).astype(np.int32)
    is_rc = rng.random(P) < 0.5
    return prop, valid, is_rc


@pytest.mark.parametrize("tandem", [False, True])
def test_tally_plain_matches_pallas_and_jnp(tandem):
    cfg = MapperConfig(bucket_len=1024, read_len=300)
    fl = JaxFine(build_index(random_genome(8 * 1024, seed=3), cfg))
    rng = np.random.default_rng(11 + tandem)
    P, p, O = 96, cfg.locator_samples, JaxFine.MAX_OCC
    prop, valid, is_rc = _proposals(rng, P, p, O, tandem)
    flat_p = np.where(is_rc[:, None, None], prop[:, ::-1], prop).reshape(P, -1)
    flat_v = np.where(is_rc[:, None, None], valid[:, ::-1], valid).reshape(P, -1)
    args = (p, O, cfg.allowed_indel, cfg.min_vote, cfg.read_len)
    got = tally_plain(torch.from_numpy(np.ascontiguousarray(flat_p)),
                      torch.from_numpy(flat_v.astype(np.int32)), *args)
    pallas = _tally_pallas_call(jnp.asarray(flat_p),
                                jnp.asarray(flat_v.astype(np.int32)), *args,
                                interpret=True)
    fl._tally_mode = "jnp"
    ref = jax.device_get(fl._tally(jnp.asarray(prop), jnp.asarray(valid),
                                   jnp.asarray(is_rc)))
    for g, a, b, what in zip(got, pallas, ref, ("offset", "votes", "accept")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(a).astype(np.int32),
                                      err_msg=f"pallas {what}")
        np.testing.assert_array_equal(g.numpy(), np.asarray(b).astype(np.int32),
                                      err_msg=f"jnp {what}")
    assert int(got[2].sum()) > 0


def _window_case(rng, NT, R, low_bits):
    """A slot table sorted by low bits over its whole length (so every
    window is sorted, wherever it starts), with random position bits."""
    flat = np.sort(rng.integers(0, 1 << low_bits, NT * 128)).astype(np.uint32)
    flat |= rng.integers(0, 1 << 10, NT * 128).astype(np.uint32) << low_bits
    ftf = flat.reshape(NT, 128)
    frow = rng.integers(0, NT - 2, R).astype(np.int32)
    lo = rng.integers(0, 300, R).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 200, R), 384).astype(np.int32)
    lo[0], hi[0] = 5, 5                       # empty interval
    low = rng.integers(0, 1 << low_bits, R).astype(np.int32)
    for r in range(1, R, 2):                  # targets that occur
        seg = flat[frow[r] * 128 + lo[r]: frow[r] * 128 + hi[r]]
        if len(seg):
            low[r] = int(seg[len(seg) // 3] & ((1 << low_bits) - 1))
    low[3] = int(flat[frow[3] * 128 + 383] & ((1 << low_bits) - 1))
    lo[3], hi[3] = 380, 384                   # a run cut by the window end
    return ftf, frow, lo, hi, low


def _window_oracle(ftf, frow, lo, hi, low, O, low_bits):
    out = np.full((len(frow), O), 0xFFFFFFFF, np.uint32)
    mask = (1 << low_bits) - 1
    for r in range(len(frow)):
        win = ftf[frow[r]: frow[r] + 3].reshape(-1)
        hits = [i for i in range(lo[r], hi[r]) if int(win[i] & mask) == low[r]]
        for o in range(O):
            i = hits[0] + o if hits else 384
            if i < hi[r] and int(win[i] & mask) == low[r]:
                out[r, o] = win[i]
    return out


@pytest.mark.parametrize("low_bits", [12, 4])
def test_fine_window_plain_matches_pallas(low_bits):
    rng = np.random.default_rng(low_bits)
    O = 8
    ftf, frow, lo, hi, low = _window_case(rng, 40, 70, low_bits)
    got = fine_window_plain(*(torch.from_numpy(a.view(np.int32) if a.dtype ==
                                               np.uint32 else a)
                              for a in (ftf, frow, lo, hi, low)), O, low_bits)
    want = _fine_window_pallas(jnp.asarray(ftf), jnp.asarray(frow),
                               jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(low), O, low_bits, interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        _window_oracle(ftf, frow, lo, hi, low, O, low_bits))
    assert (got.numpy() != -1).any()


def _vote_world(kind):
    cfg = MapperConfig(bucket_len=2048, read_len=150, query_seed=12,
                       locator_samples=10)
    rng = np.random.default_rng(30)
    if kind == "random":
        genome = random_genome(20 * 2048, seed=20, n_refs=2)
    else:
        # tandem repeats + a poly-A stretch: deep prefix segments, MAX_OCC
        unit = rng.integers(0, 4, 37).astype(np.uint8)
        genome = [FastaRecord("rep", np.concatenate([
            np.tile(unit, 200)[: 2 * 2048], np.zeros(2048, np.uint8),
            rng.integers(0, 4, 4 * 2048).astype(np.uint8)]))]
    return cfg, genome, build_index(genome, cfg)


def _retile(fp2):
    """Host 2-D fine_packed -> the device build's (n, Tp, 128) layout."""
    n, lpos = fp2.shape
    Tp = -(-(-(-lpos // 128) + 2) // 8) * 8
    out = np.full((n, Tp * 128), 0xFFFFFFFF, np.uint32)
    out[:, :lpos] = fp2
    return out.reshape(n, Tp, 128)


@pytest.mark.parametrize("kind", ["random", "tandem"])
def test_tiled_vote_matches_jax(kind):
    cfg, genome, index = _vote_world(kind)
    rng = np.random.default_rng(7)
    n = 48
    codes = np.zeros((n, cfg.read_len), np.uint8)
    seg_len = np.full(n, cfg.read_len, np.int32)
    bucket_ids = np.zeros(n, np.int32)
    is_rc = rng.random(n) < 0.5
    if kind == "random":
        sim = ShortReadSimulator(cfg, substitution_rate=0.01, seed=22)
        sim.read(genome)
        for i in range(n):
            c, bucket, _off, rc, _ = sim.sample()
            c = c[: cfg.read_len]
            codes[i, : len(c)] = c
            seg_len[i], bucket_ids[i], is_rc[i] = len(c), bucket, rc
    else:
        flat = genome[0].codes
        starts = rng.integers(0, len(flat) - cfg.read_len, n)
        for i, s in enumerate(starts):
            codes[i] = flat[s: s + cfg.read_len]
        bucket_ids = (starts // cfg.bucket_len).astype(np.int32)
    quals = np.full((n, cfg.read_len), 36, np.uint8)
    quals[5, :40] = 2                         # some k-mers fail the gate

    host = build_index(genome, cfg)
    build_fine_index(host)
    jfl = JaxFine(index)
    jfl.fine_packed = jnp.asarray(_retile(np.asarray(host.fine_packed)))
    jfl.fine_ptab = jnp.asarray(host.fine_ptab)
    jfl.search_steps = host.fine_search_steps
    jfl.low_bits = host.fine_low_bits
    sh, si = jfl.prepare(codes, quals, seg_len)
    want = jfl.vote(bucket_ids, is_rc, sh, si, seg_len)

    tindex = port_index(index)
    fp, pt, steps, low_bits = build_fine_index_on_device(tindex, "cpu")
    assert steps == host.fine_search_steps
    tfl = FineLocator(tindex, "cpu", {
        "fine_packed": fp, "fine_ptab": pt, "search_steps": steps,
        "low_bits": low_bits,
        "locator_sample_tab": locator_sample_tab(tindex, "cpu")})
    qual_ok = window_quality_sums(quals, cfg.query_seed) \
        >= cfg.mapper_min_kmer_quality
    tsh, tsi = tfl.prepare(torch.from_numpy(codes), torch.from_numpy(qual_ok),
                           torch.from_numpy(seg_len))
    np.testing.assert_array_equal(tsh.numpy(), sh.astype(np.int64))
    np.testing.assert_array_equal(tsi.numpy(), si)
    got = tfl.vote(torch.from_numpy(bucket_ids), torch.from_numpy(is_rc),
                   tsh, tsi, torch.from_numpy(seg_len))
    for g, w, what in zip(got, want, ("offset", "votes", "accept")):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int32),
                                      err_msg=what)
    if kind == "random":
        assert int(got[2].sum()) >= n * 0.9


def test_kernel_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: the
    plain versions are for CPU tensors only."""
    from bucketmap_tpu_torch.ops.coarse import coarse_score
    from bucketmap_tpu_torch.ops.vote import fine_window, tally

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        coarse_score(meta(8, 40), meta(30, 4), 1000, 15)
    with pytest.raises(ValueError, match="CUDA"):
        fine_window(meta(16, 128), *(meta(10) for _ in range(4)), 8, 12)
    with pytest.raises(ValueError, match="CUDA"):
        tally(meta(4, 80), meta(4, 80), 10, 8, 6, 6, 300)
