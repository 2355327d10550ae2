"""The torch port's fine stage against the JAX package, exactly:

  * tally_plain (the tally kernel's plain version) against
    _tally_pallas_call in interpret mode and the jnp fori_loop tally;
  * fine_window_plain (the fine-window kernel's plain version) against
    _fine_window_pallas in interpret mode, on globally sorted windows;
  * the port's FineLocator (sampling and the tiled packed vote) against
    the JAX FineLocator on the tiled table;
  * fine_search_plain (the fine-search kernel's plain version: the tiled
    vote from a chunk's lanes to the tally's arguments) against the JAX
    tiled vote's pre-tally arrays, and (on chip_smoke's made table, whose
    segments need one to three of the fine-search kernel's ballot rounds)
    against the first equal-low slots of each segment found directly.
"""

import sys

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
from bucketmap_tpu_torch.ops.vote import (FineLocator, fine_search,
                                          fine_search_plain, fine_window_plain,
                                          locator_sample_tab, tally_plain,
                                          targets)
from test_torch_host import REPO, port_index


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


def _vote_world(kind, p=10):
    cfg = MapperConfig(bucket_len=2048, read_len=150, query_seed=12,
                       locator_samples=p)
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


def _vote_reads(kind, cfg, genome, rng, n):
    """n reads of the vote world: (codes, seg_len, bucket_ids, is_rc);
    simulated in their buckets (random), or copied from the genome
    (tandem, forward, is_rc random)."""
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
    return codes, seg_len, bucket_ids, is_rc


@pytest.mark.parametrize("kind", ["random", "tandem"])
def test_tiled_vote_matches_jax(kind):
    cfg, genome, index = _vote_world(kind)
    rng = np.random.default_rng(7)
    n = 48
    codes, seg_len, bucket_ids, is_rc = _vote_reads(kind, cfg, genome, rng,
                                                    n)
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


@pytest.mark.parametrize("kind,p", [("random", 10), ("tandem", 10),
                                    ("tandem", 20)])
def test_fine_search_plain_matches_jax(kind, p):
    """fine_search_plain word for word against the JAX tiled vote's
    pre-tally arrays: _vote_packed_impl run eagerly, its _tally returning
    its arguments, which are flipped and flattened as the tally does. The
    lanes index the reads' samples as the step's lanes do: each read on
    its own bucket and strand, on the other strand, on another bucket
    (empty prefix segments), and lanes past n_valid repeating lane 0 (read
    0, forward, lane 0's bucket). The tandem world's poly-A bucket makes
    prefix segments of ~2,000 slots, so the narrowing probes matter."""
    cfg, genome, index = _vote_world(kind, p)
    k, O = cfg.query_seed, JaxFine.MAX_OCC
    host = build_index(genome, cfg)
    build_fine_index(host)
    fp, pt = _retile(np.asarray(host.fine_packed)), np.asarray(host.fine_ptab)
    steps, low_bits = host.fine_search_steps, host.fine_low_bits
    rng = np.random.default_rng(40 + p)
    S = 24
    codes, seg_len, bucket_ids, is_rc = _vote_reads(kind, cfg, genome, rng, S)
    quals = np.full((S, cfg.read_len), 36, np.uint8)
    jfl = JaxFine(index)
    jfl.fine_packed, jfl.fine_ptab = jnp.asarray(fp), jnp.asarray(pt)
    jfl.search_steps, jfl.low_bits = steps, low_bits
    sh, si = jfl.prepare(codes, quals, seg_len)

    reads = np.arange(S)
    other = rng.integers(0, S, 8)
    tail = np.zeros(8, np.int64)
    lane_read = np.concatenate([reads, reads, other, tail])
    vote_bucket = np.concatenate([
        bucket_ids, bucket_ids, rng.integers(0, index.n_buckets, 8),
        np.full(8, bucket_ids[0])]).astype(np.int32)
    lane_rc = np.concatenate([is_rc, ~is_rc, rng.random(8) < 0.5,
                              np.zeros(8, bool)])
    P = len(lane_read)

    jfl._tally = lambda prop, valid, rc: (prop, valid)
    prop, valid = (np.asarray(a) for a in jfl._vote_packed_impl(
        jnp.asarray(pt), jnp.asarray(fp), jnp.asarray(vote_bucket),
        jnp.asarray(lane_rc), jnp.asarray(sh[lane_read]),
        jnp.asarray(si[lane_read]), jnp.asarray(seg_len[lane_read])))
    rc3 = lane_rc[:, None, None]
    want_prop = np.where(rc3, prop[:, ::-1], prop).reshape(P, p * O)
    want_valid = np.where(rc3, valid[:, ::-1], valid).reshape(P, p * O)

    args = (torch.from_numpy(fp.view(np.int32)), torch.from_numpy(pt),
            torch.from_numpy(vote_bucket.astype(np.int64)),
            torch.from_numpy(lane_rc), torch.from_numpy(lane_read),
            torch.from_numpy(sh.astype(np.int64)),
            torch.from_numpy(si.astype(np.int64)), torch.from_numpy(seg_len),
            k, low_bits, steps)
    got_prop, got_valid = fine_search_plain(*args)
    np.testing.assert_array_equal(got_prop.numpy(), want_prop.astype(np.int32))
    np.testing.assert_array_equal(got_valid.numpy(),
                                  want_valid.astype(np.int32))
    for a, b in zip(fine_search(*args), (got_prop, got_valid)):
        assert torch.equal(a, b)

    # what the lanes cover: empty segments, full runs, both strands, and
    # (tandem) segments deeper than the 128 slots the window starts from
    tgt, _ = targets(args[3], args[5][lane_read], args[6][lane_read],
                     args[7][lane_read], k)
    pre = (tgt >> low_bits).numpy()
    seg = pt[vote_bucket[:, None], pre + 1] - pt[vote_bucket[:, None], pre]
    assert (seg == 0).any() and lane_rc.any() and (~lane_rc).any()
    assert want_valid.any()
    if kind == "tandem":
        assert steps > 7 and seg.max() > 128
        assert want_valid.reshape(P, p, O).all(axis=2).any()


def test_fine_search_plain_finds_first_occurrences_in_deep_segments():
    """fine_search_plain on the table and lanes of chip_smoke's narrowing
    check (chip_smoke.deep_table, narrowing_lanes): segments of up to
    200,000 slots and runs of one low longer than 4,224. Each row's
    proposals must be the first O slots of its segment whose low bits
    equal its target's, found by a direct search of the bucket's sorted
    keys, as pos - tgt_idx (0 - tgt_idx where invalid), the sample axis
    flipped for reverse-complement lanes."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    from bucketmap_tpu_torch.ops.encoding import revcomp_hash

    k = lb = 12
    p, O = 10, 8
    fp, pt, steps = chip_smoke.deep_table(torch, torch.device("cpu"), lb)
    lanes, rows = chip_smoke.narrowing_lanes(torch, fp, pt, lb, k, p, 300,
                                             seed=5)
    assert rows["> 139,392"] and rows["first match past 384"]
    got_prop, got_valid = fine_search_plain(fp, pt, *lanes, k, lb, steps)

    bid, rc, lane_read, sh, si, lengths = (t.numpy() for t in lanes)
    P = bid.shape[0]
    slots = fp.reshape(2, -1).numpy().astype(np.int64) & 0xFFFFFFFF
    n = pt[:, -1].numpy()
    keys = np.full(slots.shape, np.iinfo(np.int64).max)
    for b in range(2):
        prefix = np.repeat(np.arange(4096), np.diff(pt[b].numpy()))
        keys[b, :n[b]] = (prefix << lb) | (slots[b, :n[b]] & ((1 << lb) - 1))
    tgt = np.where(rc[:, None], revcomp_hash(torch.from_numpy(sh[lane_read]),
                                             k).numpy(), sh[lane_read])
    tgt_idx = np.where(rc[:, None], 300 - k - si[lane_read], si[lane_read])
    first = np.stack([np.searchsorted(keys[b], t) for b, t in zip(bid, tgt)])
    at = np.minimum(first[:, :, None] + np.arange(O), slots.shape[1] - 1)
    valid = keys[bid[:, None, None], at] == tgt[:, :, None]
    prop = np.where(valid, slots[bid[:, None, None], at] >> lb, 0) \
        - tgt_idx[:, :, None]
    rc3 = rc[:, None, None]
    want_prop = np.where(rc3, prop[:, ::-1], prop).reshape(P, p * O)
    want_valid = np.where(rc3, valid[:, ::-1], valid).reshape(P, p * O)
    np.testing.assert_array_equal(got_valid.numpy(),
                                  want_valid.astype(np.int32))
    np.testing.assert_array_equal(got_prop.numpy(), want_prop.astype(np.int32))
    assert want_valid.reshape(P, p, O).all(axis=2).any()


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

    def meta_as(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        fine_search(meta(4, 3, 128), meta(4, 4097),
                    meta_as(torch.int64, 16), meta_as(torch.bool, 16),
                    meta_as(torch.int64, 16), meta_as(torch.int64, 8, 10),
                    meta_as(torch.int64, 8, 10), meta(8), 12, 12, 11)
