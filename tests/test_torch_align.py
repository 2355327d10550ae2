"""The torch port's align stage against the JAX package's, exactly
(tolerance 0: every value is an integer).

Inputs are made with numpy from fixed seeds and fed to both packages:
band geometry and query packing, window extraction at the bucket edges,
the forward DP against the Pallas kernel in interpret mode, the fused
DP + run-jump traceback + RLE against the JAX run traceback, and the
whole aligner (packed ops, CIGARs, the device-RLE vector, the overflow
fallback and the size_t-wrap rows)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.ops import align as jax_align
from bucketmap_tpu.sim.simulator import random_genome
from bucketmap_tpu_torch.ops import align
from test_torch_host import port_index

CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=8)


@pytest.fixture(scope="module")
def world():
    genome = random_genome(120_000, seed=41, n_refs=2)
    index = build_index(genome, CFG)
    bp = np.asarray(index.buckets_packed)
    shifts = np.arange(16, dtype=np.uint32) * 2
    bases = ((bp[:, :, None] >> shifts[None, None, :]) & 3).reshape(
        index.n_buckets, -1).astype(np.uint8)
    return index, bases


def test_band_geometry_and_pack_qcodes_match_jax():
    for q in (1, 16, 63, 64, 100, 150, 192, 255, 256, 300, 304, 320, 600,
              1000, 2000):
        for rate in (0.0, 0.01, 0.02, 0.05, 0.1, 0.2):
            assert align.band_geometry(q, rate) == \
                jax_align.band_geometry(q, rate), (q, rate)
    assert align.band_geometry(300, 0.02) == (48, 16)
    rng = np.random.default_rng(0)
    for q in (1, 15, 16, 17, 150, 304):
        codes = rng.integers(0, 4, (7, q), dtype=np.uint8)
        np.testing.assert_array_equal(align.pack_qcodes(codes),
                                      jax_align.pack_qcodes(codes))


@pytest.mark.parametrize("wmax", [182, 352, 460])
def test_extract_windows_match_jax(world, wmax):
    index, _ = world
    lb = index.buckets_packed.shape[1] * 16
    offs = np.array([-3, 0, 1, 15, 16, 17, 127, 128, 2049, lb - wmax - 40,
                     lb - wmax, lb - wmax + 5, lb - 40, lb - 1, lb + 7],
                    np.int32)
    bids = (np.arange(len(offs), dtype=np.int32) * 5) % index.n_buckets
    ref = jax_align.BandedAligner(index, pair_batch=16)
    want = np.asarray(ref._extract_windows(
        ref.buckets_tiled, jnp.asarray(bids), jnp.asarray(offs), wmax))
    port = align.BandedAligner(port_index(index), "cpu", pair_batch=16)
    got = port._extract_windows(torch.from_numpy(bids),
                                torch.from_numpy(offs), wmax)
    np.testing.assert_array_equal(got.numpy(), want)


def _mutate(rng, frag, n_edits):
    frag = frag.copy()
    for _ in range(n_edits):
        p = int(rng.integers(len(frag)))
        r = rng.random()
        if r < 0.5:
            frag[p] = (frag[p] + 1 + rng.integers(3)) % 4
        elif r < 0.75:
            frag = np.concatenate([frag[:p], [rng.integers(4)], frag[p:-1]])
        else:
            frag = np.concatenate([frag[:p], frag[p + 1:], [rng.integers(4)]])
    return frag.astype(np.uint8)


def _dp_inputs(bases, Q, rate, P, seed):
    """(textp (P, lo+Q+band) uint8, qcodes (P, Q) uint8, qlen, width, band,
    lo): half real windows with a mutated copy as the query, half random;
    varied qlen, one qlen == 0, some windows cut short."""
    band, lo = align.band_geometry(Q, rate)
    rng = np.random.default_rng(seed)
    W = lo + Q + band
    textp = np.full((P, W), 4, np.uint8)
    qcodes = rng.integers(0, 4, (P, Q), dtype=np.uint8)
    qlen = rng.integers(Q // 2, Q + 1, P).astype(np.int32)
    qlen[:P // 4] = Q
    qlen[7] = 0
    width = np.minimum(qlen + 1 + (rate * qlen).astype(np.int64), Q + band)
    cut = rng.random(P) < 0.15
    width = np.where(cut, rng.integers(-2, Q + 2, P), width).astype(np.int32)
    for p in range(P):
        w = max(0, int(width[p]))
        if p % 2 == 0:
            b = int(rng.integers(bases.shape[0]))
            o = int(rng.integers(0, bases.shape[1] - Q - band))
            text = bases[b, o:o + w]
            if qlen[p]:
                qcodes[p, :qlen[p]] = _mutate(rng, bases[b, o:o + qlen[p]],
                                              int(rng.integers(0, 6)))
        else:
            text = rng.integers(0, 4, w, dtype=np.uint8)
        textp[p, lo:lo + w] = text
    return textp, qcodes, qlen, width, band, lo


@pytest.mark.parametrize("Q,rate", [(150, 0.02), (300, 0.02), (256, 0.1)])
def test_dp_fwd_plain_matches_pallas(world, Q, rate):
    _, bases = world
    P = 130
    textp, qcodes, qlen, width, band, lo = _dp_inputs(bases, Q, rate, P,
                                                      seed=Q)
    assert (band, lo) == {150: (32, 16), 300: (48, 16), 256: (128, 32)}[Q]
    Pp = 256
    pad = ((0, 0), (0, Pp - P))
    dirs_t, final_t = jax_align._dp_fwd_pallas(
        jnp.pad(jnp.asarray(textp.T, jnp.int32), pad, constant_values=4),
        jnp.pad(jnp.asarray(qcodes.T, jnp.int32), pad),
        jnp.pad(jnp.asarray(qlen[None, :]), pad, constant_values=1),
        jnp.pad(jnp.asarray(width[None, :]), pad, constant_values=1),
        band=band, lo=lo, interpret=True)
    dirs, final = align.dp_fwd(torch.from_numpy(textp),
                               torch.from_numpy(qcodes),
                               torch.from_numpy(qlen), torch.from_numpy(width),
                               band, lo)
    assert dirs.shape == (Q + 1, P, band) and dirs.dtype == torch.uint8
    assert final.shape == (P, band) and final.dtype == torch.int32
    np.testing.assert_array_equal(
        dirs.numpy(), np.asarray(dirs_t)[:, :, :P].transpose(0, 2, 1))
    np.testing.assert_array_equal(final.numpy(), np.asarray(final_t)[:, :P].T)
    # the inputs reach every direction and the 63 run cap
    codes = dirs.numpy() & 3
    assert {0, 1, 2, 3} <= set(np.unique(codes).tolist())
    assert (dirs.numpy() >> 2).max() == 63


def test_dp_fwd_refuses_a_non_cuda_device():
    t = torch.zeros((4, 64), dtype=torch.uint8, device="meta")
    q = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    n = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        align.dp_fwd(t, q, n, n, 32, 16)


def test_dp_runs_refuses_a_non_cuda_device():
    t = torch.zeros((4, 64), dtype=torch.uint8, device="meta")
    q = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    n = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        align.dp_runs(t, q, n, n, 32, 16, True)


def _pairs(world, n, seed, garbage=0.0):
    """n (query, bucket, offset, strand) pairs: mutated genome fragments of
    varied length, some at the packed bucket end, some reverse strand,
    a share of random (garbage) queries."""
    index, bases = world
    rng = np.random.default_rng(seed)
    Q = CFG.read_len
    lb = bases.shape[1]
    buckets = rng.integers(0, index.n_buckets, n).astype(np.int32)
    offsets = rng.integers(1, 3000, n).astype(np.int32)
    offsets[::9] = lb - rng.integers(60, 200, len(offsets[::9]))
    is_rc = rng.random(n) < 0.5
    qlen = np.where(rng.random(n) < 0.7, Q, rng.integers(100, Q, n))
    qlen = qlen.astype(np.int32)
    qcodes = np.zeros((n, Q), np.uint8)
    for i in range(n):
        frag = bases[buckets[i], offsets[i]:offsets[i] + qlen[i]]
        frag = np.concatenate([frag, rng.integers(0, 4, qlen[i] - len(frag))])
        frag = _mutate(rng, frag.astype(np.uint8), int(rng.integers(0, 6)))
        if rng.random() < garbage:
            frag = rng.integers(0, 4, qlen[i]).astype(np.uint8)
        if is_rc[i]:
            frag = (3 - frag[::-1]).astype(np.uint8)
        qcodes[i, :qlen[i]] = frag
    return qcodes, qlen, buckets, offsets, is_rc


def _aligners(index, pair_batch, rate=None):
    if rate is not None:
        index = dataclasses.replace(index, config=dataclasses.replace(
            index.config, indel_rate=rate))
    return (jax_align.BandedAligner(index, pair_batch=pair_batch),
            align.BandedAligner(port_index(index), "cpu",
                                pair_batch=pair_batch))


def _run_pairs(world, Q, n, seed):
    """n forward or reverse pairs of query width Q for the run traceback:
    mutated genome fragments (qlen Q/2..Q), random queries, every fifth
    row a query that inserts one base after every two of its window from
    text position 80 on (one run per base and a half: more than
    MAX_ROW_RUNS at Q 256), and windows at the bucket end too short for
    the query (no valid end cell: the traceback cannot move)."""
    index, bases = world
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, index.n_buckets, n).astype(np.int32)
    offsets = rng.integers(1, 3000, n).astype(np.int32)
    is_rc = rng.random(n) < 0.4
    qlen = np.where(rng.random(n) < 0.6, Q, rng.integers(Q // 2, Q, n))
    qlen = qlen.astype(np.int32)
    qcodes = np.zeros((n, Q), np.uint8)
    for i in range(n):
        text = bases[buckets[i], offsets[i]:offsets[i] + 2 * Q]
        if i % 5 == 4:
            is_rc[i], qlen[i] = False, Q
            a = 80 + 2 * np.arange(Q // 3 + 1)
            frag = np.stack([text[a], text[a + 1], (text[a + 1] + 2) % 4],
                            1).reshape(-1)[:Q]
        elif i % 5 == 3:
            frag = rng.integers(0, 4, qlen[i])
        else:
            frag = _mutate(rng, text[:qlen[i]], int(rng.integers(0, 8)))
            if is_rc[i]:
                frag = 3 - frag[::-1]
        qcodes[i, :qlen[i]] = frag
    offsets[2::10] = bases.shape[1] - rng.integers(20, Q // 2,
                                                   len(offsets[2::10]))
    return qcodes, qlen, buckets, offsets, is_rc


def _merged_runs(ops, lens):
    """Runs in query order of one row's run jumps (traceback order), the
    jumps of one op next to each other merged: [(op, length), ...]."""
    runs = []
    for op, n in zip(ops[::-1].tolist(), lens[::-1].tolist()):
        if op == 0:
            continue
        if runs and runs[-1][0] == op:
            runs[-1][1] += n
        else:
            runs.append([op, n])
    return [tuple(r) for r in runs]


@pytest.mark.parametrize("wrap_star", [True, False])
@pytest.mark.parametrize("Q,rate", [(150, 0.02), (304, 0.02), (256, 0.1)])
def test_dp_runs_plain_matches_jax_run_traceback(world, Q, rate, wrap_star):
    """dp_runs_plain against the JAX _align_core(tb_mode="runs"): score,
    begin, unterminated, and the merged runs (the first MR in query
    order, their count, the longest kept)."""
    index, _ = world
    band, lo = align.band_geometry(Q, rate)
    assert band == {150: 32, 304: 48, 256: 128}[Q]
    args = _run_pairs(world, Q, 30, seed=Q + wrap_star)
    ref, port = _aligners(index, 32, rate)
    qcodes, qlen, buckets, offsets, is_rc = args
    width = port._width(qlen, buckets, offsets)
    sc, bg, t_op, t_len, unterm = (np.asarray(a) for a in ref._align_core(
        ref.buckets_tiled, jnp.asarray(qcodes), jnp.asarray(qlen),
        jnp.asarray(buckets), jnp.asarray(offsets), jnp.asarray(is_rc),
        jnp.asarray(width), tb_mode="runs", wrap_star=wrap_star))
    t = [torch.from_numpy(a) for a in (qlen, buckets, offsets, is_rc, width)]
    textp, band, lo = port._text_windows(Q, t[1], t[2], t[3], t[4])
    head, runs = align.dp_runs_plain(textp, torch.from_numpy(qcodes), t[0],
                                     t[4], band, lo, wrap_star)
    head, runs = head.numpy(), runs.numpy()
    MR = align.run_budget(band)[1]
    assert runs.shape == (30, MR)
    np.testing.assert_array_equal(head[0], sc)
    np.testing.assert_array_equal(head[1], bg)
    np.testing.assert_array_equal(head[4], unterm)
    longest = 0
    for i in range(30):
        want = _merged_runs(t_op[i], t_len[i])
        assert head[2, i] == len(want)
        kept = want[:MR]
        assert runs[i, :len(kept)].tolist() == [n << 2 | op for op, n in kept]
        assert not runs[i, len(kept):].any()
        assert head[3, i] == max((n for _, n in kept), default=0)
        longest = max(longest, head[3, i])
    # the inputs reach a chain split by the 63 cap, and without the wrap
    # rule an unfinished traceback and, at band 128, a row past the cap
    assert longest > 63
    assert (t_len == 63).any()
    if not wrap_star:
        assert unterm.any()
        assert band < 128 or (head[2] > MR).any()


def test_aligner_ops_and_cigars_match_jax(world):
    index, _ = world
    args = _pairs(world, 45, seed=11, garbage=0.1)
    ref, port = _aligners(index, 32)
    want = ref.align_batch(*args)
    got = port.align_batch(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (want[0] < -60).any() and (want[0] == 0).any()
    want_c = ref.align_batch_cigars(*args)
    got_c = port.align_batch_cigars(*args)
    np.testing.assert_array_equal(got_c[0], want_c[0])
    np.testing.assert_array_equal(got_c[1], want_c[1])
    assert got_c[2] == want_c[2]
    np.testing.assert_array_equal(got_c[3], want_c[3])
    assert b"I" in want_c[2] and b"D" in want_c[2]
    assert [align.ops_to_cigar(r) for r in got[2]] == \
        [jax_align.ops_to_cigar(r) for r in want[2]]


def _collect_runs(aligner, args, **kw):
    out = []

    def emit_runs(s, e, sc, bg, nr, runs, row_off):
        for i in range(e - s):
            out.append((int(sc[i]), int(bg[i]), int(nr[i]),
                        runs[row_off[i]:row_off[i + 1]].tolist()))

    aligner.align_batch_runs_stream(*args, emit_runs, **kw)
    return out


@pytest.mark.parametrize("wrap_star", [True, False])
@pytest.mark.parametrize("cap", [None, 1])
def test_runs_stream_matches_jax(world, wrap_star, cap):
    """Device-RLE runs with the default budget and a forced overflow
    (run_cap_per_pair=1, the packed-ops fallback), with and without the
    size_t-wrap rule for rows scoring below -60."""
    index, _ = world
    args = _pairs(world, 40, seed=5, garbage=0.3)
    ref, port = _aligners(index, 32)
    want = _collect_runs(ref, args, run_cap_per_pair=cap, wrap_star=wrap_star)
    got = _collect_runs(port, args, run_cap_per_pair=cap, wrap_star=wrap_star)
    assert got == want
    low = [w for w in want if w[0] < -60]
    assert low
    if wrap_star:
        assert all(w[2] == 0 for w in low)
    else:
        assert any(w[2] > 0 for w in low)


@pytest.mark.parametrize("Q,run_cap", [(150, 256), (150, 8), (304, 64),
                                       (256, 64)])
def test_runs_vector_matches_jax_word_for_word(world, Q, run_cap):
    """Q 150 and 304 at the default indel rate (bands 32 and 48); Q 256 at
    rate 0.1 (band 128) with rows past MAX_ROW_RUNS."""
    index, _ = world
    rate = 0.1 if Q == 256 else None
    if rate:
        qcodes, qlen, buckets, offsets, is_rc = _run_pairs(world, Q, 32,
                                                           seed=Q + run_cap)
    else:
        qcodes, qlen, buckets, offsets, is_rc = _pairs(
            world, 32, seed=Q + run_cap, garbage=0.2)
        qcodes = np.pad(qcodes, ((0, 0), (0, Q - qcodes.shape[1])))
    ref, port = _aligners(index, 32, rate)
    width = port._width(qlen, buckets, offsets)
    qp = align.pack_qcodes(qcodes)
    want = np.asarray(ref._align_runs(
        ref.buckets_tiled, jnp.asarray(qp), jnp.asarray(qlen),
        jnp.asarray(buckets), jnp.asarray(offsets), jnp.asarray(is_rc),
        jnp.asarray(width), run_cap=run_cap, wrap_star=False))
    got = port._align_runs(
        torch.from_numpy(qp.view(np.int32)), torch.from_numpy(qlen),
        torch.from_numpy(buckets), torch.from_numpy(offsets),
        torch.from_numpy(is_rc), torch.from_numpy(width), run_cap=run_cap,
        wrap_star=False)
    np.testing.assert_array_equal(got.numpy(), want)
    if run_cap == 8:
        assert want[0] > run_cap      # the overflow the header flags
    if rate:
        assert want[1] > align.MAX_ROW_RUNS and want[3] > 0
