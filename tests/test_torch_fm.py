"""The port's FM-index family against the JAX package's, exactly: suffix
arrays and index arrays, the batched device search lane for lane (empty
ranges included), the artifacts read across packages both ways, the
bidirectional index, the verification DP, locate, the mapper and the
locator. All on the CPU; the CUDA entry points refuse a missing card."""

import dataclasses

import numpy as np
import pytest
import torch

from bucketmap_tpu.config import MapperConfig as JaxConfig
from bucketmap_tpu.index import fm as jfm
from bucketmap_tpu.io.fasta import FastaRecord as JaxRecord
from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index import fm
from bucketmap_tpu_torch.io.fasta import FastaRecord

ARRAYS = ("bwt", "occ", "counts", "sa_ranks", "sa_vals", "ref_offsets")


def _rand_text(n, seed=0):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _records(text, cuts, pkg_record):
    bounds = [0, *cuts, len(text)]
    return [pkg_record(f"chr{i} desc", text[a:b].copy())
            for i, (a, b) in enumerate(zip(bounds, bounds[1:]))]


def _builds(text, cuts=()):
    return (fm.FMIndex.build(_records(text, cuts, FastaRecord)),
            jfm.FMIndex.build(_records(text, cuts, JaxRecord)))


def assert_same_fm(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.n == b.n and a.ref_names == b.ref_names


@pytest.mark.parametrize("n,cuts,seed", [(1, (), 1), (2, (), 0), (31, (), 2),
                                         (300, (), 3), (2000, (700,), 4),
                                         (5003, (1000, 4000), 5)])
def test_suffix_array_and_build_match(n, cuts, seed):
    text = _rand_text(n, seed)
    np.testing.assert_array_equal(fm.suffix_array(text),
                                  jfm.suffix_array(text))
    assert_same_fm(*_builds(text, cuts))


def _patterns(text, B, m, seed):
    """Present, absent, errored and odd lanes, ragged lengths (0..m+2)."""
    rng = np.random.default_rng(seed)
    pats = np.zeros((B, m), np.uint8)
    lens = np.zeros(B, np.int64)
    for i in range(B):
        ln = int(rng.integers(0, m + 3))
        w = min(ln, m)
        s = int(rng.integers(0, len(text) - m))
        pats[i, :w] = text[s:s + w]
        kind = i % 4
        if kind == 1:                          # random: mostly absent
            pats[i] = rng.integers(0, 4, m)
        elif kind == 2 and w:                  # one substitution
            p = int(rng.integers(0, w))
            pats[i, p] = (pats[i, p] + 1) % 4
        lens[i] = ln
    pats[3, :3] = (4, 7, 255)                  # codes past the alphabet
    return pats, lens


@pytest.mark.parametrize("B,m,seed", [(64, 12, 6), (48, 40, 7)])
def test_exact_search_batch_matches_jax(B, m, seed):
    text = _rand_text(3000, seed)
    port, ref = _builds(text, (1200,))
    pats, lens = _patterns(text, B, m, seed)
    lo, hi = fm.exact_search_batch(port, pats, lens, device="cpu")
    jlo, jhi = jfm.exact_search_batch(ref, pats, lens)
    assert lo.dtype == hi.dtype == np.int64
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    # only non-empty ranges are the scalar search's: an emptied lane
    # keeps stepping, backward_search stops at (lo, lo); a lane longer
    # than m rereads its last column, and lane 3 holds odd codes
    nonempty = [i for i in range(B)
                if lo[i] < hi[i] and lens[i] <= m and i != 3]
    assert len(nonempty) > B // 4
    for i in nonempty:
        want = port.backward_search(pats[i, :lens[i]])
        assert (lo[i], hi[i]) == want == ref.backward_search(
            pats[i, :lens[i]])
    assert "cpu" in port._device        # the device copies are kept


@pytest.mark.parametrize("kind", ["fm_index", "bfmi"])
def test_artifacts_load_across_packages(kind, tmp_path):
    text = _rand_text(1500, 8)
    for writer, reader in (("port", "jax"), ("jax", "port")):
        d = tmp_path / writer
        d.mkdir()
        if kind == "fm_index":
            pkg = fm if writer == "port" else jfm
            rec = FastaRecord if writer == "port" else JaxRecord
            pkg.FMIndexer(bidirectional=True).index(
                _records(text, (600,), rec), d, "g")
            load = fm.BiFMIndex.load if reader == "port" \
                else jfm.BiFMIndex.load
            got = load(d, "g")
            want = jfm.BiFMIndex.build(_records(text, (600,), JaxRecord))
            for a, b in ((got.fwd, want.fwd), (got.rev, want.rev)):
                assert_same_fm(a, b)
        else:
            cfgs = {"port": MapperConfig(bucket_len=256, read_len=40),
                    "jax": JaxConfig(bucket_len=256, read_len=40)}
            pkg = fm if writer == "port" else jfm
            rec = FastaRecord if writer == "port" else JaxRecord
            n = pkg.BucketFMIndexer(cfgs[writer]).index(
                _records(text, (600,), rec), d, "g")
            rpkg = fm if reader == "port" else jfm
            got = rpkg.BucketFMIndexer.load(cfgs[reader], d, "g")
            want = jfm.BucketFMIndexer(cfgs["jax"])
            want.index(_records(text, (600,), JaxRecord), tmp_path, "w")
            assert n == len(got.buckets) == len(want.buckets)
            for a, b in zip(got.buckets, want.buckets):
                assert_same_fm(a, b)


def test_bidirectional_states_match():
    text = _rand_text(800, 9)
    port = fm.BiFMIndex.build([FastaRecord("r", text)])
    ref = jfm.BiFMIndex.build([JaxRecord("r", text)])
    rng = np.random.default_rng(9)
    for s in (100, 450, 700):
        pat = text[s:s + 10]
        a, b = port.init_range(), ref.init_range()
        assert a == b
        mid = int(rng.integers(0, 10))
        steps = ([("l", pat[mid])] + [("r", c) for c in pat[mid + 1:]]
                 + [("l", c) for c in pat[:mid][::-1]] + [("r", 2), ("l", 1)])
        for side, c in steps:
            ext = "extend_left" if side == "l" else "extend_right"
            a = getattr(port, ext)(a, int(c))
            b = getattr(ref, ext)(b, int(c))
            assert a == b


def test_semiglobal_edit_and_locate_match():
    rng = np.random.default_rng(10)
    for _ in range(20):
        w = rng.integers(0, 4, int(rng.integers(1, 60))).astype(np.uint8)
        r = rng.integers(0, 4, int(rng.integers(1, 20))).astype(np.uint8)
        assert fm.semiglobal_edit(r, w) == jfm.semiglobal_edit(r, w)
    text = _rand_text(2500, 11)
    port, ref = _builds(text, (900,))
    for plen in (3, 6, 12):
        s = int(rng.integers(0, len(text) - plen))
        lo, hi = port.backward_search(text[s:s + plen])
        np.testing.assert_array_equal(port.locate(lo, hi),
                                      ref.locate(lo, hi))
        np.testing.assert_array_equal(port.locate(lo, hi, limit=3),
                                      ref.locate(lo, hi, limit=3))
        np.testing.assert_array_equal(port.find_all(text[s:s + plen]),
                                      ref.find_all(text[s:s + plen]))
    pos = np.array([0, 10, 899, 900, 2499])
    for a, b in zip(port.pos_to_ref(pos), ref.pos_to_ref(pos)):
        np.testing.assert_array_equal(a, b)


def _errored_reads(text, B, L, seed):
    rng = np.random.default_rng(seed)
    codes = np.zeros((B, L), np.uint8)
    lens = np.full(B, L, np.int64)
    starts = np.zeros(B, np.int64)
    for i in range(B):
        s = starts[i] = int(rng.integers(0, len(text) - L))
        read = text[s:s + L].copy()
        for _ in range(i % 3):                 # 0, 1 or 2 substitutions
            p = int(rng.integers(0, L))
            read[p] = (read[p] + 1) % 4
        codes[i] = read
        lens[i] = L - (i % 5 == 4) * 7         # some shorter reads
    return codes, lens, starts


def _found_at_truth(hits, starts, ref_offsets):
    """Every read with at most one substitution (i % 3 < 2) has a hit
    within one base of where it was cut."""
    for i, row in enumerate(hits):
        if i % 3 < 2:
            assert any(abs(ref_offsets[r] + p - starts[i]) <= 1
                       for r, p, _ in row), (i, row, starts[i])


def _hits(hits):
    return [[dataclasses.astuple(h) for h in row] for row in hits]


def test_mapper_hits_match():
    text = _rand_text(5000, 12)
    port, ref = _builds(text, (2600,))
    codes, lens, starts = _errored_reads(text, 18, 60, 12)
    got = []
    for pkg, idx, kw in ((fm, port, {"device": "cpu"}), (jfm, ref, {})):
        mapper = pkg.FMIndexMapper(idx, max_errors=1, **kw)
        mapper.text = text
        got.append(_hits(mapper.map_reads(codes, lens)))
    assert got[0] == got[1]
    _found_at_truth(got[0], starts, port.ref_offsets)


def test_locator_end_to_end_matches(tmp_path):
    text = _rand_text(3000, 13)
    codes, lens, starts = _errored_reads(text, 8, 60, 13)
    got = []
    for pkg, rec, kw in ((fm, FastaRecord, {"device": "cpu"}),
                         (jfm, JaxRecord, {})):
        loc = pkg.FMIndexLocator(max_errors=1, **kw)
        d = tmp_path / pkg.__name__.split(".")[0]
        d.mkdir()
        loc.initialize([rec("chrA", text)], d, "g")
        got.append(_hits(loc.locate(codes, lens)))
        assert (d / "g.fm_index.npz").exists()
    assert got[0] == got[1]
    _found_at_truth(got[0], starts, np.zeros(1, np.int64))


def test_cuda_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    text = _rand_text(500, 14)
    idx = fm.FMIndex.build([FastaRecord("r", text)])
    pats = text[None, :10].copy()
    with pytest.raises(RuntimeError, match="cuda"):
        fm.exact_search_batch(idx, pats, np.array([10]))
    with pytest.raises(RuntimeError, match="cuda"):
        fm.FMIndexMapper(idx, max_errors=1)
    with pytest.raises(RuntimeError, match="cuda"):
        fm.FMIndexLocator(max_errors=1)
    assert idx._device == {}
