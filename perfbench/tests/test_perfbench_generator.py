"""The frozen generators: the genome equals the program's generator's,
and the read draw repeats for a seed, keeps its truth and its rates."""

import numpy as np
import pytest

from core import genome as G
from core import reads as R

SEED = 2_147_483_659          # past 32 signed bits


@pytest.fixture(scope="module")
def world():
    recs = G.repeat_genome(3_000_000, seed=1, n_refs=2)
    g = G.Genome([n for n, _ in recs], [len(c) for _, c in recs],
                 [G.pack_2bit(c) for _, c in recs])
    return recs, g, g.buckets(65536, 300)


TRAFFIC = {"pool": 20000, "read_len": 300, "substitution_rate": 0.002,
           "insertion_rate": 0.00025, "deletion_rate": 0.00025,
           "revcomp_share": 0.5, "quality": "E"}


def test_genome_is_the_programs(world):
    from bucketmap_tpu_torch.sim.simulator import repeat_genome
    recs, g, _ = world
    theirs = repeat_genome(3_000_000, seed=1, n_refs=2)
    for (n, c), t, w in zip(recs, theirs, g.words):
        assert n == t.id and np.array_equal(c, t.codes)
        assert np.array_equal(G.unpack_range(w, 17, len(c) - 5),
                              c[17:len(c) - 5])


def test_draw_repeats_for_a_seed(world):
    _, g, lay = world
    a = R.draw(g, lay, 65536, TRAFFIC, SEED, 64)
    b = R.draw(g, lay, 65536, TRAFFIC, SEED, 64)
    c = R.draw(g, lay, 65536, TRAFFIC, SEED + 1, 64)
    assert np.array_equal(a.buf, b.buf) and np.array_equal(a.sample, b.sample)
    assert not np.array_equal(a.truth_pos, c.truth_pos)


def test_truth_rates_and_names(world):
    recs, g, lay = world
    pool = R.draw(g, lay, 65536, TRAFFIC, SEED, 64)
    n = pool.n
    # the FASTQ bytes parse back into the reads, named by instance
    text = pool.buf.tobytes().split(b"\n")
    assert len(text) == 4 * n + 1 and text[-1] == b""
    assert text[0] == b"@" + pool.name(0, 0)
    assert text[4 * 7] == b"@" + pool.name(7, 7)
    assert int(text[4 * 7][1:]) == 7
    # every record has one size: the names of shorter reads are longer
    assert len(set(len(text[4 * i]) + 2 * len(text[4 * i + 1])
                   for i in range(n))) == 1
    seqs = text[1::4]
    assert all(len(s) == L for s, L in zip(seqs[:500], pool.lengths[:500]))
    assert set(text[3]) == {ord("E")}
    pool.set_names(3, 0, n)
    assert pool.buf[1:pool.record].tobytes().split(b"\n")[0] == \
        pool.name(0, 3 * n)
    # a slice renamed for the next pass, its neighbours left as they were
    pool.set_names(4, 5, 9)
    names = pool.buf.tobytes().split(b"\n")[0:4 * 10:4]
    assert names == [b"@" + pool.name(i, (4 if 5 <= i < 9 else 3) * n + i)
                     for i in range(10)]
    # reads of full length: the genome at the truth, once reverse-
    # complemented where the truth says so, with ~0.2% substitutions
    code = {ord(c): i for i, c in enumerate("ACGT")}
    full = np.flatnonzero(pool.lengths == 300)[:3000]
    mism = []
    for i in full:
        r = np.array([code[x] for x in seqs[i]], np.uint8)
        if pool.truth_rc[i]:
            r = G.revcomp_codes(r)
        p = pool.truth_pos[i] - 1
        ref = recs[pool.truth_ref[i]][1]
        mism.append(int((ref[p:p + 300] != r).sum()))
    mism = np.asarray(mism)
    # an insertion and a deletion in one read keep its length but shift
    # it: those few reads are left out
    assert (mism > 20).mean() < 0.01
    rate = mism[mism <= 20].mean() / 300
    assert 0.0012 < rate < 0.0030
    # about 15% of reads carry an indel, and half are reverse strands
    assert 0.11 < (pool.lengths != 300).mean() < 0.16
    assert 0.47 < pool.truth_rc.mean() < 0.53
    assert abs(pool.lengths.mean() - 300) < 0.05
