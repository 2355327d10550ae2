"""The port's five vote paths against the JAX package, exactly (tolerance
0):

  * per path, the port's FineLocator (tiled, 2-D packed, prefix, sorted,
    scan) against the JAX FineLocator on the same tables, which takes its
    paths as tests/test_vote_paths.py makes it, by dropping tables; on
    random and tandem-repeat genomes at k = 8, 15 (sorted, scan) and 16
    (scan);
  * per path, the step vector against the JAX DeviceMapper's on an index
    that holds only that path's host tables, with vote_path naming the
    JAX _vote_path;
  * fine_scan_plain, the scan path's vote from a chunk's lanes, against
    the JAX scan's pre-tally arrays and the port's targets + occurrences
    + proposal_args, on the same worlds;
  * the pipeline's SAM at k = 15 and 16, defaults on both sides: the
    configurations that raised in the port before it had these paths;
  * at k = 14 over 65,536-base buckets, where the packed slots' 16
    position bits overflow, the port's own index (no fine tables, as
    the benchmark builds it): the scan path, step vector and SAM;
  * the table choice: the device-build budget, fine_build="device" where
    the packed encoding does not apply, and the option checks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _tiny_world
from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_fine_index, build_index
from bucketmap_tpu.io.fasta import FastaRecord
from bucketmap_tpu.mapper.device_pipeline import DeviceMapper as JaxMapper
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu.ops.encoding import window_quality_sums
from bucketmap_tpu.ops.vote import FineLocator as JaxFine
from bucketmap_tpu.sim.simulator import (ShortReadSimulator, random_genome,
                                         repeat_genome)
from bucketmap_tpu_torch.index.device_build import build_fine_index_on_device
from bucketmap_tpu_torch.mapper.device_pipeline import (DeviceMapper,
                                                        fine_tables_from_numpy,
                                                        host_fine_arrays)
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from bucketmap_tpu_torch.ops.encoding import kmer_hashes, unpack_2bit
from bucketmap_tpu_torch.ops.vote import (FineLocator, MAX_OCC, fine_scan,
                                          fine_scan_plain, locator_sample_tab,
                                          proposal_args, scan_occurrences,
                                          targets)
from test_torch_host import assert_same_index, port_index

# the host tables each path keeps: a path takes the first it finds
KEEP = {
    "packed": ("fine_packed", "fine_ptab", "fine_low", "fine_pos"),
    "prefix": ("fine_ptab", "fine_low", "fine_pos"),
    "sorted": ("fine_pos",),
    "scan": (),
}
FINE = ("fine_packed", "fine_ptab", "fine_low", "fine_pos")
PATHS_AT = {8: ("tiled", "packed", "prefix", "sorted", "scan"),
            15: ("sorted", "scan"), 16: ("scan",)}


def _only(index, path):
    """A copy of the index that holds only `path`'s host fine tables."""
    return dataclasses.replace(
        index, **{n: None for n in FINE if n not in KEEP[path]})


def _retile(fp2):
    """Host 2-D fine_packed -> the device build's (n, Tp, 128) layout."""
    n, lpos = fp2.shape
    Tp = -(-(-(-lpos // 128) + 2) // 8) * 8
    out = np.full((n, Tp * 128), 0xFFFFFFFF, np.uint32)
    out[:, :lpos] = fp2
    return out.reshape(n, Tp, 128)


def _vote_world(kind, k):
    """Index (host fine tables where k <= 15) and 48 pairs of reads with
    their buckets; tandem repeats and a poly-A stretch give deep prefix
    segments and more than MAX_OCC occurrences."""
    cfg = MapperConfig(bucket_len=2048, read_len=150, index_seed=min(k, 7),
                       query_seed=k, locator_samples=10)
    rng = np.random.default_rng(30 + k)
    n = 48
    codes = np.zeros((n, cfg.read_len), np.uint8)
    seg_len = np.full(n, cfg.read_len, np.int32)
    bucket_ids = np.zeros(n, np.int32)
    is_rc = rng.random(n) < 0.5
    if kind == "random":
        genome = random_genome(20 * 2048, seed=20, n_refs=2)
        sim = ShortReadSimulator(cfg, substitution_rate=0.01, seed=22)
        sim.read(genome)
        for i in range(n):
            c, bucket, _off, rc, _ = sim.sample()
            c = c[: cfg.read_len]
            codes[i, : len(c)] = c
            seg_len[i], bucket_ids[i], is_rc[i] = len(c), bucket, rc
    else:
        unit = rng.integers(0, 4, 37).astype(np.uint8)
        flat = np.concatenate([np.tile(unit, 200)[: 2 * 2048],
                               np.zeros(2048, np.uint8),
                               rng.integers(0, 4, 4 * 2048).astype(np.uint8)])
        genome = [FastaRecord("rep", flat)]
        starts = rng.integers(0, len(flat) - cfg.read_len, n)
        for i, s in enumerate(starts):
            codes[i] = flat[s: s + cfg.read_len]
        bucket_ids = (starts // cfg.bucket_len).astype(np.int32)
        seg_len[3] = 120                      # a short segment
    quals = np.full((n, cfg.read_len), 36, np.uint8)
    quals[5, :40] = 2                         # some k-mers fail the gate
    index = build_index(genome, cfg)
    if k <= 15:
        build_fine_index(index, keep_unpacked=True)
    return index, codes, quals, seg_len, bucket_ids, is_rc


@functools.lru_cache(maxsize=None)
def _vote_case(kind, k):
    """The port's index, its vote arguments (the port's samples, checked
    equal to the JAX ones), the JAX vote of every path the world has, and
    the JAX index."""
    index, codes, quals, seg_len, bucket_ids, is_rc = _vote_world(kind, k)
    jfl = JaxFine(index)
    sh, si = jfl.prepare(codes, quals, seg_len)
    args = (bucket_ids, is_rc, sh, si, seg_len)
    want = {}
    for path in ("packed", "prefix", "sorted", "scan"):
        if path in PATHS_AT[k]:
            want[path] = JaxFine(_only(index, path)).vote(*args)
    if "tiled" in PATHS_AT[k]:
        t = JaxFine(index)
        t.fine_packed = jnp.asarray(_retile(np.asarray(index.fine_packed)))
        want["tiled"] = t.vote(*args)
    for path, w in want.items():           # the JAX paths agree
        for a, b in zip(w, want["scan"]):
            np.testing.assert_array_equal(a, b, err_msg=path)
    cfg = index.config
    qual_ok = window_quality_sums(quals, cfg.query_seed) \
        >= cfg.mapper_min_kmer_quality
    tindex = port_index(index)
    port = FineLocator(tindex, "cpu", {
        "buckets_packed": torch.zeros(1, 1, dtype=torch.int32),
        "bucket_lengths": torch.zeros(1, dtype=torch.int64),
        "locator_sample_tab": locator_sample_tab(tindex, "cpu")})
    tsh, tsi = port.prepare(torch.from_numpy(codes),
                            torch.from_numpy(qual_ok),
                            torch.from_numpy(seg_len))
    np.testing.assert_array_equal(tsh.numpy(), sh.astype(np.int64))
    np.testing.assert_array_equal(tsi.numpy(), si)
    targs = (torch.from_numpy(bucket_ids), torch.from_numpy(is_rc), tsh, tsi,
             torch.from_numpy(seg_len))
    return tindex, targs, want, index


def _fine_scan_matches(kind, k):
    """fine_scan_plain through the lane interface, word for word, against
    the JAX scan (_vote_impl, jitted, its _tally returning its arguments,
    flipped and flattened as the tally does), the port's targets +
    scan_occurrences + proposal_args on the gathered samples, and the
    scan path's FineLocator.search_lanes. The lanes read the pairs'
    samples in a shuffled order, then two reads of edge samples, then
    eight padding lanes read lane 0 (read 0, forward, lane 0's bucket),
    as the step's lanes past n_valid do."""
    index, (bucket_ids, is_rc, sh, si, seg_len), want, jindex = \
        _vote_case(kind, k)
    S, p = sh.shape
    bp = torch.from_numpy(np.asarray(index.buckets_packed).view(np.int32))
    blen = torch.from_numpy(np.asarray(index.bucket_lengths).astype(np.int64))
    # two more reads whose samples are the k-mers at the edges of the
    # shortest and of a full bucket: the last one inside it (last - 2 ..
    # last), the first ones past it (padding in the row), and its first
    lb = bp.shape[1] * 16
    edge_b = torch.tensor([int(blen.argmin()), int(blen.argmax())])
    hashes = kmer_hashes(unpack_2bit(bp[edge_b], lb), k)
    last = blen[edge_b, None] - k
    at = (last + torch.arange(-2, p - 2)).clamp(0, lb - k)
    at[:, -1] = 0
    sh = torch.cat([sh, torch.gather(hashes, 1, at)])
    si = torch.cat([si, torch.arange(p).repeat(2, 1)])
    seg_len = torch.cat([seg_len, seg_len[:2]])
    perm = torch.from_numpy(np.random.default_rng(60 + k).permutation(S))
    lane_read = torch.cat([perm, torch.tensor([S, S + 1]),
                           torch.zeros(8, dtype=torch.int64)])
    vote_bucket = torch.cat([bucket_ids[perm].to(torch.int64), edge_b,
                             bucket_ids[:1].to(torch.int64).repeat(8)])
    lane_rc = torch.cat([is_rc[perm], torch.zeros(10, dtype=torch.bool)])
    P, O = lane_read.shape[0], MAX_OCC
    args = (bp, blen, vote_bucket, lane_rc, lane_read, sh, si, seg_len, k)
    got = fine_scan_plain(*args)

    jfl = JaxFine(_only(jindex, "scan"))
    jfl._tally = lambda prop, valid, rc: (prop, valid)
    rd = lane_read.numpy()
    jprop, jvalid = (np.asarray(a) for a in jax.jit(jfl._vote_impl)(
        jnp.asarray(jindex.buckets_packed), jnp.asarray(jindex.bucket_lengths),
        jnp.asarray(vote_bucket.numpy().astype(np.int32)),
        jnp.asarray(lane_rc.numpy()),
        jnp.asarray(sh.numpy()[rd].astype(np.uint32)),
        jnp.asarray(si.numpy()[rd].astype(np.int32)),
        jnp.asarray(seg_len.numpy()[rd])))
    rc3 = lane_rc.numpy()[:, None, None]
    want_prop = np.where(rc3, jprop[:, ::-1], jprop).reshape(P, p * O)
    want_valid = np.where(rc3, jvalid[:, ::-1], jvalid).reshape(P, p * O)
    np.testing.assert_array_equal(got[0].numpy(), want_prop.astype(np.int32))
    np.testing.assert_array_equal(got[1].numpy(),
                                  want_valid.astype(np.int32))

    tgt_hash, tgt_idx = targets(lane_rc, sh[lane_read], si[lane_read],
                                seg_len[lane_read], k)
    before = proposal_args(*scan_occurrences(bp, blen, vote_bucket, tgt_hash,
                                             k), tgt_idx, lane_rc)
    fl = FineLocator(index, "cpu", {
        **fine_tables_from_numpy(host_fine_arrays(_only(index, "scan")),
                                 "cpu"),
        "locator_sample_tab": locator_sample_tab(index, "cpu")})
    lanes = fl.search_lanes(vote_bucket, lane_rc, lane_read, sh, si, seg_len)
    for a, b, c, d in zip(got, before, fine_scan(*args), lanes):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    # what the lanes cover: both strands, matches, a bucket's last k-mer
    # found where it ends, and (tandem) samples with more than O
    # occurrences
    assert lane_rc.any() and (~lane_rc).any() and want_valid.any()
    edge = got[0].view(P, p, O)[S:S + 2, 2] + si[S:S + 2, 2:3]
    assert (edge == last).any()
    if kind == "tandem":
        assert want_valid.reshape(P, p, O).all(axis=2).any()


@pytest.mark.parametrize("kind,k,path", [
    (kind, k, path) for k, paths in PATHS_AT.items()
    for kind in ("random", "tandem") for path in paths + ("fine_scan",)])
def test_vote_path_matches_jax(kind, k, path):
    if path == "fine_scan":
        _fine_scan_matches(kind, k)
        return
    index, targs, want, _ = _vote_case(kind, k)
    if path == "tiled":
        fp, pt, steps, low_bits = build_fine_index_on_device(index, "cpu")
        tables = {"fine_packed": fp, "fine_ptab": pt, "search_steps": steps,
                  "low_bits": low_bits}
    else:
        tables = fine_tables_from_numpy(host_fine_arrays(_only(index, path)),
                                        "cpu")
    tables["locator_sample_tab"] = locator_sample_tab(index, "cpu")
    fl = FineLocator(index, "cpu", tables)
    assert fl.path == path
    got = fl.vote(*targs)
    for g, w, what in zip(got, want[path], ("offset", "votes", "accept")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32),
                                      err_msg=f"{path}: {what}")
    assert int(got[2].sum()) > 0


STEP = dict(batch_size=64, vote_chunk=32)


def _port_build(genome, cfg):
    """The port's own index of a genome, as perfbench/core/port_index.py
    builds it: the port's config and build_index alone, no fine tables."""
    from bucketmap_tpu_torch.config import MapperConfig as PortConfig
    from bucketmap_tpu_torch.index.builder import build_index as port_build
    from bucketmap_tpu_torch.io.fasta import FastaRecord as PortRecord

    return port_build([PortRecord(id=r.id, codes=r.codes) for r in genome],
                      PortConfig(**dataclasses.asdict(cfg)))


def _k14_world(read_len):
    """k = 14 (2k-12 = 16 low bits) over 65,536-base buckets of a 200 kbp
    repeat genome (two references, four buckets): a bucket's k-mer
    positions overflow the packed slots' 16 position bits, as in
    grch38f025. The JAX index and the port's own, checked equal."""
    cfg = MapperConfig(bucket_len=65536, read_len=read_len, index_seed=9,
                       query_seed=14, mapper_samples=8)
    genome = repeat_genome(200_000, seed=23, n_refs=2)
    index = build_index(genome, cfg)
    port = _port_build(genome, cfg)
    assert_same_index(port, index)
    assert index.buckets_packed.shape[1] * 16 - 14 + 1 > 1 << 16
    return cfg, genome, index, port


@pytest.fixture(scope="module")
def step_worlds():
    """The tiny world at k = 8 (host tables of every path), 15 (fine_pos
    only, so the per-q-gram gate runs too) and 16 (no fine index), and
    _k14_world (no fine index, the port's own), each with one batch and
    the port's index where it built its own."""
    out = {}
    for k in (8, 15, 16, 14):
        port = None
        if k == 14:
            cfg, genome, index, port = _k14_world(100)
            sim = ShortReadSimulator(cfg, substitution_rate=0.01, seed=24)
            sim.read(genome)
        else:
            cfg, index, sim = _tiny_world(query_seed=k)
        if k in (8, 15):
            build_fine_index(index, keep_unpacked=True)
        batch = _batch(sim, cfg, STEP["batch_size"])
        batch[2][-3:] = 0                       # padding rows
        out[k] = (index, batch, port)
    return out


@pytest.mark.parametrize("k,path", [(8, "packed"), (8, "prefix"),
                                    (8, "sorted"), (8, "scan"),
                                    (15, "sorted"), (15, "scan"),
                                    (16, "scan"), (14, "scan")])
def test_step_vector_per_path_matches_jax(step_worlds, k, path):
    index, batch, port = step_worlds[k]
    idx = _only(index, path)
    jm = JaxMapper(idx, **STEP)
    assert jm._vote_path == path
    want = np.asarray(jax.device_get(jm.step(*batch)))
    dm = DeviceMapper(port or port_index(idx), "cpu", fine_build="host",
                      **STEP)
    assert dm.vote_path == jm._vote_path
    got = dm.step(*batch).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0] > 0


@pytest.fixture(scope="module")
def long_k_world(tmp_path_factory):
    """Per k: (JAX index, the port's own index or None, FASTQ of 120
    reads)."""
    d = tmp_path_factory.mktemp("vote_paths_pipe")
    genome = repeat_genome(60_000, seed=21, n_refs=2)
    worlds = {}
    for k in (15, 16, 14):
        port = None
        if k == 14:
            cfg, g, index, port = _k14_world(150)
        else:
            cfg, g = MapperConfig(bucket_len=4096, read_len=150, index_seed=7,
                                  query_seed=k, mapper_samples=8), genome
            index = build_index(g, cfg)
        if k == 15:
            build_fine_index(index)
            assert index.fine_packed is None and index.fine_ptab is None
        sim = ShortReadSimulator(cfg, substitution_rate=0.01, seed=32 + k)
        sim.read(g)
        worlds[k] = (index, port, sim.generate(d, f"k{k}", 120)["fastq"])
    return d, worlds


@pytest.mark.parametrize("k,path", [(15, "sorted"), (16, "scan"),
                                    (14, "scan")])
def test_pipeline_sam_matches_jax_at_long_k(long_k_world, k, path):
    """k = 15 keeps only fine_pos (2k-12 = 18 low bits), k = 16 and the
    k = 14 world have no fine index: both pipelines take the same path
    with their defaults."""
    d, worlds = long_k_world
    index, port, fastq = worlds[k]
    jp = JaxPipeline(index, batch_size=64, pair_batch=32)
    assert jp.device._vote_path == path
    jp.map_fastq(fastq, d / f"jax{k}.sam")
    pipe = BucketMapPipeline(port or port_index(index), device="cpu",
                             batch_size=64, pair_batch=32)
    assert pipe.device.vote_path == path
    stats = pipe.map_fastq(fastq, d / f"torch{k}.sam")
    assert (d / f"torch{k}.sam").read_bytes() == (d / f"jax{k}.sam").read_bytes()
    assert stats.mapped_locations >= 100


def test_fine_budget_and_forced_device_build():
    index = port_index(_tiny_world()[1])
    lb = index.buckets_packed.shape[1] * 16
    gb = 4 * index.n_buckets * lb / 2**30
    assert DeviceMapper(index, "cpu", batch_size=8).vote_path == "tiled"
    assert DeviceMapper(index, "cpu", batch_size=8,
                        fine_max_gb=gb).vote_path == "tiled"
    # below the table's size: no device build; the index has no host
    # fine tables, so the scan
    small = DeviceMapper(index, "cpu", batch_size=8, fine_max_gb=gb * 0.99)
    assert small.vote_path == "scan"
    assert "fine_packed" not in small.tables
    # "device" forces the build past the budget
    assert DeviceMapper(index, "cpu", batch_size=8, fine_build="device",
                        fine_max_gb=0.0).vote_path == "tiled"
    for bad in (dict(fine_build="jax"), dict(occupancy_build="auto")):
        with pytest.raises(ValueError, match="must be one of"):
            DeviceMapper(index, "cpu", batch_size=8, **bad)
    index16 = port_index(_tiny_world(query_seed=16)[1])
    with pytest.raises(ValueError, match="does not apply"):
        DeviceMapper(index16, "cpu", batch_size=8, fine_build="device")
    assert DeviceMapper(index16, "cpu", batch_size=8).vote_path == "scan"
