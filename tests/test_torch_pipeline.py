"""The torch port end to end: SAM bytes equal to the JAX pipeline's,
align-free and in align mode, the package running with neither jax nor
the JAX package loaded, and the `map` command line. The JAX index
reaches the port through index_from_arrays, or as the files the JAX
package's save_index writes."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index, save_index
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu.mapper.pipeline import Location as JaxLocation
from bucketmap_tpu.mapper.pipeline import \
    filter_best_locations as jax_filter_best
from bucketmap_tpu.ops.encoding import decode_to_ascii
from bucketmap_tpu.sim.simulator import ShortReadSimulator, repeat_genome
from bucketmap_tpu_torch import cli
from bucketmap_tpu_torch.mapper.pipeline import (BucketMapPipeline, Location,
                                                 filter_best_locations)
from test_torch_host import port_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A repeat genome, its index, and 300 noisy reads plus three long
    reads (> 2*read_len, mapped as segments) in one FASTQ."""
    d = tmp_path_factory.mktemp("torch_pipe")
    genome = repeat_genome(120_000, seed=21, n_refs=2)
    index = build_index(genome, CFG)
    sim = ShortReadSimulator(CFG, substitution_rate=0.01, insertion_rate=0.001,
                             deletion_rate=0.001, seed=32)
    sim.read(genome)
    paths = sim.generate(d, "noisy", 300)
    with open(paths["fastq"], "a") as f:
        for i, start in enumerate((10_000, 31_000, 50_500)):
            seq = decode_to_ascii(genome[i % 2].codes[start: start + 700]).decode()
            f.write(f"@long{i}\n{seq}\n+\n{'E' * len(seq)}\n")
    return d, index, paths["fastq"]


@pytest.mark.parametrize("ppr", [4, 1])
def test_sam_matches_jax_pipeline(world, monkeypatch, ppr):
    d, index, fastq = world
    monkeypatch.setenv("BMTPU_DEVICE_FINE", "1")
    jp = JaxPipeline(index, batch_size=128, pair_batch=64,
                     pairs_per_read=ppr)
    jax_splits = []
    jsplit = jp._locate_split
    monkeypatch.setattr(jp, "_locate_split",
                        lambda *a: jax_splits.append(1) or jsplit(*a))
    jp.map_fastq(fastq, d / f"jax{ppr}.sam")
    pipe = BucketMapPipeline(port_index(index), device="cpu", batch_size=128,
                             pair_batch=64, pairs_per_read=ppr)
    splits = []
    split = pipe._locate_split
    monkeypatch.setattr(pipe, "_locate_split",
                        lambda *a: splits.append(a[-2:]) or split(*a))
    stats = pipe.map_fastq(fastq, d / f"torch{ppr}.sam")
    want = (d / f"jax{ppr}.sam").read_bytes()
    assert (d / f"torch{ppr}.sam").read_bytes() == want
    assert stats.num_reads == 303 and stats.mapped_locations > 300
    # pairs_per_read=1 overflows the lane budget, where the JAX pipeline
    # splits the batch; the port's step grows past its budget instead
    assert bool(jax_splits) == (ppr == 1)
    assert not splits and stats.split_steps == 0
    assert stats.steps == 3
    assert (stats.grown_steps > 0) == (ppr == 1)


@pytest.mark.parametrize("qt", [None, 0])
def test_align_sam_matches_jax_pipeline(world, monkeypatch, qt):
    """Align mode: scores, begins, CIGARs, MAPQ (size_t wrap included) and
    record order; the three 700 bp reads take the segment-stitched
    long-read path."""
    d, index, fastq = world
    monkeypatch.setenv("BMTPU_DEVICE_FINE", "1")
    tag = "d" if qt is None else qt
    JaxPipeline(index, align=True, batch_size=128, pair_batch=64).map_fastq(
        fastq, d / f"jax_align{tag}.sam", quality_threshold=qt)
    pipe = BucketMapPipeline(port_index(index), device="cpu", align=True,
                             batch_size=128, pair_batch=64)
    long_calls = []
    emit = pipe._align_long_emit
    monkeypatch.setattr(pipe, "_align_long_emit",
                        lambda *a: long_calls.append(len(a[2])) or emit(*a))
    stats = pipe.map_fastq(fastq, d / f"torch_align{tag}.sam",
                           quality_threshold=qt)
    want = (d / f"jax_align{tag}.sam").read_bytes()
    assert (d / f"torch_align{tag}.sam").read_bytes() == want
    assert stats.num_reads == 303 and stats.mapped_locations > 280
    assert long_calls and long_calls[0] >= 3
    cigars = [ln.split(b"\t")[5] for ln in want.splitlines()
              if not ln.startswith(b"@")]
    assert any(b"I" in c or b"D" in c for c in cigars)
    assert sum(c == b"*" for c in cigars) < len(cigars) // 10


def test_locate_entry_points_match_jax(world):
    """locate_arrays and locate_batch, the JAX pipeline's other entry
    points: the same location arrays and per-read Location lists."""
    from bucketmap_tpu.io.fastq import iter_fastq_batches
    from bucketmap_tpu_torch.io import fastq as port_fastq

    d, index, fastq = world
    batch = next(iter(iter_fastq_batches(fastq, reads_per_batch=400)))
    tbatch = next(iter(port_fastq.iter_fastq_batches(fastq,
                                                     reads_per_batch=400)))
    jp = JaxPipeline(index, batch_size=128, pair_batch=64)
    pipe = BucketMapPipeline(port_index(index), device="cpu", batch_size=128,
                             pair_batch=64)
    (want, jstats), (got, stats) = (jp.locate_arrays(batch),
                                    pipe.locate_arrays(tbatch))
    assert len(got) == 6 and len(got[0]) > 300
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (stats.num_reads, stats.candidate_pairs) == \
        (jstats.num_reads, jstats.candidate_pairs)
    per_read, _ = pipe.locate_batch(tbatch)
    jper_read, _ = jp.locate_batch(batch)
    assert len(per_read) == batch.num_reads
    assert [[tuple(vars(x).values()) for x in r] for r in per_read] == \
        [[tuple(vars(x).values()) for x in r] for r in jper_read]


def test_align_shares_the_genome_with_the_fine_stage(world):
    """On the scan path (no host fine tables) the fine stage reads the
    aligner's device copy of the packed genome, and the align SAM equals
    the tiled path's; the tiled path holds no genome copy of its own."""
    d, index, fastq = world
    sams = []
    for fine_build in ("host", "auto"):
        pipe = BucketMapPipeline(port_index(index), device="cpu", align=True,
                                 batch_size=128, pair_batch=64,
                                 fine_build=fine_build)
        fine, al = pipe.device.fine, pipe.aligner
        if fine_build == "auto":
            assert pipe.device.vote_path == "tiled"
            assert fine.buckets_packed is None
        else:
            assert pipe.device.vote_path == "scan"
            assert fine.buckets_packed.untyped_storage().data_ptr() == \
                al.buckets_packed.untyped_storage().data_ptr()
            assert fine.buckets_packed.shape == index.buckets_packed.shape
            assert pipe.device.tables["buckets_packed"] is fine.buckets_packed
        pipe.map_fastq(fastq, d / f"share_{fine_build}.sam")
        sams.append((d / f"share_{fine_build}.sam").read_bytes())
    assert sams[0] == sams[1] and sams[0].count(b"\n") > 300


def test_filter_best_locations_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        n = int(rng.integers(1, 7))
        locs = [(int(rng.integers(0, 3)), int(rng.integers(0, 40)), 0,
                 int(rng.integers(1, 6)), bool(rng.integers(0, 2)))
                for _ in range(n)]
        got = filter_best_locations([Location(*l) for l in locs], 150, 0.02)
        want = jax_filter_best([JaxLocation(*l) for l in locs], 150, 0.02)
        assert [tuple(vars(g).values()) for g in got] == \
            [tuple(vars(w).values()) for w in want]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_maps_without_jax(tmp_path):
    """The tiny world made by the port's own config, builder and
    simulator, mapped align-free, aligned and on a one-rank gloo mesh,
    with neither jax nor the JAX package ever imported."""
    code = """
import sys
from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index.builder import build_index
from bucketmap_tpu_torch.io.fastq import read_fastq
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from bucketmap_tpu_torch.sim.simulator import ShortReadSimulator, random_genome
cfg = MapperConfig(bucket_len=1024, read_len=100, index_seed=5, query_seed=8,
                   mapper_samples=6, locator_samples=5, max_candidate_buckets=4)
genome = random_genome(40_000, seed=7, n_refs=2)
index = build_index(genome, cfg)
sim = ShortReadSimulator(cfg, substitution_rate=0.01, seed=8)
sim.read(genome)
batch = read_fastq(sim.generate(sys.argv[3], "r", 16)["fastq"])
for align in (False, True):
    stats = BucketMapPipeline(index, device="cpu", align=align, batch_size=16,
                              pair_batch=16).map_reads(batch, sys.argv[1])
    assert stats.mapped_locations > 0, (align, stats)
# a one-rank gloo mesh through the staged coarse branch
import torch.distributed as dist
from bucketmap_tpu_torch.parallel import distributed, sharding
distributed.initialize(backend="gloo", init_method="file://" + sys.argv[2],
                       rank=0, world_size=1)
mesh = sharding.make_mesh()
assert mesh.shape == {"data": 1, "bucket": 1}
mstats = BucketMapPipeline(index, device="cpu", align=True, batch_size=16,
                           pair_batch=16, mesh=mesh, coarse_path="staged"
                           ).map_reads(batch, sys.argv[1])
del mesh
dist.destroy_process_group()
assert mstats.mapped_locations == stats.mapped_locations, (mstats, stats)
bad = sorted(m for m in sys.modules if m in ("jax", "bucketmap_tpu")
             or m.startswith(("jax.", "bucketmap_tpu.")))
assert not bad, bad
print("ok", stats.mapped_locations)
"""
    res = subprocess.run([sys.executable, "-c", code, os.devnull,
                          str(tmp_path / "store"), str(tmp_path)], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_cli_map_on_cpu(world):
    d, index, fastq = world
    save_index(index, d, "idx")
    out = d / "cli.sam"
    res = subprocess.run(
        [sys.executable, "-m", "bucketmap_tpu_torch.cli", "map", "-q", fastq,
         "-i", "idx", "--index-dir", d, "-o", out, "--batch-size", "128",
         "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Total mapped locations" in res.stdout
    BucketMapPipeline(port_index(index), device="cpu", batch_size=128,
                      pair_batch=128).map_fastq(fastq, d / "direct.sam")
    assert out.read_bytes() == (d / "direct.sam").read_bytes()


def test_cli_map_align_on_cpu(world):
    d, index, fastq = world
    save_index(index, d, "idx_al")
    out = d / "cli_align.sam"
    res = subprocess.run(
        [sys.executable, "-m", "bucketmap_tpu_torch.cli", "map", "-q", fastq,
         "-i", "idx_al", "--index-dir", d, "-o", out, "--batch-size", "128",
         "--device", "cpu", "--align"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Total mapped locations" in res.stdout
    BucketMapPipeline(port_index(index), device="cpu", align=True,
                      batch_size=128, pair_batch=128).map_fastq(
                          fastq, d / "direct_align.sam")
    assert out.read_bytes() == (d / "direct_align.sam").read_bytes()
    assert b"M\t" in out.read_bytes()


def test_cli_refuses_missing_cuda_and_align(world, capsys):
    """No CUDA device: the command line and the pipeline refuse to map on
    'cuda', align-free and in align mode, rather than fall back."""
    d, index, fastq = world
    import torch
    base = ["map", "-q", str(fastq), "-i", "idx", "--index-dir", str(d),
            "-o", str(d / "x.sam")]
    if not torch.cuda.is_available():
        for extra in ([], ["--align"]):
            assert cli.main(base + extra) == 1
            assert "CUDA is not available" in capsys.readouterr().err
        with pytest.raises(RuntimeError, match="cuda"):
            BucketMapPipeline(port_index(index), device="cuda", align=True)
