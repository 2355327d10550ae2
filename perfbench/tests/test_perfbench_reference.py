"""The plain reference against the program on a tiny world (the program
on the CPU, its kernels' plain versions), the check rejecting a SAM
stream with one record changed, and the control failing a whole run's
check."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from core import genome as G
from core import reads as R
from core import spec
from core.feeder import Stream, check
from core.reference import Params, ReferenceIndex

import control
from conftest import PERFBENCH, REPO, TINY

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 4_000_000_007


@pytest.fixture(scope="module", params=["egu1700", "grch38f025"])
def mapped(request, tmp_path_factory):
    """Each configuration's mapper settings on a tiny world."""
    with open(os.path.join(PERFBENCH, "configs",
                           f"{request.param}.json")) as f:
        m = json.load(f)["mapper"]
    recs = G.repeat_genome(4_000_000, seed=1, n_refs=2)
    g = G.Genome([n for n, _ in recs], [len(c) for _, c in recs],
                 [G.pack_2bit(c) for _, c in recs])
    pr = Params(m)
    ref = spec.module(REPO, "references", "align_free").AlignFree(
        ReferenceIndex(pr, g, *ReferenceIndex.build_arrays(pr, g)))
    traffic = {"pool": 2500, "read_len": 300, "substitution_rate": 0.002,
               "insertion_rate": 0.00025, "deletion_rate": 0.00025,
               "revcomp_share": 0.5, "quality": "E"}
    pool = R.draw(g, ref.layout, pr.bucket_len, traffic, SEED, 400)

    from bucketmap_tpu_torch.config import MapperConfig
    from bucketmap_tpu_torch.index.builder import build_index
    from bucketmap_tpu_torch.io.fasta import FastaRecord
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

    index = build_index([FastaRecord(id=n, codes=c) for n, c in recs],
                        MapperConfig(**m))
    assert np.array_equal(index.zeros[:-1], ref.index.zeros)
    d = tmp_path_factory.mktemp("m")
    fq, sam = str(d / "r.fastq"), str(d / "o.sam")
    pool.buf.tofile(fq)
    BucketMapPipeline(index, device="cpu", batch_size=512,
                      pair_batch=512).map_fastq(fq, sam)
    return ref, pool, sam


def test_reference_agrees_with_the_program(mapped):
    ref, pool, sam = mapped
    s = Stream(pool, ref.names)
    s.consume(sam)
    out = check(ref, pool, s, pool.n, 1 << 17)
    # the align-free reference depends on the read alone: one
    # expectation a sampled read
    assert out["compared"] == out["expectations"] == 400
    assert out["differing"] == 0, out["shown"]
    assert s.correct[:pool.n].mean() > 0.95


def test_one_changed_record_is_caught(mapped, tmp_path):
    ref, pool, sam = mapped
    lines = open(sam, "rb").read().split(b"\n")
    target = pool.name(pool.sample[7], pool.sample[7])
    for i, line in enumerate(lines):
        f = line.split(b"\t")
        if f[0] == target:
            f[4] = b"%d" % (int(f[4]) - 6)          # MAPQ one vote lower
            lines[i] = b"\t".join(f)
            break
    else:
        pytest.skip("the sampled read has no record")
    bad = tmp_path / "bad.sam"
    bad.write_bytes(b"\n".join(lines))
    s = Stream(pool, ref.names)
    s.consume(str(bad))
    assert check(ref, pool, s, pool.n, 1 << 17)["differing"] == 1


def test_control_fails_the_check(tiny_root):
    """The control (the program at -p 8 against the configuration's 10)
    through a whole run's path: its result line says correct false."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "rehearse.py"), tiny_root,
         "control", "--workload", TINY, "--seconds", "0.05", "--seeds",
         "6", str(SEED)],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    results = [x for x in lines if "metrics" in x]
    summaries = [x for x in lines if "control" in x]
    assert len(results) == len(summaries) == 2
    for res, summary in zip(results, summaries):
        assert res["correct"] is False and summary["correct"] is False
        assert summary["control"] == f"locator_samples - {control.LOCATOR_CUT}"
        checks = res["checks"]
        assert checks["reads_compared"]["value"] >= 64
        assert checks["reads_differing"]["value"] > \
            0.5 * checks["reads_compared"]["value"]


def test_parallel_build_equals_the_serial_one(tmp_path, monkeypatch):
    from core import reference
    monkeypatch.setattr(reference, "_BLOCK", 8)   # jobs of 16 buckets
    with open(os.path.join(PERFBENCH, "configs", "grch38f025.json")) as f:
        spec = json.load(f)
    spec["genome"].update(bp=3_000_000, n_refs=2)
    g, _ = G.ensure(str(tmp_path), spec["genome"])
    pr = Params(spec["mapper"])
    ref, built = ReferenceIndex.ensure(str(tmp_path), pr, g, workers=3)
    assert built > 0
    occ, present, _ = ReferenceIndex.build_arrays(pr, g)
    assert np.array_equal(np.asarray(ref.occ), occ)
    assert np.array_equal(ref.zeros, ref.n - present)
    again, built = ReferenceIndex.ensure(str(tmp_path), pr, g)
    assert built == 0 and np.array_equal(np.asarray(again.occ), occ)
