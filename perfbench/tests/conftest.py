"""Fixtures of the benchmark's own tests (run with
`python -m pytest perfbench/tests`): a tiny checkout root whose one cell
maps a 4 Mbp world on the CPU, where the program runs its kernels' plain
versions. Tests that need a CUDA card carry the `card` marker and skip
without one, deciding inside the test."""

from __future__ import annotations

import json
import os
import sys

import pytest

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PERFBENCH)
for p in (REPO, PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = "tiny.sr300"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "without one")


def make_root(path: str) -> str:
    """A checkout root holding BENCHMARK.json with one tiny cell, its
    configuration and traffic files, and links to the harness's code."""
    pb = os.path.join(path, "perfbench")
    os.makedirs(os.path.join(pb, "configs"))
    os.makedirs(os.path.join(pb, "traffic"))
    for d in ("core", "metrics", "draws", "references"):
        os.symlink(os.path.join(PERFBENCH, d), os.path.join(pb, d))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = [{"name": TINY, "config": "tiny", "traffic": "sr300",
                           "chips": 1, "why": "a 4 Mbp world on the CPU"}]
    for m in bench["per_layer"]:
        m["workloads"] = [TINY]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(PERFBENCH, "configs", "egu1700.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny")
    cfg["genome"].update(bp=4_000_000, n_refs=2)
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(PERFBENCH, "traffic", "sr300.json")) as f:
        tr = json.load(f)
    tr["reads"]["pool"] = 4000
    tr["run"].update(batch_size=512, pair_batch=512, reads_per_chunk=1024,
                     warm_reads=512)
    tr["check"].update(sample_reads=128, min_compared=64)
    with open(os.path.join(pb, "traffic", "sr300.json"), "w") as f:
        json.dump(tr, f)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("root")))
