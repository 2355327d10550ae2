"""A CPU rehearsal of the align cell: `sr300-align` on the tiny world,
added as the cell adds itself (a traffic file and appended entries),
through run.py's whole path with the `align` reference; the readers of
its four metrics fed a made context."""

import json
import os
import subprocess
import sys
import threading

import pytest

from core import spec
from core.trace import StageClock

from conftest import PERFBENCH, REPO, make_root

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "tiny.sr300-align"
METRICS = ("align.s_per_mread", "align.pack_ms", "align.consume_ms",
           "dp_runs_roofline")


@pytest.fixture(scope="module")
def align_root(tiny_root, tmp_path_factory):
    """The tiny root with the align mix at the tiny cell's sizes and its
    cell, on the tiny cell's caches; the align metrics list the cell."""
    root = make_root(str(tmp_path_factory.mktemp("align")))
    pb = os.path.join(root, "perfbench")
    cache = os.path.join(tiny_root, "perfbench", ".cache", "tiny")
    os.makedirs(cache, exist_ok=True)
    os.makedirs(os.path.join(pb, ".cache"))
    os.symlink(cache, os.path.join(pb, ".cache", "tiny"))
    with open(os.path.join(pb, "traffic", "sr300.json")) as f:
        tiny = json.load(f)
    with open(os.path.join(PERFBENCH, "traffic", "sr300-align.json")) as f:
        mix = json.load(f)
    assert mix["reads"] == dict(tiny["reads"], pool=mix["reads"]["pool"])
    mix["reads"] = tiny["reads"]
    mix["run"].update(batch_size=256, pair_batch=512, reads_per_chunk=1024,
                      warm_reads=512)
    mix["check"].update(sample_reads=96, min_compared=64)
    with open(os.path.join(pb, "traffic", "sr300-align.json"), "w") as f:
        json.dump(mix, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "sr300-align", "chips": 1,
                               "why": "the align cell on a 4 Mbp world"})
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"] = [CELL]
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return root


def rehearse(root, *args):
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "rehearse.py"), root, "-",
         "--workload", CELL, *args],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    return lines[0]["inputs"], lines[-1]


def test_align_cell_is_correct(align_root):
    inputs, res = rehearse(align_root, "--seed", "3000000019",
                           "--seconds", "0.05", "--trace", "0")
    assert (inputs["draw"], inputs["reference"]) == ("short_reads", "align")
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["reads_differing"]["value"] == 0
    assert res["checks"]["reads_compared"]["value"] >= 64
    assert res["metrics"]["pct_correct"]["value"] > 90


def test_traced_align_cell_reads_its_host_metrics(align_root):
    """On the CPU the three span readers read; dp_runs_roofline, which
    needs the card's trace, reads nothing."""
    _, res = rehearse(align_root, "--seed", "11", "--seconds", "0.02",
                      "--trace", "1")
    assert res["correct"] is True, res["checks"]
    got = {m: res["metrics"][m]["value"] for m in METRICS
           if m in res["metrics"]}
    assert set(got) == set(METRICS) - {"dp_runs_roofline"}
    assert all(v > 0 for v in got.values())


def _ctx(counters, kernel_s=0.02, spans=True):
    main = threading.main_thread().ident
    clock = StageClock()
    if spans:
        clock.spans += [(main, "pipeline", "align", 0, 3_000_000_000),
                        (main, "pipeline", "align", 5_000_000_000,
                         6_000_000_000),
                        (main, "align", "pack", 0, 6_000_000),
                        (main, "align", "pack", 10_000_000, 20_000_000),
                        (main, "align", "consume", 0, 4_000_000)]
    trace = {"kernel_s": {"void dp_runs_kernel<2, 3, true>(...)": kernel_s}
             if kernel_s else {},
             "launches": {"void dp_runs_kernel<2, 3, true>(...)": 10}
             if kernel_s else {}}
    return {"clock": clock, "reads": 2_000_000, "trace": trace,
            "program_counters": counters}


# two sub-batches of 16,384 padded pairs, Q 304, band 48, lo 16, MR 64,
# 20,000 real pairs of 300 bases
COUNTERS = {"sub_batches": 2, "pairs": 20_000, "ops_reruns": 0,
            "dp_launched_rows": 32_768, "dp_rows": 6_000_000,
            "dp_row_text": 32_768 * 368, "dp_row_query": 32_768 * 304,
            "dp_row_runs": 32_768 * 64, "dp_row_band": 6_000_000 * 48}


def test_readers_of_the_align_metrics():
    read = {m: spec.reader(REPO, m) for m in METRICS}
    ctx = _ctx(COUNTERS)
    assert read["align.s_per_mread"](ctx) == pytest.approx(2.0)
    assert read["align.pack_ms"](ctx) == pytest.approx(8.0)
    assert read["align.consume_ms"](ctx) == pytest.approx(4.0)
    # 4.32e9 operations at 16.7e12 a second outweigh 2.6e7 bytes at
    # 3.35e12: 0.2587 ms of least time over 20 ms of kernel
    want = 100 * 6_000_000 * 48 * 15 / 16.7e12 / 0.02
    assert read["dp_runs_roofline"](ctx) == pytest.approx(want, rel=1e-12)
    # nothing where the program has no such span or counter (the
    # parent's aligner counts only sub-batches, pairs and re-runs), and
    # nothing without a launch
    parent = {k: COUNTERS[k] for k in ("sub_batches", "pairs", "ops_reruns")}
    assert read["dp_runs_roofline"](_ctx(parent)) is None
    assert read["dp_runs_roofline"](_ctx(None)) is None
    assert read["dp_runs_roofline"](_ctx(COUNTERS, kernel_s=0)) is None
    for m in METRICS[:3]:
        assert read[m](_ctx(COUNTERS, spans=False)) is None
