"""CPU rehearsals of whole runs: the result line, the traced line, the
modules loaded, and the check failing under planted faults."""

import json
import os
import subprocess
import sys

import pytest

from conftest import TINY

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 3_000_000_017          # more than 32 signed bits hold


def rehearse(root, *args, fault="-"):
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "rehearse.py"), root, fault,
         "--workload", TINY, *args],
        capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    return proc, last


def test_result_line_keys_and_check(tiny_root):
    proc, last = rehearse(tiny_root, "--seed", str(SEED), "--seconds",
                          "0.05", "--trace", "0")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(last)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "pct_correct",
                                   "device_peak_gib", "host_rss_gib",
                                   "setup_s"}
    assert res["metrics"]["pct_correct"]["value"] > 90
    assert res["device"]["platform"] == "cpu"
    assert res["checks"]["reads_differing"]["value"] == 0
    assert res["checks"]["reads_compared"]["value"] >= 64
    # the checks are the last lines on standard error
    tail = proc.stderr.strip().splitlines()[-4:]
    assert all(line.startswith("check ") for line in tail)


def test_traced_line_has_breakdown(tiny_root):
    proc, last = rehearse(tiny_root, "--seed", "11", "--seconds", "0.05",
                          "--trace", "1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(last)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["correct"] is True
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    # on the CPU only the host's metrics can be read (the harness's
    # clock, the program's spans and counters); no device metric is
    # reported from a CPU run
    assert set(res["metrics"]) == {
        "pipeline.emit_s_per_mread", "pipeline.dispatch_ms",
        "setup.index_load_s", "setup.tables_s",
        "pipeline.read_wait_s_per_mread", "pipeline.segment_s_per_mread",
        "pipeline.writer_wait_s_per_mread", "pipeline.parse_s_per_mread",
        "pipeline.merge_s_per_mread", "pipeline.sam_write_s_per_mread",
        "pipeline.unstaged_pct", "pipeline.dispatch_cpu_pct"}


@pytest.mark.parametrize("fault", ["half_batch_left_out", "answer_altered"])
def test_planted_fault_fails_the_check(tiny_root, fault):
    proc, last = rehearse(tiny_root, "--seed", "5", "--seconds", "0.05",
                          "--trace", "0", fault=fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(last)
    assert res["correct"] is False
    assert res["checks"]["reads_differing"]["value"] > 0


def test_no_jax_module_in_any_process(tiny_root):
    """The run's process, the feeder and the index builder each end with
    an error (exit 3) where a module named jax, jaxlib, flax or
    bucketmap_tpu is loaded: a rehearsal that builds the index and
    exits 0 loaded none in any of them."""
    import shutil
    shutil.rmtree(os.path.join(tiny_root, "perfbench", ".cache", "tiny",
                               "index"), ignore_errors=True)
    proc, last = rehearse(tiny_root, "--seed", "8", "--seconds", "0.05",
                          "--trace", "0")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(last)["correct"] is True


def test_forbidden_names_compare_whole():
    import run
    assert run.forbidden_modules(["bucketmap_tpu_torch.mapper.pipeline",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["bucketmap_tpu.ops.vote", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "bucketmap_tpu", "flax", "jax", "jaxlib"]


def test_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, a run
    exits with an error and prints no result."""
    import shutil
    repo = os.path.dirname(os.path.dirname(HERE))
    shutil.copy(os.path.join(repo, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(repo, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "egu1700.sr300",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.card
def test_cell_runs_on_the_card():
    """On a machine with a card: a short run of the first cell."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    repo = os.path.dirname(os.path.dirname(HERE))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "egu1700.sr300",
         "--seed", "21", "--seconds", "5", "--trace", "0"],
        cwd=repo, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
