"""The port's accuracy sweeps (`bucketmap_tpu_torch/experiments/`)
against the JAX build's `experiments/` scripts: `sweep.py`'s JSON rows
equal, `error_sweep.py`'s mapped and correct shares equal (its reads/s
is a time, not compared), and the production sweep's `run` on a 2 Mbp
bench world: one row per configuration, the JAX script's keys, and the
smoke run's floors on its lowest-error 300 bp row. The JAX package's C++
host library is never loaded here (its numpy paths give the same
bytes)."""

import contextlib
import io
import json
import sys

import pytest

from bucketmap_tpu.io import native as jax_native
from bucketmap_tpu_torch import world as port_world
from bucketmap_tpu_torch.experiments import (error_sweep,
                                             error_sweep_production, sweep)
from experiments import error_sweep as jax_error_sweep
from experiments import sweep as jax_sweep

ROW_KEYS = ["read_len", "sub_rate", "indel_rate", "reads", "reads_per_sec",
            "pct_mapped", "pct_correct_position", "pct_correct_position_tol5",
            "locations_per_read"]


def _rows(main, argv, monkeypatch, jax_script: bool):
    """The JSON rows that main prints; a JAX script reads sys.argv."""
    out = io.StringIO()
    with monkeypatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        if jax_script:
            mp.setattr(sys, "argv", ["sweep"] + argv)
        with contextlib.redirect_stdout(out):
            main() if jax_script else main(argv + ["--device", "cpu"])
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_sweep_rows_match_jax(monkeypatch):
    argv = ["--genome-mbp", "0.3", "--reads", "200", "--d-values", "0,0.5",
            "--b-values", "0"]
    got = _rows(sweep.main, argv, monkeypatch, jax_script=False)
    want = _rows(jax_sweep.main, argv, monkeypatch, jax_script=True)
    assert len(got) == 2 and got == want
    assert all(r["pct_correct_bucket"] > 90 for r in got)


def test_error_sweep_matches_jax(monkeypatch):
    argv = ["--genome-mbp", "0.3", "--reads", "200", "--read-lens", "150",
            "--sub-rates", "0.01", "--indel-rates", "0.001"]
    got = _rows(error_sweep.main, argv, monkeypatch, jax_script=False)
    want = _rows(jax_error_sweep.main, argv, monkeypatch, jax_script=True)
    assert len(got) == len(want) == 1
    for key in ("read_len", "sub_rate", "indel_rate", "pct_mapped",
                "pct_correct"):
        assert got[0][key] == want[0][key], key
    assert got[0]["pct_mapped"] > 95
    assert set(got[0]) == set(want[0])


def test_production_sweep_run(tmp_path, capsys):
    genome = port_world.bench_genome(2.0)
    index = port_world.bench_world(str(tmp_path), 2.0, 1024, genome=genome,
                                   log=lambda m: None)[0]
    rows = error_sweep_production.run(
        index, genome, str(tmp_path), n=1024, read_lens=(100, 150, 300),
        sub_rates=(0.002, 0.01), indel_rates=(0.00025,), device="cpu")
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [(r["read_len"], r["sub_rate"], r["indel_rate"]) for r in rows] \
        == [(rl, s, 0.00025) for rl in (100, 150, 300) for s in (0.002, 0.01)]
    assert all(list(r) == ROW_KEYS and r["reads"] == 1024 for r in rows)
    best = rows[4]
    assert best["pct_mapped"] >= 97.0 and best["pct_correct_position"] >= 95.0
    # the reads are cached by configuration and count: a second run maps
    # the same files
    again = error_sweep_production.run(
        index, genome, str(tmp_path), n=1024, read_lens=(300,),
        sub_rates=(0.002,), indel_rates=(0.00025,), device="cpu")
    assert {k: v for k, v in again[0].items() if k != "reads_per_sec"} == \
        {k: v for k, v in best.items() if k != "reads_per_sec"}


def test_production_sweep_needs_the_named_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        error_sweep_production.main(["16", "--genome-mbp", "0.1"])
