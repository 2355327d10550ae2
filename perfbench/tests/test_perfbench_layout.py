"""BENCHMARK.json against the benchmark's contract, every cell resolved
to its files, and a new cell, mix and metric added by files and entries
alone."""

import hashlib
import json
import os
import re
import shutil

from conftest import PERFBENCH, REPO
from core import feeder, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return spec.load_bench(REPO)


def test_contract_shape():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"reads_per_s", "pct_correct", "device_peak_gib",
                        "host_rss_gib", "setup_s"}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = spec.cell(REPO, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                       "reads_per_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(REPO, m["name"]))
        draw = cell.traffic["reads"].get("draw", feeder.DEFAULT_DRAW)
        assert callable(spec.module(REPO, "draws", draw).draw)
        reference = cell.traffic["check"].get("reference",
                                              feeder.DEFAULT_REFERENCE)
        assert callable(spec.module(REPO, "references", reference).ensure)


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_mix_and_metric_are_files_and_entries(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(PERFBENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digest(os.path.join(root, "perfbench"))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "traffic", "sr300.json")) as f:
        mix = json.load(f)
    mix.update(name="sr300-err1")
    mix["reads"]["substitution_rate"] = 0.01
    with open(os.path.join(pb, "traffic", "sr300-err1.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "pipeline.mapped_share.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    return 100.0 * ctx['stats']['reads_with_candidates']"
                " / ctx['reads']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": "egu1700.sr300-err1",
                           "config": "egu1700", "traffic": "sr300-err1",
                           "chips": 1, "why": "1% substitutions"})
    b["per_layer"].append({"name": "pipeline.mapped_share", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "pipeline", "moves": "pct_correct",
                           "workloads": ["egu1700.sr300-err1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    after = _digest(pb)
    assert {k: after[k] for k in before} == before
    cell = spec.cell(root, "egu1700.sr300-err1")
    assert cell.traffic["reads"]["substitution_rate"] == 0.01
    assert [m["name"] for m in cell.per_layer] == ["pipeline.mapped_share"]
    read = spec.reader(root, "pipeline.mapped_share")
    assert read({"stats": {"reads_with_candidates": 9}, "reads": 10}) == 90.0
