"""BENCHMARK.json and the files it names.

A cell (`workloads` entry) names a configuration and a traffic mix; the
harness finds each by its name: `perfbench/configs/<config>.json`,
`perfbench/traffic/<traffic>.json`, and every per-layer metric's reader
`perfbench/metrics/<metric>.py`. A later cell, mix or metric is a new
file and a new entry, with no edit to any file here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's object
    traffic: dict         # the traffic file's object
    end_to_end: list      # BENCHMARK.json's end_to_end entries of this cell
    per_layer: list       # BENCHMARK.json's per_layer entries of this cell
    root: str             # the checkout's root

    @property
    def cache_dir(self) -> str:
        """Where the configuration's genome, index and reference state
        are kept: inside the checkout, at a path fixed by the name."""
        return os.path.join(self.root, "perfbench", ".cache",
                            self.config["name"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, "perfbench", kind, f"{name}.json")) as f:
        obj = json.load(f)
    if obj.get("name") != name:
        raise ValueError(f"{kind}/{name}.json names itself {obj.get('name')!r}")
    return obj


def cell(root: str, workload: str) -> Cell:
    bench = load_bench(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(name=workload, chips=int(entry["chips"]),
                config=load_json(root, "configs", entry["config"]),
                traffic=load_json(root, "traffic", entry["traffic"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)],
                root=root)


def reader(root: str, metric: str):
    """The `read(ctx)` function of a per-layer metric's reader file."""
    path = os.path.join(root, "perfbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
