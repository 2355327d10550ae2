"""BENCHMARK.json and the files it names.

A cell (`workloads` entry) names a configuration and a traffic mix; the
harness finds each by its name: `perfbench/configs/<config>.json`,
`perfbench/traffic/<traffic>.json`, and every per-layer metric's reader
`perfbench/metrics/<metric>.py`. A later cell, mix or metric is a new
file and a new entry, with no edit to any file here.

A traffic mix may also name, by files of their own, how its reads are
drawn and what its check compares them with (`core/feeder.py` loads
both; a mix that names neither takes `short_reads` and `align_free`):

- `"reads": {"draw": <name>}`: `perfbench/draws/<name>.py`, whose
  `draw(genome, layout, bucket_len, reads, seed, sample_reads)` returns
  the run's `core.reads.Pool` (`reads` is the mix's "reads" object);
- `"check": {"reference": <name>}`: `perfbench/references/<name>.py`,
  whose `ensure(cache_dir, state_dir, config, genome)` returns
  (reference, seconds spent building its state, 0 on a cache hit). The
  reference builds or loads its own state from the configuration and
  the genome, keeping it in `state_dir` (the cell's cache directory's
  `references/<name>`); `cache_dir/reference` holds the state of
  `core/reference.py`, which a reference that reuses its stages shares.
  The reference has `names` (the genome's RNAMEs), `layout` (the bucket
  layout the draw takes), `depends` (the fields of `feeder.Instance` its
  records depend on: any of "ordinal", "chunk", "chunk_lengths",
  "chunk_width") and `records(codes, quality, name, instance)`: the SAM
  records, sorted, of a read of those codes, named `name`, as the
  program writes them for that instance of it. It imports nothing of
  the program and takes nothing that the program made.
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


def module(root: str, kind: str, name: str):
    """The module of `perfbench/<kind>/<name>.py` in the checkout `root`,
    loaded from its file."""
    path = os.path.join(root, "perfbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, metric: str):
    """The `read(ctx)` function of a per-layer metric's reader file."""
    return module(root, "metrics", metric).read
