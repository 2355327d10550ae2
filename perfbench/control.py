"""The control of the benchmark's correctness check: a run of the cell
with one guarantee of the configuration broken in the program, judged
by the harness's own check.

The configuration states that every record is the upstream algorithm's,
whose fine stage votes over `locator_samples` (-p) k-mers. The control
runs the program with two fewer, its own option and the cut a faster
mapper would be tempted to make. Nothing else changes: the run goes
through run.py's whole path (the feeder, the warm-up, the window, the
comparison with the plain reference at the configuration's -p, and the
result line), so that line has to say `"correct": false`. Its
`reads_differing` is the upper reading of that check (a sound run
reads 0).

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

It needs what a run needs (the card). Each seed runs in this process,
one after another; after each run's result line it prints one JSON line:
{"control": ..., "seed", "correct", and each check's value}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402

LOCATOR_CUT = 2


def cut_locator(index, cut: int = LOCATOR_CUT):
    """The program's index with its mapper configuration at -p - cut."""
    cfg = index.config
    return dataclasses.replace(index, config=dataclasses.replace(
        cfg, locator_samples=cfg.locator_samples - cut))


def main(argv=None, root: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    port_index = run.port_index
    run.port_index = lambda cell, **kw: cut_locator(port_index(cell, **kw))
    worst = 0
    for seed in args.seeds:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          root=root)
        lines = out.getvalue().strip().splitlines()
        print(out.getvalue(), end="", flush=True)
        if rc or not lines:
            worst = rc or 1
            continue
        res = json.loads(lines[-1])
        print(json.dumps({
            "control": f"locator_samples - {LOCATOR_CUT}",
            "workload": args.workload, "seed": seed,
            "correct": res["correct"],
            **{k: c["value"] for k, c in res["checks"].items()}}),
            flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
