"""One run of one cell of the benchmark of `bucketmap_tpu_torch`.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(`perfbench/configs/<name>.json`: the genome and the mapper's settings)
and a traffic mix (`perfbench/traffic/<name>.json`: the reads, the run
mode and the check). A run:

1. starts the feeder process (`core/feeder.py`), which makes the
   configuration's genome (cached 2-bit packed under `perfbench/.cache/`
   on a checkout's first run), the plain reference's index state (cached
   alike) and the pool of reads drawn from `--seed`, and then keeps to
   one CPU (`feeder_cpus`);
2. loads the program's index of that genome, built by the program's own
   builder in a process of its own on a checkout's first run
   (`core/port_index.py`);
3. builds `BucketMapPipeline` on the card and maps one batch of the
   pool through `map_fastq`, FASTQ in and SAM out through FIFOs, so that
   every shape is warm: that ends the set-up;
4. times one `map_fastq` over FIFOs in TMPDIR: the feeder writes the
   pool, pass after pass, for `--seconds` from the first byte and then
   closes the stream; it reads every SAM record back and scores it
   against the truth; the window ends when `map_fastq` returns;
5. frees the program's state, has the feeder compare the sampled reads'
   records with the plain reference's (the mix's `check.reference`,
   `perfbench/references/<name>.py`; `align_free` by default, which is
   `core/reference.py`), and prints the result as the last line of
   standard output.

With `--trace 1` the window runs under torch.profiler with the stage
hooks timed, and the per-layer metrics (`perfbench/metrics/<name>.py`)
are printed instead of the end-to-end ones. Each reader's `read(ctx)`
gets the window's `MapStats` (`stats`), the reduced trace (`trace`),
the stage clock (`clock`), the configuration's mapper settings and the
mix's run settings, the set-up's times, and `program_counters`: the
pipeline aligner's `counts` over the window (each number less its value
when the window opened; None where the pipeline has no aligner).
"""

from __future__ import annotations


def _process_start_s() -> float:
    """Seconds since this process started, from /proc."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


import time  # noqa: E402

_T_ENTRY = time.perf_counter() - _process_start_s()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from core import spec as spec_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bucketmap_tpu")
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


class Feeder:
    """The feeder process and its line protocol."""

    def __init__(self, args: dict):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "core", "feeder.py"),
             json.dumps(args)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def expect(self, event: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the feeder ended before {event!r} "
                               f"(exit {self.proc.wait()})")
        msg = json.loads(line)
        if msg.get("event") != event:
            raise RuntimeError(f"the feeder said {msg}, not {event!r}")
        return msg

    def send(self, cmd: str, **kw) -> None:
        self.proc.stdin.write(json.dumps({"cmd": cmd, **kw}) + "\n")
        self.proc.stdin.flush()

    def close(self) -> int:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                return self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
        return self.proc.wait()


def port_index(cell, log_to=sys.stderr):
    """The program's index of the cell's genome: loaded from the cache,
    built there first by the program's builder where it is missing."""
    from bucketmap_tpu_torch.index.builder import load_index

    d = os.path.join(cell.cache_dir, "index")
    if not os.path.exists(os.path.join(d, "index.bmtpu.json")):
        cfg_path = os.path.join(cell.root, "perfbench", "configs",
                                f"{cell.config['name']}.json")
        subprocess.run([sys.executable, os.path.join(HERE, "core",
                                                     "port_index.py"),
                        cell.cache_dir, cfg_path],
                       check=True, stdout=log_to)
    return load_index(d, "index")


def feeder_cpus() -> list[int]:
    """The CPU the feeder keeps to once it has made the inputs: the last
    one this process may use, so that its copying takes at most that
    CPU's time from the program, which may use every CPU."""
    return sorted(os.sched_getaffinity(0))[-1:]


def card_ok(torch, chips: int) -> bool:
    """Whether torch sees the CUDA cards the cell asks for."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        return True
    log(f"needs {chips} CUDA device(s); torch sees "
        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return False


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of the loaded (or given) modules that are JAX's or
    the JAX package's, each compared whole: bucketmap_tpu_torch's name
    only begins with bucketmap_tpu."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def aligner_counts(pipe) -> dict | None:
    """A copy of the pipeline aligner's counts; None without an aligner."""
    return None if pipe.aligner is None else dict(pipe.aligner.counts)


def window_counts(before: dict | None, after: dict | None) -> dict | None:
    """The counts over the window: each number less its value before."""
    if after is None:
        return None
    return {k: v - before.get(k, 0) if isinstance(v, (int, float)) else v
            for k, v in after.items()}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: str | None = None) -> int:
    """Run one cell and print its result line; the exit code. `root`:
    the checkout (default, the one this file is in)."""
    args = parse(argv)
    root = root or os.path.dirname(HERE)
    sys.path.insert(0, root)
    cell = spec_mod.cell(root, args.workload)
    caches = os.path.join(root, "perfbench", ".cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(caches, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(caches, "torch_extensions"))
    import torch

    if not card_ok(torch, cell.chips):
        return 2
    fifo_dir = tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get("TMPDIR"))
    fifos = {n: os.path.join(fifo_dir, n) for n in
             ("warm_fastq", "warm_sam", "fastq", "sam")}
    for p in fifos.values():
        os.mkfifo(p)
    feeder = Feeder({"root": cell.root, "cache_dir": cell.cache_dir,
                     "config": cell.config,
                     "traffic": cell.traffic, "seed": args.seed,
                     "seconds": args.seconds, "fifos": fifos,
                     "cores": feeder_cpus()})
    try:
        return run(args, cell, feeder, fifos, torch)
    finally:
        feeder.close()
        shutil.rmtree(fifo_dir, ignore_errors=True)


def run(args, cell, feeder: Feeder, fifos: dict, torch) -> int:
    t_wait = time.perf_counter()
    inputs = feeder.expect("ready")
    wait_s = time.perf_counter() - t_wait
    print(json.dumps({"inputs": inputs, "inputs_s": wait_s}), flush=True)

    t = time.perf_counter()
    index = port_index(cell)
    index_load_s = time.perf_counter() - t
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

    run_cfg = cell.traffic["run"]
    t = time.perf_counter()
    pipe = BucketMapPipeline(index, device="cuda", align=run_cfg["align"],
                             batch_size=run_cfg["batch_size"],
                             pair_batch=run_cfg["pair_batch"])
    on_card = pipe.device.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    tables_s = time.perf_counter() - t
    index_device_gib = torch.cuda.memory_allocated() / GIB if on_card else None
    occupancy_shape = tuple(int(x) for x in index.qgram_words.shape)

    chunk = run_cfg["reads_per_chunk"]
    mapped: dict = {}

    def drive(cmd: str, event: str, fq: str, sam: str, out: dict):
        """Have the feeder stream `cmd`'s reads while map_fastq maps them
        on this thread; the feeder's report."""
        feeder.send(cmd)
        out["t0"] = time.perf_counter_ns()
        out["stats"] = pipe.map_fastq(fq, sam, reads_per_chunk=chunk)
        out["t1"] = time.perf_counter_ns()
        return feeder.expect(event)

    warm = drive("warm", "warmed", fifos["warm_fastq"], fifos["warm_sam"], {})
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T_ENTRY - wait_s
    log(f"set-up {setup_s:.3f} s (index {index_load_s:.3f} s, tables "
        f"{tables_s:.3f} s; warm-up {warm['reads']} reads)")

    trace = clock = None
    counts0 = aligner_counts(pipe)
    if args.trace:
        from core import trace as trace_mod
        from torch.profiler import ProfilerActivity, profile, record_function

        clock = trace_mod.StageClock()
        pipe.stage = clock.hook("pipeline")
        pipe.device.stage = clock.hook("step")
        if pipe.aligner is not None:
            pipe.aligner.stage = clock.hook("align")
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            mark_ns = time.perf_counter_ns()
            with record_function("perfbench.mark"):
                pass
            streamed = drive("window", "streamed", fifos["fastq"],
                             fifos["sam"], mapped)
            if on_card:
                torch.cuda.synchronize()
        t = time.perf_counter()
        trace = trace_mod.reduce(prof, mark_ns, mapped["t0"], mapped["t1"],
                                 clock, threading.get_ident())
        del prof
        log(f"trace reduced in {time.perf_counter() - t:.1f} s")
    else:
        streamed = drive("window", "streamed", fifos["fastq"], fifos["sam"],
                         mapped)
    counters = window_counts(counts0, aligner_counts(pipe))
    window_s = (mapped["t1"] - mapped["t0"]) / 1e9
    stats = mapped["stats"]
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / GIB
    del pipe, index
    if on_card:
        torch.cuda.empty_cache()

    feeder.send("check")
    checked = feeder.expect("checked")
    rc = feeder.close()
    found = forbidden_modules()
    if found or rc:
        log(f"loaded {found}" if found else f"the feeder exited with {rc}")
        return 3

    written = streamed["written"]
    lost = max(written - stats.num_reads, 0)
    checks = {
        "reads_differing": {"value": checked["differing"], "limit": 0},
        "reads_compared": {"value": checked["compared"],
                           "limit": cell.traffic["check"]["min_compared"]},
        "reads_lost": {"value": lost, "limit": 0},
        "records_unknown": {"value": streamed["unknown"], "limit": 0},
    }
    correct = (checks["reads_differing"]["value"] <= 0
               and checks["reads_compared"]["value"]
               >= checks["reads_compared"]["limit"]
               and lost <= 0 and streamed["unknown"] <= 0
               and stats.num_reads == written)
    for s in checked["shown"]:
        log(s)

    values = {
        "reads_per_s": written / window_s,
        "pct_correct": 100.0 * streamed["correct"] / max(written, 1),
        "device_peak_gib": peak / GIB,
        "host_rss_gib": rss_gib,
        "setup_s": setup_s,
    }
    metrics = {}
    if args.trace:
        ctx = {"stats": dataclasses.asdict(stats), "trace": trace,
               "clock": clock, "mapper": cell.config["mapper"],
               "run": run_cfg, "index_load_s": index_load_s,
               "tables_s": tables_s, "index_device_gib": index_device_gib,
               "occupancy_shape": occupancy_shape,
               "window_s": window_s, "reads": stats.num_reads,
               "program_counters": counters}
        for m in cell.per_layer:
            v = spec_mod.reader(cell.root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": written,
              "failed": lost + checked["differing"] + streamed["unknown"],
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    log(f"window {window_s:.3f} s, {written} reads (fed for "
        f"{streamed['feed_s']:.3f} s, SAM read back in "
        f"{streamed['score_s']:.3f} s), reference check "
        f"{checked['seconds']:.1f} s ({checked['expectations']} "
        f"expectations), end-to-end {json.dumps(values)}")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
