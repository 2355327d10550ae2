"""Timing of named stages for the profilers (`profile_*.py`).

A `StageClock` is a stage hook: `DeviceMapper.stage` and
`BucketMapPipeline.stage` enter it around each sub-stage of a step or a
dispatch cycle, and a profiler enters it around what it runs itself. Per
stage name it keeps the calls, the host seconds and, on a card, a pair
of CUDA events per call. Each call also opens a torch.profiler range
named STAGE + name, so that `kernels_by_stage` can give each stage its
kernel launches and their device time from a trace.

Two ways to run a block under a clock:
  * as it runs in the pipeline (sync=False): host seconds are the time
    the host spends in the stage (enqueueing, and waiting wherever the
    code synchronises), event times the device span between the stage's
    first and last enqueued work;
  * stage by stage (sync=True): the clock synchronises the device before
    and after each stage and leaves GAP seconds without work on either
    side of its range, so that every kernel a stage launched starts and
    ends inside its range and no other kernel starts within GAP of it;
    `kernels_by_stage` then attributes each kernel of the trace to the
    innermost range that holds its start, widened by GAP / 2 on each
    side: the trace's device timestamps may sit tens of microseconds off
    its host timestamps.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import time

STAGE = "stage:"
GAP = 1e-3


class StageClock:
    """A stage hook on `device` (module docstring). `wait_on_enter` names
    stages before which the clock synchronises and books the wait as the
    stage "<name> wait" (profile_driver's device wait before the copy)."""

    def __init__(self, device, sync: bool = False, wait_on_enter=()):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.sync = sync
        self.wait_on_enter = set(wait_on_enter)
        self.calls = collections.Counter()
        self.host = collections.defaultdict(float)
        self.events = collections.defaultdict(list)
        self.order = []

    def _mark(self, name: str, seconds: float, events=None) -> None:
        if name not in self.calls:
            self.order.append(name)
        self.calls[name] += 1
        self.host[name] += seconds
        if events is not None:
            self.events[name].append(events)

    @contextlib.contextmanager
    def __call__(self, name: str):
        torch = self.torch
        if self.cuda and name in self.wait_on_enter:
            t0 = time.perf_counter()
            torch.cuda.synchronize(self.device)
            self._mark(f"{name} wait", time.perf_counter() - t0)
        if self.cuda and self.sync:
            torch.cuda.synchronize(self.device)
            time.sleep(GAP)
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function(STAGE + name):
            yield
            if self.cuda and self.sync:
                torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        if ev is not None:
            ev[1].record()
        self._mark(name, seconds, ev)
        if self.cuda and self.sync:
            time.sleep(GAP)

    def event_ms(self) -> dict:
        """Per stage, the summed milliseconds between its event pairs (empty
        off the card)."""
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
        return {n: sum(a.elapsed_time(b) for a, b in evs)
                for n, evs in self.events.items()}


def device_events(prof) -> tuple[list, list]:
    """(kernels, copies and sets) of a torch.profiler trace: its device
    events, without the ranges the profiler mirrors on the device."""
    import torch

    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(STAGE)
           and e.name != "gpu_user_annotation"]
    kern = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    return kern, [e for e in evs if e not in kern]


def kernels_by_stage(prof) -> dict:
    """{stage: [kernel launches, their device ms, copies]} from a trace
    taken stage by stage (StageClock(sync=True)): each device event goes
    to the innermost stage range, widened by GAP / 2 on each side, that
    holds its start; events outside every range go to None. Empty where
    the trace has no device event."""
    import torch

    pad = GAP / 2 * 1e6                       # the trace's times are in us
    ranges = sorted(
        ((e.time_range.start - pad, e.time_range.end + pad,
          e.name[len(STAGE):])
         for e in prof.events()
         if e.name.startswith(STAGE)
         and e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda r: (r[0], -r[1]))
    kern, copies = device_events(prof)
    out = collections.defaultdict(lambda: [0, 0.0, 0])
    for e, is_kernel in [(k, True) for k in kern] + [(c, False)
                                                     for c in copies]:
        t = e.time_range.start
        inner = None
        for lo, hi, name in ranges:
            if lo <= t <= hi:
                inner = name        # later starts are nested deeper
            elif lo > t:
                break
        row = out[inner]
        if is_kernel:
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
        else:
            row[2] += 1
    return dict(out)


def table(rows: list, header: tuple) -> str:
    """Rows of values as a fixed-width text table."""
    cells = [[str(h) for h in header]] + [
        ["-" if v is None else f"{v:.4f}" if isinstance(v, float) else str(v)
         for v in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(header))]
    return "\n".join("  ".join(c.rjust(w) if i else c.ljust(w)
                               for i, (c, w) in enumerate(zip(r, widths)))
                     for r in cells)


def stage_report(run, device, reps: int = 3, trace_dir=None) -> dict:
    """Time `run(clock)`, a block that enters `clock` around its stages,
    after one warm-up call: per stage its calls, host ms and event ms as
    it runs in the pipeline (median over `reps` runs of the block), and
    from one run stage by stage under torch.profiler (through
    utils.debug.maybe_trace into trace_dir, where given) its kernel
    launches, their device ms and its copies. Returns {"stages": {name:
    {...}}, "order": [names], "traced": whether the trace held device
    events}."""
    import torch

    from bucketmap_tpu_torch.utils.debug import maybe_trace

    dev = torch.device(device)
    run(StageClock(dev))
    clocks = []
    for _ in range(reps):
        clock = StageClock(dev)
        run(clock)
        clocks.append((clock, clock.event_ms()))
    traced = None
    if dev.type == "cuda" and trace_dir:
        with maybe_trace(trace_dir) as prof:
            run(StageClock(dev, sync=True))
            torch.cuda.synchronize(dev)
        traced = kernels_by_stage(prof)
    order = clocks[0][0].order
    stages = {}
    for name in order + ([None] if traced and None in traced else []):
        host = sorted(c.host.get(name, 0.0) * 1e3 for c, _ in clocks)
        evm = sorted(e.get(name, 0.0) for _, e in clocks)
        k = (traced or {}).get(name)
        stages[name] = {
            "calls": clocks[0][0].calls.get(name, 0),
            "host_ms": host[len(host) // 2] if name is not None else None,
            "event_ms": evm[len(evm) // 2] if dev.type == "cuda"
            and name is not None else None,
            "launches": None if not traced else (k or [0, 0.0, 0])[0],
            "device_ms": None if not traced else (k or [0, 0.0, 0])[1],
            "copies": None if not traced else (k or [0, 0.0, 0])[2],
        }
    return {"stages": stages, "order": order, "traced": bool(traced)}


def print_stages(report: dict, title: str, log=print) -> None:
    """report (stage_report's) as a table under `title`."""
    rows = [(("(outside every stage: the checks)" if n is None else n),
             r["calls"],
             r["launches"], r["device_ms"], r["event_ms"], r["host_ms"])
            for n, r in report["stages"].items()]
    log(f"== {title} ==")
    log(table(rows, ("stage", "calls", "launches", "device ms",
                     "event ms", "host ms")))
    log("host ms and event ms hold the stages nested in a stage; launches "
        "and device ms are the stage's own")
    if not report["traced"]:
        log("launches and device ms not measured (no card, no trace "
            "directory, or the profiler saw no device event)")


def load(args):
    """(the BucketMapPipeline that bench_torch.py builds on args' bench
    world, the world's FASTQ, the segment rows of its first args.batch
    reads packed on the device); the step is pipe.device."""
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

    index, fastq, _, _ = world.bench_world(args.cache_dir, args.genome_mbp,
                                           args.reads,
                                           kmer_fraction=args.frac)
    pipe = BucketMapPipeline(index, device=args.device,
                             batch_size=args.batch, pair_batch=args.batch)
    codes, quals, seg_len, _, _ = pipe._all_segments(
        world.first_reads(fastq, args.batch))
    return pipe, fastq, pipe.device.pack(codes, quals, seg_len)


FLAGS = {
    "genome-mbp": dict(type=float, default=1700.0),
    "reads": dict(type=int, default=1000000),
    "cache-dir": dict(default=".bench_cache"),
    "trace-dir": dict(default=None),
    "device": dict(default="cuda",
                   help="cuda (default; raises without a card) or cpu"),
}


def add_flags(ap, names=tuple(FLAGS)):
    """Add the profilers' common flags `names` (keys of FLAGS) to ap."""
    for name in names:
        ap.add_argument(f"--{name}", **FLAGS[name])
    return ap


def arguments(doc: str, batch: int = 16384):
    """The step profilers' arguments."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--frac", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    return add_flags(ap)


def wall_ms(fn, device, reps: int, warmup: int = 1) -> list:
    """Milliseconds of each of `reps` calls of fn after `warmup` calls,
    each on the host clock from a synchronised device to a synchronised
    device (the JAX scripts' block_until_ready timing)."""
    import torch

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
