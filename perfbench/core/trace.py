"""What a `--trace 1` run records, and its reduction.

- StageClock: the program's stage hooks (`BucketMapPipeline.stage`,
  `DeviceMapper.stage`, `BandedAligner.stage`) pointed at the harness's
  clock: each span's thread, layer, stage name, start and end.
- reduce(): torch.profiler's events over the window: kernel time and
  launches by kernel, the device's busy time (the union of its kernels,
  copies and sets), and the device's idle gaps labelled with the stage
  the main thread was in (the innermost span that covers the gap's
  middle), or "outside every stage": waiting for the FASTQ reader's
  next chunk, handing a chunk to the SAM writer, or between stages.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import threading
import time


class StageClock:
    def __init__(self):
        self.spans: list[tuple] = []   # (thread id, layer, stage, t0, t1)

    def hook(self, layer: str):
        spans = self.spans

        @contextlib.contextmanager
        def stage(name: str):
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                spans.append((threading.get_ident(), layer, name, t0,
                              time.perf_counter_ns()))
        return stage

    def durations_ms(self, layer: str, name: str) -> list[float]:
        return [(t1 - t0) / 1e6 for _, ly, nm, t0, t1 in self.spans
                if ly == layer and nm == name]


def _events(prof):
    """(device intervals [(start_ns, end_ns, name, is_kernel)], marker
    start_ns) from a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    dev, mark = [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            kernel = not name.startswith(("Memcpy", "Memset"))
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), name, kernel))
        elif e.name() == "perfbench.mark":
            mark = e.start_ns()
    return dev, mark


def reduce(prof, mark_perf_ns: int, t0_ns: int, t1_ns: int,
           clock: StageClock, main_ident: int) -> dict:
    """The window [t0_ns, t1_ns) (perf_counter ns) of a profiled run.
    mark_perf_ns: perf_counter ns taken as the `perfbench.mark` range
    opened, which ties the profiler's clock to perf_counter's."""
    dev, mark = _events(prof)
    off = (mark - mark_perf_ns) if mark is not None else 0
    a, b = t0_ns + off, t1_ns + off
    kernel_s: dict[str, float] = collections.defaultdict(float)
    launches: dict[str, int] = collections.defaultdict(int)
    ops_s: dict[str, float] = collections.defaultdict(float)
    iv = []
    for s, e, name, kernel in dev:
        if e <= a or s >= b:
            continue
        s, e = max(s, a), min(e, b)
        iv.append((s, e))
        ops_s[name] += (e - s) / 1e9
        if kernel:
            kernel_s[name] += (e - s) / 1e9
            launches[name] += 1
    iv.sort()
    busy = 0
    gaps = []
    cur_s, cur_e = None, a
    for s, e in iv:
        if cur_s is None or s > cur_e:
            if s > cur_e:
                gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if b > cur_e:
        gaps.append((cur_e, b))
    labels: dict[str, float] = collections.defaultdict(float)
    main_spans = sorted((t0 + off, t1 + off, f"{ly}.{nm}")
                        for tid, ly, nm, t0, t1 in clock.spans
                        if tid == main_ident)
    starts = [sp[0] for sp in main_spans]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "main: outside every stage"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if main_spans[j][1] >= mid:
                label = f"main: {main_spans[j][2]}"
                break
            if mid - main_spans[j][0] > 5_000_000_000:
                break
        labels[label] += (g1 - g0) / 1e9
    top = sorted(ops_s.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (b - a) / 1e9,
            "kernel_s": dict(kernel_s), "launches": dict(launches),
            "device_ops": [[n[:160], v] for n, v in top],
            "idle_gaps": sorted(([k, v] for k, v in labels.items()),
                                key=lambda kv: -kv[1])[:10]}


def kernel_total(trace: dict, fragment: str) -> tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds `fragment`."""
    s = sum(v for n, v in trace["kernel_s"].items() if fragment in n)
    c = sum(v for n, v in trace["launches"].items() if fragment in n)
    return s, c
