"""The device step of one batch, broken down by stage: the port's
counterpart of the JAX build's experiments/profile_step.py.

    python -m bucketmap_tpu_torch.experiments.profile_step \
        [--batch 16384] [--genome-mbp 1700] [--reads 1000000] \
        [--cache-dir .bench_cache] [--trace-dir DIR] [--device cuda]

Runs `DeviceMapper.step_packed` on the first --batch reads of the bench
world that bench_torch.py caches (made here where the cache lacks it),
with a StageClock as the step's stage hook, so that what is timed is the
step the pipeline runs: unpack_reads, the fused coarse score (sampling,
row map, the coarse_score kernel), the at-max select, the locator
sampling (FineLocator.prepare), the lane compaction with its host sync,
each live vote chunk's search (on the tiled path the fine_search kernel,
one launch from the chunk's lanes to the tally's proposals) and tally,
and the packing of the result; then the device-to-host copy.
Beside the step, the staged coarse branch on the same reads
(presence_gather, then chunk_scan), which must give the fused branch's
score. Per stage: calls, kernel launches and their device ms (one run
stage by stage under torch.profiler), event ms and host ms (as the step
runs, median of --reps); for the whole step its wall ms, the device-busy
share and the launches.
"""

from __future__ import annotations

import os
import sys
import time

from bucketmap_tpu_torch.mapper.device_pipeline import no_stage


def decompose(dm, packed, stage=no_stage) -> dict:
    """Run dm.step_packed(packed) with `stage` as its hook inside a "step"
    stage, copy its vector to the host ("download"), then run the staged
    coarse branch on the same reads ("staged presence", "staged chunk
    scan"). Returns {"vec": the host vector, "staged_equal": whether the
    staged branch's (max, at-max count, planes) equal the fused
    branch's}."""
    import torch

    from bucketmap_tpu_torch.ops.coarse import CoarseMapper, chunk_scan
    from bucketmap_tpu_torch.ops.encoding import unpack_reads

    prev, dm.stage = dm.stage, stage
    try:
        with stage("step"):
            vec = dm.step_packed(packed)
    finally:
        dm.stage = prev
    with stage("download"):
        vec = vec.cpu()
    cfg = dm.cfg
    staged = CoarseMapper(dm.index, dm.device, dm.tables,
                          coarse_path="staged")
    codes, qual_ok, lengths = unpack_reads(packed, cfg.read_len,
                                           cfg.query_seed)
    with stage("staged presence"):
        presence, _, _ = staged.presence(codes, qual_ok, lengths)
    with stage("staged chunk scan"):
        got = chunk_scan(presence, staged.n_buckets)
    want = dm.coarse.score(codes, qual_ok, lengths, dm.coarse.n_buckets)[:3]
    equal = all(torch.equal(a.reshape(b.shape), b) for a, b in zip(got, want))
    return {"vec": vec, "staged_equal": equal}


def step_wall(dm, packed, reps: int, trace_dir=None) -> dict:
    """The whole step as the pipeline runs it (no stage hook): wall ms
    from the call to a synchronised device (median of reps), and from one
    more step under torch.profiler its kernel launches, copies, device ms
    and the device-busy share of its wall."""
    import torch

    from bucketmap_tpu_torch.experiments.stages import device_events
    from bucketmap_tpu_torch.utils.debug import maybe_trace

    dev = dm.device
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dm.step_packed(packed)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    out = {"wall_ms": walls[len(walls) // 2], "launches": None,
           "copies": None, "device_ms": None, "busy": None}
    if trace_dir:
        with maybe_trace(trace_dir) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dm.step_packed(packed)
            torch.cuda.synchronize(dev)
            traced_ms = (time.perf_counter() - t0) * 1e3
        kern, copies = device_events(prof)
        if kern:
            busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
            out.update(launches=len(kern), copies=len(copies),
                       device_ms=busy, traced_wall_ms=traced_ms,
                       busy=busy / traced_ms)
    return out


def profile(dm, packed, reps: int = 3, trace_dir=None, log=print) -> dict:
    """Time the decomposition (stages.stage_report) and the whole step
    (step_wall) on the card, check the decomposition's vector against
    step_packed's word for word and the staged branch against the fused
    one, and print both tables. Returns {"stages", "step", "vec_equal",
    "staged_equal"}."""
    import torch

    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report)

    want = dm.step_packed(packed).cpu()
    checks = {}

    def run(clock):
        checks.update(decompose(dm, packed, clock))

    report = stage_report(run, dm.device, reps, trace_dir)
    vec_equal = torch.equal(checks["vec"], want)
    step = step_wall(dm, packed, reps, trace_dir)
    B = packed.shape[0]
    print_stages(report, f"the step of one {B}-read batch by stage "
                 f"(vote path {dm.vote_path}, vote chunk {dm.vote_chunk})",
                 log)
    if step["busy"] is None:
        traced = "launches, device time and busy share not measured"
    else:
        traced = (f"launches {step['launches']}, copies {step['copies']}, "
                  f"device {step['device_ms']:.3f} ms in "
                  f"{step['traced_wall_ms']:.3f} ms traced, busy share "
                  f"{step['busy']:.3f} of the traced wall, "
                  f"{step['device_ms'] / step['wall_ms']:.3f} of the "
                  f"untraced one")
    log(f"== the whole step == wall {step['wall_ms']:.3f} ms (median of "
        f"{reps}); one step under the profiler: {traced}; "
        f"{B / step['wall_ms'] * 1e3:.0f} reads/s of step alone; the "
        f"decomposition's vector equal to step_packed's {vec_equal}; the "
        f"staged branch equal to the fused one {checks['staged_equal']}")
    return {"stages": report, "step": step, "vec_equal": vec_equal,
            "staged_equal": checks["staged_equal"]}


def main(argv=None) -> dict:
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import arguments, load

    args = arguments(__doc__).parse_args(argv)

    dev = resolve_device(args.device)
    pipe, _, packed = load(args)
    dm = pipe.device
    if dev.type != "cuda":
        out = decompose(dm, packed)
        print(f"step on the CPU: vector of {out['vec'].numel()} words "
              f"(no device times on the CPU)")
        return out
    return profile(dm, packed, args.reps,
                   args.trace_dir or os.path.join(args.cache_dir,
                                                  "profile_step_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
