"""The host's share of mapping: one dispatch cycle of locate_chunks split
into its parts, the port's counterpart of the JAX build's
experiments/profile_driver.py.

    python -m bucketmap_tpu_torch.experiments.profile_driver \
        [--batches 12] [--batch 16384] [--cache-dir .bench_cache] \
        [--device cuda] ...

On the first --batches x --batch reads of the bench world (bench_torch.py's
cache), after a warm-up batch:
  A. sequential: the pipeline's own locate_chunks with a StageClock as its
     stage hook, each cycle's records emitted on this thread: segmenting,
     pack and dispatch (the step's launches, and its host sync at
     compaction), device wait, device-to-host copy, decode, host extract,
     SAM emit, and within the emit the merge and the write;
  B. streamed: map_reads over the same reads, the SAM writer on its own
     thread, as map_fastq maps each chunk.
Phase A's SAM must equal phase B's byte for byte.
"""

from __future__ import annotations

import filecmp
import os
import sys
import time

from bucketmap_tpu_torch.mapper.device_pipeline import no_stage

STAGES = ("segment", "dispatch", "download wait", "download", "decode",
          "extract", "emit", "merge", "sam_write")
# stages entered inside "emit" (BucketMapPipeline._merge_emit)
IN_EMIT = ("merge", "sam_write")


def cycle(pipe, batch, sam_path, stage=no_stage):
    """Map `batch` into sam_path cycle by cycle on this thread:
    pipe.locate_chunks with `stage` as the pipeline's hook, each location
    chunk's records written by pipe._merge_emit inside an "emit"
    stage, in order, as map_reads' writer thread writes them. Returns the
    MapStats."""
    from bucketmap_tpu_torch.mapper.pipeline import MapStats

    stats = MapStats()
    writer = pipe._writer(sam_path)
    prev, pipe.stage = pipe.stage, stage
    try:
        for chunk in pipe.locate_chunks(batch, stats):
            with stage("emit"):
                pipe._merge_emit(writer, batch, chunk, stats)
    finally:
        pipe.stage = prev
        writer.close()
    return stats


def profile(pipe, batch, n_batches: int, out_dir: str, log=print) -> dict:
    """Phases A and B (module docstring) on the first n_batches batches of
    `batch`, on the card: per stage seconds in all and ms per batch, reads/s
    of each phase, and whether their SAMs are equal."""
    import torch

    from bucketmap_tpu_torch.experiments.stages import StageClock, table

    dev = pipe.device.device
    B = pipe.batch_size
    sub = batch.head(n_batches * B)
    n = sub.num_reads
    pipe.map_reads(sub.head(B), os.path.join(out_dir, "warmup.sam"))
    torch.cuda.synchronize(dev)
    sam_a = os.path.join(out_dir, "profile_driver_a.sam")
    sam_b = os.path.join(out_dir, "profile_driver_b.sam")

    clock = StageClock(dev, wait_on_enter=("download",))
    # each step's result vector as downloaded: its length follows the
    # step's output capacity (DeviceMapper.step_budgets)
    vec_bytes = []
    decode = pipe.device.decode_out
    pipe.device.decode_out = lambda vec: (vec_bytes.append(vec.nbytes)
                                          or decode(vec))
    t0 = time.perf_counter()
    try:
        cycle(pipe, sub, sam_a, clock)
    finally:
        pipe.device.decode_out = decode
    seq_s = time.perf_counter() - t0
    cycles = clock.calls["dispatch"]
    rows = [(name, clock.calls[name], clock.host[name],
             clock.host[name] / max(1, cycles) * 1e3) for name in STAGES]
    rest = seq_s - sum(clock.host[name] for name in STAGES
                       if name not in IN_EMIT)
    rows.append(("(the rest: padding, bookkeeping)", "", rest,
                 rest / max(1, cycles) * 1e3))
    log(f"== sequential decomposition ({n} reads, {cycles} dispatch cycles "
        f"of {B}) ==")
    log(table(rows, ("stage", "calls", "seconds", "ms per cycle")))
    log(f"device-to-host copy {sum(vec_bytes) / max(1, cycles) / 1e6:.3f} MB"
        f" a cycle, "
        f"{sum(vec_bytes) / max(clock.host['download'], 1e-9) / 1e6:.0f}"
        f" MB/s; sequential {n / seq_s:,.0f} reads/s ({seq_s:.3f} s)")

    t0 = time.perf_counter()
    pipe.map_reads(sub, sam_b)
    stream_s = time.perf_counter() - t0
    same = filecmp.cmp(sam_a, sam_b, shallow=False)
    log(f"== streamed map_reads == {n} reads in {stream_s:.3f} s -> "
        f"{n / stream_s:,.0f} reads/s; SAM equal to the sequential one's "
        f"{same}")
    return {"seconds": {name: clock.host[name] for name in STAGES},
            "cycles": cycles, "sequential_s": seq_s, "streamed_s": stream_s,
            "sam_equal": same}


def main(argv=None):
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import arguments, load

    ap = arguments(__doc__)
    ap.add_argument("--batches", type=int, default=12)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pipe, fastq, _ = load(args)
    batch = world.first_reads(fastq, args.batches * args.batch)
    if dev.type != "cuda":
        cycle(pipe, batch, os.path.join(args.cache_dir,
                                        "profile_driver_a.sam"))
        print("cycle on the CPU written (no device times on the CPU)")
        return {}
    return profile(pipe, batch, args.batches, args.cache_dir)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
