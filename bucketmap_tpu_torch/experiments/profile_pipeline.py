"""Throughput of the device step alone: N distinct batches through
DeviceMapper.step, synchronised once at the end, the port's counterpart
of the JAX build's experiments/profile_pipeline.py.

    python -m bucketmap_tpu_torch.experiments.profile_pipeline \
        [--batches 12] [--batch 16384] [--cache-dir .bench_cache] \
        [--device cuda] ...

The batches are consecutive segment rows of the bench world's reads
(bench_torch.py's cache), starting again from the first where the reads
hold fewer;
two batches warm up first. Prints reads/s, ms per batch and the
locations the steps accepted.
"""

from __future__ import annotations

import sys
import time


def run_batches(dm, rows, n_batches: int) -> list:
    """n_batches steps of dm.batch_size rows each from rows = (codes,
    quals, seg_len): the i-th takes whole batch i modulo the whole batches
    the rows hold. Returns the device vectors, not synchronised."""
    codes, quals, seg_len = rows
    B = dm.batch_size
    whole = max(1, len(seg_len) // B)
    outs = []
    for i in range(n_batches):
        s = (i % whole) * B
        outs.append(dm.step(codes[s:s + B], quals[s:s + B], seg_len[s:s + B]))
    return outs


def profile(pipe, batch, n_batches: int = 12, log=print) -> dict:
    """Time run_batches on the card: two batches of warm-up, then
    n_batches from the call to one synchronise at the end."""
    import torch

    dm = pipe.device
    dev = dm.device
    B = dm.batch_size
    rows = pipe._all_segments(batch)[:3]
    run_batches(dm, rows, 2)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs = run_batches(dm, rows, n_batches)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    accepted = sum(int(v[0]) for v in outs)
    log(f"== {n_batches} batches of {B} through the step == {dt:.3f} s -> "
        f"{n_batches * B / dt:,.0f} reads/s ({dt / n_batches * 1e3:.2f} ms a "
        f"batch); accepted {accepted} locations; vote path {dm.vote_path}")
    return {"seconds": dt, "reads_per_s": n_batches * B / dt,
            "accepted": accepted}


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
        outs = run_batches(pipe.device, pipe._all_segments(batch)[:3],
                           args.batches)
        print(f"{len(outs)} steps on the CPU (no device times on the CPU)")
        return outs
    return profile(pipe, batch, args.batches)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
