#!/usr/bin/env python3
"""Throughput benchmark of the PyTorch/CUDA port: end-to-end read mapping
on one NVIDIA GPU, the port's `bench.py`.

    python3 bench_torch.py [--device cuda]

Prints ONE JSON line on stdout with every key bench.py prints (metric,
value in reads/s, vs_baseline, pct_mapped, pct_correct_position at +-10
and +-5, locations_per_read, warmup_seconds, peak_host_rss_kb,
device_hbm_peak_bytes and its source, io_native, index_build_seconds
where the index was built, and in long-read mode
pct_correct_position_tol{tol}), plus `batch`, `device` (the card's name)
and `power_limit_w` (nvidia-smi's power.limit). On stderr: bench.py's
`[bench]` lines and the kernel launches of the timed map.

The world is bench.py's, with its cache names (bucketmap_tpu_torch/
world.py), so one `.bench_cache/` serves both packages: a seeded 1.7 Gbp
repeat-structured genome (4 references), MapperConfig(bucket_len=65536,
read_len=300), 300 bp reads at dwgsim-like error rates (seed 2), or ONT
reads of ~7.5 kbp in long-read mode. Knobs, read from the environment by
`settings` (bench.py's names and defaults):
  BMTPU_BENCH_GENOME_MBP (1700), BMTPU_BENCH_READS (1000000; 100000 in
  long-read mode), BMTPU_BENCH_BATCH (16384; 8192 in align mode),
  BMTPU_BENCH_ALIGN=1 (align mode), BMTPU_BENCH_LONG=1 (ONT reads at the
  reference's long-read flags), BMTPU_BENCH_FRAC (FracMinHash fraction,
  1.0), BMTPU_BENCH_UNIFORM=1 (the repeat-free genome),
  BMTPU_BENCH_HOST_FINE=1 (host-built fine tables: fine_build="host"),
  BMTPU_BENCH_PAIR_BATCH (the DP sub-batch and vote-chunk cap),
  BMTPU_BENCH_CACHE (.bench_cache beside this script).

The run, in bench.py's order: the world (cached); io.native.available();
a warm-up map of the first BATCH reads to warmup.sam (warmup_seconds;
it includes the nvcc build where csrc/build is cold); the timed
map_fastq over the whole file, a host clock around it; resource_report();
score_sam at +-10 and +-5 (and at the drift tolerance for long reads).
One process is one run, so peak_host_rss_kb is one mode's ru_maxrss.

The pair batch follows bench.py's rule: the DP sub-batch is 16384 pairs
in align mode, the batch otherwise, and 1024 where the vote takes the
table-free scan path, which materialises (vote chunk, bucket_len)
intermediates. bench.py sized that rule (fine table <= 8 GB) for a 16 GB
TPU; here the scan path is taken where no fine table is built on the
card (it exceeds fine_max_gb, half the card) and the index holds none.

Not ported, as workarounds for the JAX build's remote TPU link: the
persistent XLA compilation cache, the retry on RESOURCE_EXHAUSTED at
init, and BMTPU_FETCH_GROUP.

The device is "cuda" unless --device cpu is given (the tests' switch,
which runs the kernels' plain versions); without a card, "cuda" raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# align-free: 1M reads / 320.95 s; align: 1M / 426.78 s (the reference's
# benchmark/README.md:168-169)
BASELINE_READS_PER_SEC_NOALIGN = 3116.0
BASELINE_READS_PER_SEC_ALIGN = 2343.1


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def settings(environ=None) -> dict:
    """bench.py's knobs from `environ` (default os.environ)."""
    env = os.environ if environ is None else environ
    long = env.get("BMTPU_BENCH_LONG", "0") == "1"
    align = env.get("BMTPU_BENCH_ALIGN", "0") == "1"
    pair_batch = env.get("BMTPU_BENCH_PAIR_BATCH")
    return {
        "genome_mbp": float(env.get("BMTPU_BENCH_GENOME_MBP", "1700")),
        "long": long,
        "reads": int(env.get("BMTPU_BENCH_READS",
                             "100000" if long else "1000000")),
        "align": align,
        "batch": int(env.get("BMTPU_BENCH_BATCH",
                             "8192" if align else "16384")),
        "uniform": env.get("BMTPU_BENCH_UNIFORM", "0") == "1",
        "frac": float(env.get("BMTPU_BENCH_FRAC", "1.0")),
        "host_fine": env.get("BMTPU_BENCH_HOST_FINE", "0") == "1",
        "pair_batch": None if pair_batch is None else int(pair_batch),
        "cache": env.get("BMTPU_BENCH_CACHE",
                         os.path.join(HERE, ".bench_cache")),
    }


def baseline_reads_per_sec(s: dict) -> float:
    """The reference's align-free reads/s for this world: 1.7 Gbp, or at
    >= 3000 Mbp its committed 3.1 Gbp runs (677.43 s for 1M reads, 711.5
    s with f < 1)."""
    if s["genome_mbp"] >= 3000:
        return 1e6 / 711.5 if s["frac"] < 1.0 else 1e6 / 677.43
    return BASELINE_READS_PER_SEC_NOALIGN


def card(dev) -> tuple[str, float | None]:
    """(the device's name, the card's power limit in W from nvidia-smi, or
    None on the CPU or where nvidia-smi does not answer)."""
    import torch

    if dev.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        log(f"[bench] card: {out[0]}")
        return name, float(out[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return name, None


def run(s: dict, device="cuda") -> dict:
    """One bench run at settings `s` on `device`; returns the JSON line's
    object (also printed to stdout)."""
    import torch

    from bucketmap_tpu_torch import kernels, world
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.io import native
    from bucketmap_tpu_torch.mapper.pipeline import (BucketMapPipeline,
                                                     default_pair_batch)
    from bucketmap_tpu_torch.utils.debug import resource_report

    dev = resolve_device(device)
    cache, mbp, n_reads = s["cache"], s["genome_mbp"], s["reads"]
    cfg = world.bench_config(s["frac"], s["long"])
    t0 = time.time()
    index, genome, index_build_s = world.bench_index(
        cache, mbp, cfg, uniform=s["uniform"], host_fine=s["host_fine"],
        log=log)
    if index_build_s is None:
        log(f"[bench] index loaded in {time.time() - t0:.1f}s")
    fastq, gt, sim_s = world.bench_reads(cache, n_reads, mbp, genome,
                                         s["frac"], s["uniform"], s["long"],
                                         log=log)
    log(f"[bench] reads ready in {sim_s:.1f}s")
    del genome

    name, power_w = card(dev)
    log(f"[bench] device: {name} ({dev})")
    io_native = native.available()  # builds csrc/host on first use
    log(f"[bench] native host-IO: "
        f"{'ENGAGED' if io_native else 'python fallback'}")
    t0 = time.time()
    warm_batch = world.first_reads(fastq, s["batch"])
    log(f"[bench] warmup prefix parsed in {time.time() - t0:.2f}s "
        f"({warm_batch.num_reads} reads)")

    fine_build = "host" if s["host_fine"] else "auto"
    pair_batch = s["pair_batch"] or default_pair_batch(
        index, dev, s["batch"], s["align"], fine_build)
    pipe = BucketMapPipeline(index, device=dev, align=s["align"],
                             batch_size=s["batch"], pair_batch=pair_batch,
                             fine_build=fine_build)
    log(f"[bench] vote path {pipe.device.vote_path}, batch {s['batch']}, "
        f"pair batch {pair_batch}")
    t0 = time.time()
    pipe.map_reads(warm_batch, os.path.join(cache, "warmup.sam"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warmup_s = time.time() - t0
    log(f"[bench] warmup {warmup_s:.1f}s (kernel build "
        f"{kernels.BUILD_INFO.get('seconds', 0.0):.1f}s where it ran)")
    del warm_batch

    tag = world.reads_name(mbp, n_reads, s["frac"], s["uniform"],
                           s["long"])[len("reads_"):]
    sam_path = os.path.join(cache, f"out_{tag}{'_al' if s['align'] else ''}"
                                   f".sam")
    kernels.reset_launches()
    t0 = time.time()
    stats = pipe.map_fastq(fastq, sam_path)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    rps = stats.num_reads / dt
    log(f"[bench] mapped {stats.num_reads} reads in {dt:.1f}s: "
        f"{rps:.0f} reads/s  (segment {stats.segment_seconds:.1f}s, "
        f"cycles {stats.cycle_seconds:.1f}s, out {stats.output_seconds:.1f}s, "
        f"pairs {stats.candidate_pairs}, locations {stats.mapped_locations})")
    log(f"[bench] kernel launches in the timed map: {json.dumps(launches)}")
    # before scoring, whose string lists would otherwise set the peak RSS
    # (the reference times and measures the map run only)
    rsrc = resource_report()

    t0 = time.time()
    mapped_pct, correct_pct = world.score_sam(sam_path, gt, index)
    _, correct_tol5 = world.score_sam(sam_path, gt, index, tol=5)
    extra = {}
    if index_build_s is not None:
        extra["index_build_seconds"] = round(index_build_s, 1)
    mean_len = stats.num_bases / max(1, stats.num_reads)
    if s["long"]:
        # ONT indels drift the implied read start by ~sqrt(rate*len)
        # bases: also score at bench.py's drift-aware tolerance
        tol = max(10, int(0.02 * mean_len))
        _, correct_drift = world.score_sam(sam_path, gt, index, tol=tol)
        extra[f"pct_correct_position_tol{tol}"] = round(correct_drift, 2)
    log(f"[bench] %mapped={mapped_pct:.2f} %correct-position="
        f"{correct_pct:.2f} {extra} (scored in {time.time() - t0:.1f}s)")

    kind = "uniform" if s["uniform"] else "repeat-structured"
    if s["long"]:
        desc = (f"{n_reads} x ~{mean_len / 1000:.1f}kb ONT-like reads, "
                f"{mbp:g} Mbp {kind} genome; vs_baseline = bases/s over the "
                f"3116 reads/s x 300bp short-read align-free C++ baseline "
                f"(no valid reference long-read time exists: its committed "
                f"runs exited 255)")
        vsb = rps * mean_len / (baseline_reads_per_sec(s) * 300.0)
    else:
        desc = (f"{n_reads} x 300bp sim reads, {mbp:g} Mbp {kind} genome"
                + (f", FracMinHash f={s['frac']:g}" if s["frac"] != 1.0
                   else "")
                + f", {'align' if s['align'] else 'align-free'}")
        vsb = rps / (BASELINE_READS_PER_SEC_ALIGN if s["align"]
                     else baseline_reads_per_sec(s))
    peak = rsrc["device_hbm_peak_bytes"]
    log(f"[bench] peak host RSS {rsrc['peak_host_rss_kb'] / 1048576:.2f} GB, "
        f"device peak "
        f"{'unavailable' if peak is None else f'{peak / 2**30:.2f} GB'}")
    out = {
        "metric": f"reads_per_sec_per_chip ({desc})",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(vsb, 3),
        "pct_mapped": round(mapped_pct, 2),
        "pct_correct_position": round(correct_pct, 2),
        "pct_correct_position_tol5": round(correct_tol5, 2),
        "locations_per_read": round(stats.mapped_locations / stats.num_reads,
                                    4),
        "warmup_seconds": round(warmup_s, 1),
        "peak_host_rss_kb": rsrc["peak_host_rss_kb"],
        "device_hbm_peak_bytes": peak,
        "device_hbm_peak_source": rsrc["device_hbm_peak_source"],
        "io_native": io_native,
        **extra,
        "batch": s["batch"],
        "device": name,
        "power_limit_w": power_w,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, environ=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    return run(settings(environ), args.device)


if __name__ == "__main__":
    main()
