"""Start-up of the GRCh38-scale world (3.1 Gbp, FracMinHash f=0.25) in
its parts, the port's counterpart of the JAX build's
experiments/profile_grch38_warmup.py.

    python -m bucketmap_tpu_torch.experiments.profile_grch38_warmup \
        [--genome-mbp 3100] [--frac 0.25] [--reads 1000000] \
        [--batch 16384] [--cache-dir .bench_cache] [--device cuda]

On the world bench_torch.py caches under BMTPU_BENCH_GENOME_MBP=3100
BMTPU_BENCH_FRAC=0.25 (made here where the cache lacks it, outside the
timed parts), in order: the index load, the pipeline's init (the device
tables, the tiled fine table built on the card), the first batch (its
kernels built where csrc/build is cold) and a steady batch, each a
map_reads of the first --batch reads; each part's seconds from a host
clock around work that ends synchronised.
"""

from __future__ import annotations

import os
import sys

from bucketmap_tpu_torch.mapper.device_pipeline import no_stage


def warmup_split(cache_dir: str, genome_mbp: float, frac: float,
                 n_reads: int, batch_size: int, device, stage=no_stage):
    """The start-up as the stages "index load", "pipeline init", "first
    batch" and "steady batch" (module docstring). Returns (the pipeline,
    the first batch_size reads, the steady batch's MapStats)."""
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.mapper.pipeline import (BucketMapPipeline,
                                                     default_pair_batch)

    fastq = world.bench_reads(cache_dir, n_reads, genome_mbp,
                              kmer_fraction=frac)[0]
    reads = world.first_reads(fastq, batch_size)
    with stage("index load"):
        index = world.bench_index(cache_dir, genome_mbp,
                                  world.bench_config(frac))[0]
    with stage("pipeline init"):
        pipe = BucketMapPipeline(
            index, device=device, batch_size=batch_size,
            pair_batch=default_pair_batch(index, device, batch_size))
    sam = os.path.join(cache_dir, "warmup.sam")
    with stage("first batch"):
        pipe.map_reads(reads, sam)
    with stage("steady batch"):
        stats = pipe.map_reads(reads, sam)
    return pipe, reads, stats


def profile(cache_dir: str, genome_mbp: float = 3100.0, frac: float = 0.25,
            n_reads: int = 1000000, batch_size: int = 16384,
            device="cuda", log=print):
    """warmup_split on the card with a StageClock that synchronises around
    each part; prints the seconds. Returns (the pipeline, the reads, the
    seconds by part)."""
    from bucketmap_tpu_torch.experiments.stages import StageClock, table

    clock = StageClock(device, sync=True)
    pipe, reads, _ = warmup_split(cache_dir, genome_mbp, frac, n_reads,
                                  batch_size, device, clock)
    seconds = {n: clock.host[n] for n in clock.order}
    log(f"== start-up of the {genome_mbp:g} Mbp f={frac:g} world "
        f"({pipe.index.n_buckets} buckets, vote path "
        f"{pipe.device.vote_path}) ==")
    log(table([(n, s) for n, s in seconds.items()], ("part", "seconds")))
    return pipe, reads, seconds


def main(argv=None):
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import arguments

    ap = arguments(__doc__)
    ap.set_defaults(genome_mbp=3100.0, frac=0.25)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return warmup_split(args.cache_dir, args.genome_mbp, args.frac,
                            args.reads, args.batch, dev)
    return profile(args.cache_dir, args.genome_mbp, args.frac, args.reads,
                   args.batch, dev)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
