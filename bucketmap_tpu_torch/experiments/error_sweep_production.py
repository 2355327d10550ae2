"""Error-rate x read-length sweep on the PRODUCTION bench world
(BASELINE config 5: substitutions 0.2-1%, indels 0.025-0.1%, read
lengths 100/150/300), the port's `experiments/error_sweep_production.py`.

Maps n simulated reads per configuration against the bench world's
1.7 Gbp repeat-structured index (`world.bench_world`, cached under
--cache-dir) with one pipeline: read lengths up to the index's
read_len=300 share its shapes. After one warm-up batch, each
configuration's reads are simulated (cached by configuration and count),
mapped with `map_fastq` and scored with `world.score_sam`. Emits one
JSON line per configuration to stdout:

  python -m bucketmap_tpu_torch.experiments.error_sweep_production \
      [reads_per_config] [--device cuda] [--cache-dir .bench_cache]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

READ_LENS = (100, 150, 300)
SUB_RATES = (0.002, 0.005, 0.01)
INDEL_RATES = (0.00025, 0.0005, 0.001)
BATCH = 16384


def run(index, genome, cache_dir: str, n: int = 50000,
        read_lens=READ_LENS, sub_rates=SUB_RATES, indel_rates=INDEL_RATES,
        device="cuda") -> list[dict]:
    """One JSON row per (read length, substitution rate, indel rate),
    printed as it comes and returned. `genome` is the index's records."""
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.sim.simulator import ShortReadSimulator

    pipe = BucketMapPipeline(index, device=device, batch_size=BATCH,
                             pair_batch=BATCH)
    rows = []
    warmed = False
    for rl in read_lens:
        sim_cfg = dataclasses.replace(index.config, read_len=rl)
        for sub in sub_rates:
            for indel in indel_rates:
                tag = (f"sweep_b{index.n_buckets}_rl{rl}_s{sub:g}_i{indel:g}"
                       f"_n{n}")
                fq = os.path.join(cache_dir, f"{tag}.fastq")
                gt = os.path.join(cache_dir, f"{tag}.position_ground_truth")
                if not os.path.exists(fq):
                    sim = ShortReadSimulator(sim_cfg, substitution_rate=sub,
                                             insertion_rate=indel,
                                             deletion_rate=indel, seed=11)
                    sim.read(genome)
                    sim.generate(cache_dir, tag, n)
                sam = os.path.join(cache_dir, f"{tag}.sam")
                if not warmed:
                    pipe.map_reads(world.first_reads(fq, BATCH),
                                   os.path.join(cache_dir, "sweep_warm.sam"))
                    warmed = True
                t0 = time.time()
                stats = pipe.map_fastq(fq, sam)
                dt = time.time() - t0
                mapped, correct = world.score_sam(sam, gt, index)
                _, tol5 = world.score_sam(sam, gt, index, tol=5)
                row = {"read_len": rl, "sub_rate": sub, "indel_rate": indel,
                       "reads": stats.num_reads,
                       "reads_per_sec": round(stats.num_reads / dt, 1),
                       "pct_mapped": round(mapped, 2),
                       "pct_correct_position": round(correct, 2),
                       "pct_correct_position_tol5": round(tol5, 2),
                       "locations_per_read": round(
                           stats.mapped_locations / max(1, stats.num_reads),
                           4)}
                print(json.dumps(row), flush=True)
                rows.append(row)
                os.remove(sam)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("reads", nargs="?", type=int, default=50000,
                    help="reads per configuration")
    ap.add_argument("--genome-mbp", type=float, default=1700.0)
    ap.add_argument("--cache-dir", default=".bench_cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the mapper (cuda or cpu)")
    args = ap.parse_args(argv)

    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.device import resolve_device

    resolve_device(args.device)
    t0 = time.time()
    genome = world.bench_genome(args.genome_mbp)
    print(f"[sweep] genome made in {time.time() - t0:.0f}s", file=sys.stderr,
          flush=True)
    index = world.bench_world(args.cache_dir, args.genome_mbp, genome=genome,
                              log=lambda m: print(m, file=sys.stderr))[0]
    print(f"[sweep] index: {index.n_buckets} buckets", file=sys.stderr,
          flush=True)
    run(index, genome, args.cache_dir, args.reads, device=args.device)


if __name__ == "__main__":
    main()
