"""Parameter sweep: distinguishability (-d) x base quality (-b),
mirroring the reference's experiments/distinguishability_quality_filter
(SURVEY B7). Reports candidate buckets/read, remaining good k-mers, and
%-correct-bucket on simulated reads, one JSON row per (d, b), the rows
of `experiments/sweep.py`.

Usage:
  python -m bucketmap_tpu_torch.experiments.sweep [--genome-mbp 4] \
      [--reads 2000] [--d-values 0,0.3,0.5,0.7,0.9] [--b-values 0,25] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=4.0)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--d-values", default="0,0.3,0.5,0.7,0.9")
    ap.add_argument("--b-values", default="0,25")
    ap.add_argument("--sub-rate", type=float, default=0.002)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coarse query (cuda or cpu)")
    args = ap.parse_args(argv)

    from bucketmap_tpu_torch.config import MapperConfig
    from bucketmap_tpu_torch.index.builder import build_index
    from bucketmap_tpu_torch.ops.coarse import CoarseMapper
    from bucketmap_tpu_torch.sim.simulator import (ShortReadSimulator,
                                                   random_genome)

    base_cfg = MapperConfig()
    genome = random_genome(int(args.genome_mbp * 1e6), seed=1, n_refs=2)
    sim = ShortReadSimulator(base_cfg, substitution_rate=args.sub_rate, seed=2)
    sim.read(genome)
    n = args.reads
    codes = np.zeros((n, base_cfg.read_len), np.uint8)
    quals = np.full((n, base_cfg.read_len), 36, np.uint8)
    lens = np.zeros(n, np.int32)
    gt = []
    for i in range(n):
        c, bucket, _start, rc, _ = sim.sample()
        c = c[: base_cfg.read_len]
        codes[i, : len(c)] = c
        lens[i] = len(c)
        gt.append((bucket, rc))

    for d in [float(x) for x in args.d_values.split(",")]:
        for b in [int(x) for x in args.b_values.split(",")]:
            cfg = dataclasses.replace(base_cfg, distinguishability=d,
                                      average_base_quality=b)
            index = build_index(genome, cfg)
            mapper = CoarseMapper(index, args.device)
            cand, counts, num_good = mapper.query_batch(codes, quals, lens)
            correct = sum(
                1 for i, (bucket, rc) in enumerate(gt)
                if bucket in cand[i, 1 if rc else 0])
            row = {
                "d": d, "b": b,
                "candidates_per_read": float(counts.sum() / n),
                "good_kmers_per_read": float(num_good.mean()),
                "pct_correct_bucket": 100.0 * correct / n,
            }
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
