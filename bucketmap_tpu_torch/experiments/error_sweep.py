"""Error-rate x read-length accuracy/throughput sweep (BASELINE config 5:
substitutions 0.2-1%, indels 0.025-0.1%, read lengths 100/150/300),
the port's `experiments/error_sweep.py`.

Usage:
  python -m bucketmap_tpu_torch.experiments.error_sweep [--genome-mbp 8] \
      [--reads 2000] [--device cuda]

Outputs one JSON line per configuration with %mapped, %correct-position
and reads/s on the named device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=8.0)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-lens", default="100,150,300")
    ap.add_argument("--sub-rates", default="0.002,0.01")
    ap.add_argument("--indel-rates", default="0.00025,0.001")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the mapper (cuda or cpu)")
    args = ap.parse_args(argv)

    from bucketmap_tpu_torch.config import MapperConfig
    from bucketmap_tpu_torch.index.builder import build_fine_index, build_index
    from bucketmap_tpu_torch.io.fastq import read_fastq
    from bucketmap_tpu_torch.io.sam import read_sam
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.sim.simulator import (ShortReadSimulator,
                                                   random_genome)

    genome = random_genome(int(args.genome_mbp * 1e6), seed=1, n_refs=2)
    for rl in [int(x) for x in args.read_lens.split(",")]:
        cfg = MapperConfig(read_len=rl)
        index = build_index(genome, cfg)
        build_fine_index(index)
        pipe = BucketMapPipeline(index, device=args.device, batch_size=1024,
                                 pair_batch=512)
        for sub in [float(x) for x in args.sub_rates.split(",")]:
            for indel in [float(x) for x in args.indel_rates.split(",")]:
                sim = ShortReadSimulator(cfg, substitution_rate=sub,
                                         insertion_rate=indel,
                                         deletion_rate=indel, seed=3)
                sim.read(genome)
                with tempfile.TemporaryDirectory() as d:
                    paths = sim.generate(d, "s", args.reads, vectorized=False)
                    batch = read_fastq(paths["fastq"])
                    t0 = time.time()
                    pipe.map_reads(batch, os.path.join(d, "s.sam"))
                    dt = time.time() - t0
                    with open(paths["position_gt"]) as f:
                        gt = [line.split() for line in f]
                    recs: dict[str, list] = {}
                    for r in read_sam(os.path.join(d, "s.sam")):
                        recs.setdefault(r["qname"], []).append(r)
                    ref_short = [n.split(" ")[0] for n in index.ref_names]
                    mapped = correct = 0
                    for i, (rid, pos, rc, _c) in enumerate(gt):
                        rl_ = recs.get(str(i), [])
                        if rl_:
                            mapped += 1
                        for r in rl_:
                            if (r["rname"] == ref_short[int(rid)]
                                    and (r["flag"] & 16 == 16) == bool(int(rc))
                                    and abs(r["pos"] - int(pos)) <= 10):
                                correct += 1
                                break
                    print(json.dumps({
                        "read_len": rl, "sub_rate": sub, "indel_rate": indel,
                        "pct_mapped": round(100 * mapped / len(gt), 2),
                        "pct_correct": round(100 * correct / len(gt), 2),
                        "reads_per_sec": round(args.reads / dt, 1),
                    }), flush=True)


if __name__ == "__main__":
    main()
