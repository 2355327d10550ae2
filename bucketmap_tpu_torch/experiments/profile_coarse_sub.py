"""The fused coarse score of one batch in its three parts: the port's
counterpart of the JAX build's experiments/profile_coarse_sub.py.

    python -m bucketmap_tpu_torch.experiments.profile_coarse_sub \
        [--batch 16384] [--cache-dir .bench_cache] [--device cuda] ...

On the first --batch reads of the bench world (bench_torch.py's cache):
the k-mer sampling (CoarseMapper.sample_hashes), the row map
(CoarseMapper.gram_rows) and the coarse_score kernel, each a stage
(experiments/stages.py), their result held against CoarseMapper.score's
word for word; with the kernel's traffic, the occupancy rows it gathers.
"""

from __future__ import annotations

import os
import sys

from bucketmap_tpu_torch.mapper.device_pipeline import no_stage


def decompose(coarse, codes, qual_ok, lengths, stage=no_stage) -> dict:
    """CoarseMapper.score's fused branch as the stages "sampling", "row
    map" and "kernel". Returns {"score": (cm, cc, planes) shaped as score
    gives them, "equal": whether they equal score's, "rows": the gathered
    occupancy rows (B*2*s, nq)}."""
    import torch

    from bucketmap_tpu_torch.ops.coarse import coarse_score

    B = codes.shape[0]
    w = coarse.qgram_words.shape[1]
    with stage("sampling"):
        both, _, _ = coarse.sample_hashes(codes, qual_ok, lengths)
    with stage("row map"):
        rows = coarse.gram_rows(both)
    with stage("kernel"):
        cm, cc, planes = coarse_score(coarse.qgram_words, rows,
                                      coarse.n_buckets,
                                      coarse.cfg.mapper_samples)
    got = (cm.reshape(B, 2, w), cc.reshape(B, 2, w),
           planes.reshape(B, 2, -1, w))
    want = coarse.score(codes, qual_ok, lengths, coarse.n_buckets)[:3]
    return {"score": got, "rows": rows,
            "equal": all(torch.equal(a, b) for a, b in zip(got, want))}


def profile(dm, packed, reps: int = 3, trace_dir=None, log=print) -> dict:
    """Time decompose on the card (stages.stage_report) and print the
    table, the kernel's gathered bytes and the check."""
    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report)
    from bucketmap_tpu_torch.ops.encoding import unpack_reads

    cfg = dm.cfg
    codes, qual_ok, lengths = unpack_reads(packed, cfg.read_len,
                                           cfg.query_seed)
    out = {}

    def run(clock):
        out.update(decompose(dm.coarse, codes, qual_ok, lengths, clock))

    report = stage_report(run, dm.device, reps, trace_dir)
    rows = out["rows"]
    w = dm.coarse.qgram_words.shape[1]
    print_stages(report, f"the fused coarse score of {packed.shape[0]} reads "
                 f"({rows.shape[0] // cfg.mapper_samples} read-strands x "
                 f"{cfg.mapper_samples} samples x {w} words)", log)
    log(f"kernel traffic {rows.numel() * w * 4 / 1e9:.2f} GB gathered "
        f"({rows.numel()} occupancy rows of {w * 4 / 1024:.1f} KiB); equal "
        f"to CoarseMapper.score {out['equal']}")
    return {"stages": report, "equal": out["equal"]}


def main(argv=None):
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import arguments, load
    from bucketmap_tpu_torch.ops.encoding import unpack_reads

    args = arguments(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    pipe, _, packed = load(args)
    if dev.type != "cuda":
        cfg = pipe.cfg
        out = decompose(pipe.device.coarse, *unpack_reads(
            packed, cfg.read_len, cfg.query_seed))
        print(f"coarse score on the CPU: equal to CoarseMapper.score "
              f"{out['equal']} (no device times on the CPU)")
        return out
    return profile(pipe.device, packed, args.reps, args.trace_dir or
                   os.path.join(args.cache_dir, "profile_coarse_sub_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
