"""The at-max candidate select of one batch in its parts: the port's
counterpart of the JAX build's experiments/profile_select.py.

    python -m bucketmap_tpu_torch.experiments.profile_select \
        [--batch 16384] [--cache-dir .bench_cache] [--device cuda] ...

On the first --batch reads of the bench world (bench_torch.py's cache),
after the fused coarse score: CoarseMapper.select's policy (each
read-strand's max and at-max count, the clears), the flag words of the
buckets at the max (at_max_words: the bit-plane compare) and the first C
set bits as bucket ids (set_bit_ids: running popcount, word search,
halving ladder), each a stage (experiments/stages.py), their result held
against CoarseMapper.select's, with the candidates per read-strand.
"""

from __future__ import annotations

import os
import sys

from bucketmap_tpu_torch.mapper.device_pipeline import no_stage


def decompose(coarse, cm, cc, planes, give_up, stage=no_stage) -> dict:
    """CoarseMapper.select over a score as the stages "policy", "at-max
    words" and "set bits". Returns {"cand", "counts", "equal": whether
    they equal select's}."""
    import torch

    with stage("policy"):
        max_hits, live, counts = coarse.policy(cm, cc, give_up)
    with stage("at-max words"):
        eq = coarse.at_max_words(planes, max_hits, live, coarse.n_buckets)
    with stage("set bits"):
        cand = coarse.set_bit_ids(eq)
    want = coarse.select(cm, cc, planes, give_up)
    equal = torch.equal(cand, want[0]) and torch.equal(counts, want[1])
    return {"cand": cand, "counts": counts, "equal": equal}


def scored(dm, packed):
    """(cm, cc, planes, give_up) of the fused coarse score of `packed`."""
    from bucketmap_tpu_torch.ops.encoding import unpack_reads

    cfg = dm.cfg
    codes, qual_ok, lengths = unpack_reads(packed, cfg.read_len,
                                           cfg.query_seed)
    cm, cc, planes, _, give_up = dm.coarse.score(codes, qual_ok, lengths,
                                                 dm.coarse.n_buckets)
    return cm, cc, planes, give_up


def profile(dm, packed, reps: int = 3, trace_dir=None, log=print) -> dict:
    """Time decompose on the card (stages.stage_report) and print the
    table, the candidates per read-strand and the check."""
    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report)

    args = scored(dm, packed)
    out = {}

    def run(clock):
        out.update(decompose(dm.coarse, *args, stage=clock))

    report = stage_report(run, dm.device, reps, trace_dir)
    planes = args[2]
    print_stages(report, f"the at-max select of {packed.shape[0]} reads "
                 f"({planes.shape[2]} bit planes x {planes.shape[3]} words, "
                 f"C {dm.cfg.max_candidate_buckets})", log)
    per = float((out["cand"] >= 0).sum()) / (2 * packed.shape[0])
    log(f"candidates per read-strand {per:.4f}; equal to CoarseMapper.select "
        f"{out['equal']}")
    return {"stages": report, "equal": out["equal"],
            "candidates_per_read_strand": per}


def main(argv=None):
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import arguments, load

    args = arguments(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    pipe, _, packed = load(args)
    if dev.type != "cuda":
        out = decompose(pipe.device.coarse, *scored(pipe.device, packed))
        print(f"select on the CPU: equal to CoarseMapper.select "
              f"{out['equal']} (no device times on the CPU)")
        return out
    return profile(pipe.device, packed, args.reps, args.trace_dir or
                   os.path.join(args.cache_dir, "profile_select_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
