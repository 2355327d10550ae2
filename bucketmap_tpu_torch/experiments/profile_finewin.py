"""The tiled vote on real pairs, kernel against plain: the port's
counterpart of the JAX build's experiments/profile_finewin.py.

    python -m bucketmap_tpu_torch.experiments.profile_finewin [NP] [CH] \
        [--genome-mbp 1700] [--reads 1000000] [--cache-dir .bench_cache] \
        [--device cuda]

The first NP reads (default 40960) of the bench FASTQ (bench_torch.py's
cache, made here where it lacks it), each paired with its bucket and
strand from the simulator's .bucket_ground_truth file (random buckets
would miss every segment), sampled by FineLocator.prepare and voted on
the tiled table that build_fine_index_on_device makes, in chunks of CH
pairs (default 1024). The JAX script's two window backends become two
modes, each a search then the tally kernel per chunk:
  kernel  FineLocator.search: the fine_search kernel, one launch a chunk;
  plain   fine_search_plain, its plain-torch composition (targets,
          window_args, fine_window_plain, tally_args) on the same tensors.
Per mode the minimum of 5 runs in ms and us per pair and the accepted
count, the latency floor of one tiny op and its download, and a table by
stage (experiments/stages.py); the two modes' offset, votes and accept
must be identical.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

from bucketmap_tpu_torch.utils.debug import no_stage

MODES = ("kernel", "plain")


def ground_truth(path: str, n: int):
    """(bucket (n,) int32, is_rc (n,) bool) of the first n lines of a
    .bucket_ground_truth file ("bucket offset revcomp cigar")."""
    bucket, rc = [], []
    with open(path) as f:
        for line in itertools.islice(f, n):
            cols = line.split()
            bucket.append(int(cols[0]))
            rc.append(cols[2] == "1")
    return np.asarray(bucket, np.int32), np.asarray(rc, bool)


def locator(index, device):
    """A FineLocator on the tiled table that build_fine_index_on_device
    makes on `device`."""
    from bucketmap_tpu_torch.index.device_build import \
        build_fine_index_on_device
    from bucketmap_tpu_torch.ops.vote import FineLocator, locator_sample_tab

    fp, pt, steps, low_bits = build_fine_index_on_device(index, device)
    return FineLocator(index, device, {
        "fine_packed": fp, "fine_ptab": pt, "search_steps": steps,
        "low_bits": low_bits,
        "locator_sample_tab": locator_sample_tab(index, device)})


def lanes(fl, batch, bucket, is_rc) -> tuple:
    """The vote's per-pair tensors on fl's device: (bucket_ids int64,
    is_rc bool, samp_hash, samp_idx (P, p) int64, lengths (P,) int32), the
    samples from FineLocator.prepare on the reads (lengths cut at
    read_len, the quality gate on their phred ranks)."""
    from bucketmap_tpu_torch.device import host_tensor
    from bucketmap_tpu_torch.ops.host_encoding import window_quality_sums

    cfg = fl.cfg
    dev = fl.device
    lengths = np.minimum(batch.lengths, cfg.read_len).astype(np.int32)
    qual_ok = window_quality_sums(batch.quals, cfg.query_seed) >= \
        cfg.mapper_min_kmer_quality
    ln = host_tensor(lengths).to(dev)
    h, i = fl.prepare(host_tensor(np.asarray(batch.codes)).to(dev),
                      host_tensor(qual_ok).to(dev), ln)
    return (host_tensor(bucket.astype(np.int64)).to(dev),
            host_tensor(is_rc).to(dev), h.contiguous(), i.contiguous(), ln)


def vote(fl, lane_args, chunk: int, mode: str, stage=no_stage):
    """(offset, votes, accept) (P,) of every pair, chunk by chunk: the
    mode's search (stage "<mode> search"), then the tally kernel
    ("<mode> tally")."""
    import torch

    from bucketmap_tpu_torch.ops.vote import fine_search_plain, tally

    b, r, h, i, ln = lane_args
    outs = []
    for s in range(0, b.shape[0], chunk):
        sl = slice(s, s + chunk)
        with stage(f"{mode} search"):
            if mode == "kernel":
                targs = fl.search(b[sl], r[sl], h[sl], i[sl], ln[sl])
            else:
                lane = torch.arange(b[sl].shape[0], dtype=torch.int64,
                                    device=b.device)
                targs = (*fine_search_plain(
                    fl.fine_packed, fl.fine_ptab, b[sl], r[sl], lane,
                    h[sl], i[sl], ln[sl], fl.cfg.query_seed, fl.low_bits,
                    fl.search_steps), *fl._tally_consts(h.shape[1]))
        with stage(f"{mode} tally"):
            outs.append(tally(*targs))
    return tuple(torch.cat(c) for c in zip(*outs))


def decompose(fl, lane_args, chunk: int, stage=no_stage) -> dict:
    """Both modes' votes. Returns {mode: (offset, votes, accept),
    "equal": whether the modes' three are identical}."""
    import torch

    out = {m: vote(fl, lane_args, chunk, m, stage) for m in MODES}
    out["equal"] = all(torch.equal(a, b) for a, b in zip(*(out[m]
                                                            for m in MODES)))
    return out


def profile(fl, lane_args, chunk: int = 1024, trace_dir=None,
            log=print) -> dict:
    """Time both modes on the card (min of 5, as the JAX script) and by
    stage, print them, and raise unless the modes agree. Returns {mode:
    {"ms", "us_per_pair", "accepted"}, "floor_ms", "stages", "equal"}."""
    import torch

    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report, wall_ms)

    dev = fl.device
    n = lane_args[0].shape[0]
    x = torch.zeros(8, device=dev)
    floor = min(wall_ms(lambda: (x + 1).cpu(), dev, 5))
    log(f"fine_packed {tuple(fl.fine_packed.shape)} steps={fl.search_steps} "
        f"low_bits={fl.low_bits}; floor: {floor:.3f} ms (one tiny op and its "
        f"download, min of 5)")
    res = {"floor_ms": floor}
    for mode in MODES:
        ms = min(wall_ms(lambda: vote(fl, lane_args, chunk, mode), dev, 5))
        acc = int(vote(fl, lane_args, chunk, mode)[2].sum())
        res[mode] = {"ms": ms, "us_per_pair": ms / n * 1e3, "accepted": acc}
        log(f"{mode:7s}: min {ms:.3f} ms / {n} pairs ({ms / n * 1e3:.4f} "
            f"us/pair), accepted {acc}")
    checks = {}

    def run(clock):
        checks.update(decompose(fl, lane_args, chunk, clock))

    report = stage_report(run, dev, 3, trace_dir)
    print_stages(report, f"the tiled vote of {n} pairs in chunks of {chunk} "
                 f"by mode", log)
    log(f"parity: {'identical' if checks['equal'] else 'DIFFERENT'}")
    if not checks["equal"]:
        raise RuntimeError("profile_finewin: the kernel and plain modes "
                           "differ in offset, votes or accept")
    res.update(stages=report, equal=True)
    return res


def main(argv=None):
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import add_flags

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pairs", nargs="?", type=int, default=40960)
    ap.add_argument("chunk", nargs="?", type=int, default=1024)
    args = add_flags(ap).parse_args(argv)
    dev = resolve_device(args.device)
    index = world.bench_index(args.cache_dir, args.genome_mbp,
                              world.bench_config())[0]
    fastq, _, _ = world.bench_reads(args.cache_dir, args.reads,
                                    args.genome_mbp)
    gt = os.path.join(args.cache_dir, world.reads_name(
        args.genome_mbp, args.reads) + ".bucket_ground_truth")
    fl = locator(index, dev)
    lane_args = lanes(fl, world.first_reads(fastq, args.n_pairs),
                      *ground_truth(gt, args.n_pairs))
    if dev.type != "cuda":
        out = decompose(fl, lane_args, args.chunk)
        print(f"finewin on the CPU: accepted {int(out['kernel'][2].sum())}, "
              f"modes identical {out['equal']} (no device times on the CPU)")
        return out
    return profile(fl, lane_args, args.chunk,
                   args.trace_dir or os.path.join(args.cache_dir,
                                                  "profile_finewin_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
