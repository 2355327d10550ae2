"""An align sub-batch in its parts: the port's counterpart of the JAX
build's experiments/profile_align.py.

    python -m bucketmap_tpu_torch.experiments.profile_align [N] [PB] \
        [--genome-mbp 1700] [--cache-dir .bench_cache] [--device cuda]

N pairs (default 32768) drawn as the JAX script draws them on the bench
world's index (bench_torch.py's cache, made here where it lacks it):
windows at random in-bucket offsets, each query the window's 300 bases
with ~0.2% substitutions. BandedAligner.align_batch_runs_stream (the
device-RLE path: the dp_runs kernel) aligns them in sub-batches of PB
(default 8192) pairs after one warm-up sub-batch, three trials, and
once more by part with a StageClock as the aligner's stage hook (each
sub-batch's padding and upload, query packing, runs vector, download
and the consumer). Then the first PB pairs in parts, each the mean of 4
calls and a stage (experiments/stages.py): the text windows, the DP
alone (the dp_fwd kernel and the row max), the DP with the plain-torch
cell traceback (a loop of ~Q + 2*lo steps, launch-bound), the runs
vector (dp_runs and its packing) and the runs vector with its download.
Each row after "windows" includes the windows, as each of the JAX
script's rows does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from bucketmap_tpu_torch.utils.debug import no_stage

Q, QLEN = 304, 300            # the JAX script's query width and length
SUB_RATE = 0.002              # its substitution rate


def pairs(index, n: int, seed: int = 3):
    """(qcodes (n, Q) uint8, qlen, bucket_ids, offsets (n,) int32, is_rc
    (n,) bool) drawn with the JAX script's generator in its call order
    (experiments/profile_align.py:32-53): bucket ids, offsets, the
    substitution mask, the substituted bases. The window bases are
    decoded from the index's packed buckets (uint32 words, 16 bases
    each, first base in the low bits)."""
    rng = np.random.default_rng(seed)
    blen = np.asarray(index.bucket_lengths)
    bids = rng.integers(0, index.n_buckets, n).astype(np.int32)
    qlen = np.full(n, QLEN, np.int32)
    offs = (rng.random(n) * (blen[bids] - 400)).astype(np.int32)
    if (blen[bids] < 400).any():
        raise ValueError("a drawn bucket is shorter than 400 bases: the "
                         "JAX script's draw has no window there")
    bp = np.asarray(index.buckets_packed, np.uint32)
    w0 = offs // 16
    words = bp[bids[:, None], w0[:, None] + np.arange(20)]
    bases = ((words[:, :, None] >> (2 * np.arange(16, dtype=np.uint32)))
             & 3).reshape(n, 320).astype(np.uint8)
    start = (offs - w0 * 16)[:, None] + np.arange(QLEN)
    qcodes = np.zeros((n, Q), np.uint8)
    qcodes[:, :QLEN] = np.take_along_axis(bases, start, axis=1)
    sub = rng.random((n, Q)) < SUB_RATE
    qcodes = np.where(sub, (qcodes + 1 + (rng.random((n, Q)) * 3)
                            .astype(np.uint8)) % 4, qcodes).astype(np.uint8)
    return qcodes, qlen, bids, offs, np.zeros(n, bool)


def parts(al, qcodes, qlen, bucket_ids, offsets, is_rc) -> list:
    """[(stage, callable)] of the decomposition of these pairs on the
    aligner's device, in the JAX script's order (its :79-129)."""
    import torch

    from bucketmap_tpu_torch.device import host_tensor, upload_u32
    from bucketmap_tpu_torch.ops.align import dp_fwd, pack_qcodes

    dev = al.device
    P, W = qcodes.shape

    def put(a, dtype):
        return host_tensor(np.asarray(a, dtype)).to(dev)

    qc = put(qcodes, np.uint8)
    args = (put(qlen, np.int32), put(bucket_ids, np.int32),
            put(offsets, np.int32), put(is_rc, np.bool_),
            put(al._width(qlen, bucket_ids, offsets), np.int32))
    ql, bi, of, rc, wd = args
    qp = upload_u32(pack_qcodes(qcodes), dev)
    run_cap = -(-al.run_cap_per_pair * P // 2) * 2

    def windows():
        return al._text_windows(W, bi, of, rc, wd)

    def dp_only():
        textp, band, lo = windows()
        return dp_fwd(textp, qc, ql, wd, band, lo)[1].amax(dim=1)

    def dp_traceback():
        sc, bg, ops = al._align_core(qc, *args, tb_mode="cell")
        return sc, bg, ops.sum(dtype=torch.int32)

    def runs():
        return al._align_runs(qp, *args, run_cap=run_cap)

    return [("windows", windows), ("dp-only", dp_only),
            ("dp+traceback", dp_traceback),
            ("runs vec (no download)", runs),
            ("runs vec + download", lambda: runs().cpu())]


def decompose(al, qcodes, qlen, bucket_ids, offsets, is_rc,
              stage=no_stage) -> dict:
    """Run each of parts() once under `stage`. Returns {"runs": the
    downloaded runs vector, "dp_score": the DP-only scores (P,), "equal":
    whether the download equals the undownloaded _align_runs call, and the
    DP-only scores equal the runs vector's score field and the cell
    traceback's}."""
    import torch

    out = {}
    for name, fn in parts(al, qcodes, qlen, bucket_ids, offsets, is_rc):
        with stage(name):
            out[name] = fn()
    P = len(bucket_ids)
    vec = out["runs vec + download"]
    score = out["dp-only"].cpu()
    equal = (torch.equal(vec, out["runs vec (no download)"].cpu())
             and torch.equal(score, vec[4:4 + P])
             and torch.equal(score, out["dp+traceback"][0].cpu()))
    return {"runs": vec, "dp_score": score, "equal": equal}


def profile(index, device, n: int = 32768, pb: int = 8192, trace_dir=None,
            log=print) -> dict:
    """Time the stream and the decomposition on the card and print them;
    raise where a check fails (the decomposition's equalities, the pairs
    consumed). Returns {"pairs_per_s": [3 trials], "stream": the stream by
    part (BandedAligner.stage), "stages": the decomposition by part,
    "mean_ms": {part: mean of 4 calls}, "equal", "consumed"}."""
    import torch

    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report, table,
                                                        wall_ms)
    from bucketmap_tpu_torch.ops.align import BandedAligner, band_geometry

    cfg = index.config
    dev = torch.device(device)
    ps = pairs(index, n)
    al = BandedAligner(index, dev, pair_batch=pb)
    log(f"band geometry for Q={Q}, indel_rate={cfg.indel_rate}: "
        f"{band_geometry(Q, cfg.indel_rate)}")
    got = {"n": 0}

    def emit(s, e, *_):
        got["n"] += e - s

    t0 = time.perf_counter()
    al.align_batch_runs_stream(*(a[:pb] for a in ps), emit)
    log(f"warmup {time.perf_counter() - t0:.1f}s")
    rates = []
    for _ in range(3):
        got["n"] = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        al.align_batch_runs_stream(*ps, emit)
        dt = time.perf_counter() - t0
        rates.append(n / dt)
        log(f"runs-mode: {n / dt:.0f} pairs/s ({dt * 1000 * pb / n:.1f} ms "
            f"per {pb}-pair sub-batch, {got['n']} consumed)")
    consumed = got["n"]

    def stream(clock):
        prev, al.stage = al.stage, clock
        try:
            al.align_batch_runs_stream(*ps, emit)
        finally:
            al.stage = prev

    by_part = stage_report(stream, dev, 3, trace_dir)
    print_stages(by_part, f"the runs stream of {n} pairs by part "
                 f"({-(-n // pb)} sub-batches of {pb}; BandedAligner.stage)",
                 log)
    head = tuple(a[:pb] for a in ps)
    means = {name: float(np.mean(wall_ms(fn, dev, 4)))
             for name, fn in parts(al, *head)}
    checks = {}

    def run(clock):
        checks.update(decompose(al, *head, stage=clock))

    report = stage_report(run, dev, 3, trace_dir)
    print_stages(report, f"an align sub-batch of {pb} pairs by part (Q {Q}, "
                 f"band geometry {band_geometry(Q, cfg.indel_rate)})", log)
    log(table([(name, ms) for name, ms in means.items()],
              ("part (JAX's rows)", f"ms / {pb} pairs, mean of 4")))
    tb = report["stages"]["dp+traceback"]["launches"]
    log(f"the cell traceback is a loop of ~Q + 2*lo steps of plain torch: "
        f"{'not measured' if tb is None else tb} launches in dp+traceback, "
        f"launch-bound; the decomposition's checks {checks['equal']}")
    if not checks["equal"] or consumed != n:
        raise RuntimeError(f"profile_align: the decomposition's checks "
                           f"{checks['equal']}, pairs consumed {consumed} of "
                           f"{n}")
    return {"pairs_per_s": rates, "stream": by_part, "stages": report,
            "mean_ms": means, "equal": checks["equal"], "consumed": consumed}


def main(argv=None):
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import add_flags
    from bucketmap_tpu_torch.ops.align import BandedAligner

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pairs", nargs="?", type=int, default=32768)
    ap.add_argument("pair_batch", nargs="?", type=int, default=8192)
    args = add_flags(ap, ("genome-mbp", "cache-dir", "trace-dir",
                          "device")).parse_args(argv)
    dev = resolve_device(args.device)
    index = world.bench_index(args.cache_dir, args.genome_mbp,
                              world.bench_config())[0]
    if dev.type != "cuda":
        al = BandedAligner(index, dev, pair_batch=args.pair_batch)
        out = decompose(al, *pairs(index, min(args.n_pairs,
                                              args.pair_batch)))
        print(f"align decomposition on the CPU: checks {out['equal']} (no "
              f"device times on the CPU)")
        return out
    return profile(index, dev, args.n_pairs, args.pair_batch,
                   args.trace_dir or os.path.join(args.cache_dir,
                                                  "profile_align_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
