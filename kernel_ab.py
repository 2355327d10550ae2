#!/usr/bin/env python3
"""The kernels of this tree against another tree's, on the main path's
own inputs, on one NVIDIA GPU.

    python3 kernel_ab.py --parent DIR [--genome-mbp 1700]

DIR holds another checkout of this repository (`git archive <commit> |
tar -x -C DIR`). Each tree's kernel library is built from its own
sources. The inputs are chip_smoke.py phase 5's: the coarse score's
sample rows of the bench world's first batch of 16,384 reads (32,768
read-strands), and the first 4096-lane vote chunk of that batch. Both
libraries must give the same outputs, equal to the plain versions. Each
kernel is timed on the device (chip_smoke.DeviceTimer) in turns: the
other tree, this tree, this tree, the other tree. The coarse score runs
at the full batch with the L2 flushed, on the batch's own rows and on
the same rows folded into the table's first 8,192 rows (26.6 MB, held
in the L2 after their first gathers), which times the kernel when the
L2 serves its repeated gathers. Controlled variants of
the window rows show what sets the window kernel's pace: the chunk's own
rows with the L2 flushed and warm, the same rows sorted by table row (no
scatter), and the first 4096 windows repeated (6 MB, held in the L2);
beside them, a library gather of the same table rows
(torch.nn.functional.embedding_bag, three rows per window, the table
read as float32) times the access pattern without the kernel. The tally
runs on the chunk's flags and with every proposal valid. Last, the
host's time per call of this tree's wrappers, and one call between two
events on an idle device, as the runs before the redesign timed the
kernels. The vote search of the chunk runs both ways: this tree's
fused fine_search on the chunk's lanes against the other tree's
window_args + fine_window + tally_args (its ops/vote.py on its kernel
library) on the same lanes, the proposals word for word equal, as one
call on an idle device in turns, and one call of each under
torch.profiler (its kernels and their device time).
The presence gather of the staged branch runs at the full
batch (the same sample rows, L2 flushed). The align stage runs on the
first 16,384-pair sub-batch of the batch's located pairs (align mode
over the batch): the whole device-RLE sub-batch (`_align_runs`) as one
call on an idle device, each tree's own aligner (its ops/align.py on its
kernel library), the vectors word for word equal; the DP body of each
tree's `dp_fwd` (the same function: every direction byte and the final
row) on the device with the L2 flushed; and the fused `dp_runs`, in
turns where the other tree has it, else this tree's alone. The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16384
L2_ROWS = 8192        # table rows of the coarse score's L2-resident variant


def load_kernels(tree: str, name: str):
    """A tree's kernels.py as module `name`; it builds into that tree."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tree, "bucketmap_tpu_torch", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_align(tree: str, kernels_mod):
    """A tree's ops/align.py as module `tree_align`, its kernels those of
    kernels_mod (the rest of the package is this tree's)."""
    spec = importlib.util.spec_from_file_location(
        "tree_align", os.path.join(tree, "bucketmap_tpu_torch", "ops",
                                   "align.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.kernels = kernels_mod
    return mod


def load_vote(tree: str, kernels_mod):
    """A tree's ops/vote.py as module `tree_vote`, its kernels those of
    kernels_mod (the rest of the package is this tree's)."""
    spec = importlib.util.spec_from_file_location(
        "tree_vote", os.path.join(tree, "bucketmap_tpu_torch", "ops",
                                  "vote.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.kernels = kernels_mod
    return mod


def in_turns(run_of, fn):
    """fn(run) for the other tree, this tree, this tree, the other tree:
    {side: [time, time]}."""
    times = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        times[side].append(fn(run_of[side]))
    return times


def coarse_runner(torch, lib, table, rows, bound: int, s: int):
    """A call of one library's bm_coarse_score on these inputs, into
    outputs allocated once (the wrapper's shapes)."""
    R, nq = rows.shape
    B2, w = R // s, table.shape[1]
    n_planes = s.bit_length()
    dev = table.device
    outs = (torch.empty((B2, w), dtype=torch.int32, device=dev),
            torch.empty((B2, w), dtype=torch.int32, device=dev),
            torch.empty((B2, n_planes, w), dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = lib.bm_coarse_score(
            table.data_ptr(), w, rows.data_ptr(), B2, s, nq, n_planes,
            int(bound), *(o.data_ptr() for o in outs), stream)
        if err:
            raise RuntimeError(f"bm_coarse_score: cudaError {err}")
        return outs
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="another checkout of this repository")
    ap.add_argument("--genome-mbp", type=float, default=1700.0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import (CallLog, DeviceTimer, call_ms,
                            card_name_and_limit, log, traced_kernels)
    from bucketmap_tpu_torch import kernels, world
    from bucketmap_tpu_torch.device import upload_u32
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.ops import align
    from bucketmap_tpu_torch.ops.coarse import (coarse_score_plain,
                                                presence_gather_plain)
    from bucketmap_tpu_torch.ops.encoding import unpack_reads
    from bucketmap_tpu_torch.ops.vote import (fine_search_plain, fine_window,
                                              fine_window_plain, tally,
                                              tally_plain)

    card = card_name_and_limit()
    log(card)
    dev = torch.device("cuda", 0)
    parent = os.path.abspath(args.parent)
    parent_kernels = load_kernels(parent, "parent_kernels")
    libs = {"this": kernels.library(), "parent": parent_kernels.library()}

    index, fastq, _, world_s = world.bench_world(
        os.path.join(HERE, ".bench_cache"), args.genome_mbp, BATCH)
    pipe = BucketMapPipeline(index, device=dev, batch_size=BATCH,
                             pair_batch=BATCH)
    dm = pipe.device
    cfg = index.config
    codes, quals, seg_len, _, _ = pipe._all_segments(
        world.first_reads(fastq, BATCH))
    packed = dm.pack(codes, quals, seg_len)
    both, _, _ = dm.coarse.sample_hashes(
        *unpack_reads(packed, cfg.read_len, cfg.query_seed))
    rows_all = dm.coarse.gram_rows(both)
    lanes = dm.compact_lanes(packed)
    vargs = dm.chunk_args(lanes, 0)
    wargs, tgt_idx = dm.fine.window_args(*vargs)
    P, p = vargs[2].shape
    targs = dm.fine.tally_args(fine_window_plain(*wargs).reshape(P, p, -1),
                               tgt_idx, vargs[1])
    log(f"[inputs] {args.genome_mbp:g} Mbp world ready in {world_s:.1f} s; "
        f"{wargs[1].shape[0]} windows, {P} pairs x {targs[0].shape[1]} "
        f"proposals ({int((targs[1] != 0).sum())} valid)")

    stream = torch.cuda.current_stream(dev).cuda_stream

    def window_fn(lib, a):
        ftf, frow, lo, hi, low, n_occ, low_bits = a
        out = torch.empty((frow.shape[0], n_occ), dtype=torch.int32,
                          device=dev)

        def run():
            err = lib.bm_fine_window(
                ftf.data_ptr(), ftf.shape[0], frow.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), low.data_ptr(), frow.shape[0], n_occ, low_bits,
                out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"bm_fine_window: cudaError {err}")
            return (out,)
        return run

    def tally_fn(lib, a):
        prop, valid, p_, n_occ, indel, min_vote, read_len = a
        outs = [torch.empty(prop.shape[0], dtype=torch.int32, device=dev)
                for _ in range(3)]

        def run():
            err = lib.bm_tally(
                prop.data_ptr(), valid.data_ptr(), prop.shape[0], p_, n_occ,
                indel, min_vote, read_len, *(o.data_ptr() for o in outs),
                stream)
            if err:
                raise RuntimeError(f"bm_tally: cudaError {err}")
            return tuple(outs)
        return run

    timer = DeviceTimer(torch, dev)
    result = {"card": card, "windows": int(wargs[1].shape[0]), "pairs": P}

    # the coarse score at the full batch, L2 flushed: the batch's rows,
    # and the same rows folded into L2_ROWS table rows
    s, n, table = cfg.mapper_samples, index.n_buckets, dm.coarse.qgram_words
    res = {"read_strands": rows_all.shape[0] // s}
    for cname, rows in (("batch", rows_all), ("l2_resident",
                                              rows_all % L2_ROWS)):
        runs = {side: coarse_runner(torch, lib, table, rows, n, s)
                for side, lib in libs.items()}
        want = coarse_score_plain(table, rows, n, s)
        for side, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"coarse_score ({side}, {cname}) "
                                   f"disagrees with its plain version")
        del want, got
        torch.cuda.empty_cache()
        times = {side: [] for side in runs}
        for side in ("parent", "this", "this", "parent"):
            times[side].append(timer.ms(runs[side], reps=5, cold=True))
        res[f"{cname}_cold"] = times
        log(f"[coarse_score] {cname}, {rows.shape[0] // s} read-strands x "
            f"{s} samples x {table.shape[1]} words, L2 flushed: device ms "
            f"this tree {times['this']}, other tree {times['parent']}")
        del runs
    result["coarse_score"] = res

    ftf, frow = wargs[0], wargs[1]
    order = torch.argsort(frow.to(torch.int64).clamp(0, ftf.shape[0] - 3))
    window_cases = {
        "chunk": wargs,
        "sorted": (ftf, *(t[order].contiguous() for t in wargs[1:5]),
                   *wargs[5:]),
        "l2_resident": (ftf, frow[:4096].repeat(frow.shape[0] // 4096 + 1)
                        [:frow.shape[0]].contiguous(), *wargs[2:]),
    }
    all_valid = torch.ones_like(targs[1])
    tally_cases = {"chunk": targs,
                   "all_valid": (targs[0], all_valid, *targs[2:])}
    f3 = (frow.to(torch.int64).clamp(0, ftf.shape[0] - 3)[:, None]
          + torch.arange(3, device=dev)).reshape(-1)
    table_f32 = ftf.view(torch.float32)
    bags = torch.arange(0, f3.shape[0], 3, device=dev)

    def gather():
        return torch.nn.functional.embedding_bag(f3, table_f32, bags,
                                                 mode="sum")
    result["library_gather"] = {
        "cold": timer.ms(gather, cold=True), "warm": timer.ms(gather)}
    log(f"[gather] embedding_bag of the chunk's {f3.shape[0]} table rows: "
        f"device {result['library_gather']['cold']:.4f} ms with the L2 "
        f"flushed, {result['library_gather']['warm']:.4f} ms warm")
    for kname, fn_of, cases, plain in (
            ("fine_window", window_fn, window_cases, fine_window_plain),
            ("tally", tally_fn, tally_cases, tally_plain)):
        res = {}
        for cname, a in cases.items():
            runs = {side: fn_of(libs[side], a) for side in libs}
            want = plain(*a)
            if kname == "fine_window":
                want = (want,)
            for side, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"{kname} ({side}, {cname}) disagrees "
                                       f"with its plain version")
            temps = (("cold", True), ("warm", False)) if kname == "fine_window" \
                else (("warm", False),)
            for temp, cold in temps:
                times = {side: [] for side in runs}
                for side in ("parent", "this", "this", "parent"):
                    times[side].append(timer.ms(runs[side], cold=cold))
                res[f"{cname}_{temp}"] = times
                log(f"[{kname}] {cname}, {temp} L2: device ms this tree "
                    f"{times['this']}, other tree {times['parent']}")
        wrapper = ((lambda: fine_window(*wargs)) if kname == "fine_window"
                   else (lambda: tally(*targs)))
        wrapper()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            wrapper()
        res["wrapper_host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        res["one_call_ms"] = call_ms(torch, wrapper)
        log(f"[{kname}] this tree's wrapper: host {res['wrapper_host_ms']:.4f} "
            f"ms per call; one call on an idle device "
            f"{res['one_call_ms']:.4f} ms")
        result[kname] = res

    # the vote search of the chunk: the fused kernel against the other
    # tree's plain-torch arguments around its window kernel
    parent_vote = load_vote(parent, parent_kernels)
    parent_fine = parent_vote.FineLocator(index, dev, dm.tables)

    def parent_search():
        va = dm.chunk_args(lanes, 0)
        wa, ti = parent_fine.window_args(*va)
        return parent_fine.tally_args(
            parent_vote.fine_window(*wa).reshape(P, p, -1), ti, va[1])[:2]

    searches = {"parent": parent_search,
                "this": lambda: dm.fine.search_lanes(
                    *dm.chunk_lanes(lanes, 0))[:2]}
    want = fine_search_plain(dm.fine.fine_packed, dm.fine.fine_ptab,
                             *dm.chunk_lanes(lanes, 0), cfg.query_seed,
                             dm.fine.low_bits, dm.fine.search_steps)
    for side, run in searches.items():
        got = run()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"the vote search ({side}) disagrees with "
                               f"fine_search_plain")
    res = {"one_call": in_turns(searches, lambda r: call_ms(torch, r)),
           "traced": traced_kernels(torch, dev, searches)}
    result["fine_search"] = res
    log(f"[fine_search] the chunk's vote search, {P} lanes x {p} samples: "
        f"one call on an idle device, ms this tree (fine_search) "
        f"{res['one_call']['this']}, other tree (window_args + fine_window "
        f"+ tally_args) {res['one_call']['parent']}; one call traced "
        f"(device kernels, their ms, copies): this tree "
        f"{res['traced']['this']}, other tree {res['traced']['parent']}")

    # the presence gather at the full batch, L2 flushed
    R, nq = rows_all.shape
    w = table.shape[1]
    want = presence_gather_plain(table, rows_all)
    runs = {}
    for side, lib in libs.items():
        out = torch.empty((R, w), dtype=torch.int32, device=dev)

        def run(lib=lib, out=out):
            err = lib.bm_presence_gather(table.data_ptr(), w,
                                         rows_all.data_ptr(), R, nq,
                                         out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"bm_presence_gather: cudaError {err}")
            return out
        if not torch.equal(run(), want):
            raise RuntimeError(f"presence_gather ({side}) disagrees with its "
                               f"plain version")
        runs[side] = run
    del want
    times = in_turns(runs, lambda r: timer.ms(r, reps=5, cold=True))
    result["presence_gather"] = {"samples": R, "cold": times}
    log(f"[presence_gather] full batch, {R} samples x {nq} rows x {w} words, "
        f"L2 flushed: device ms this tree {times['this']}, other tree "
        f"{times['parent']}")
    del runs, out, pipe, dm, lanes, vargs, wargs, tgt_idx, targs
    torch.cuda.empty_cache()

    # the align stage on the batch's first 16,384-pair sub-batch
    al_pipe = BucketMapPipeline(index, device=dev, align=True,
                                batch_size=BATCH, pair_batch=BATCH)
    al = al_pipe.aligner
    with CallLog(al, "_sub_batch") as sub:
        al_pipe.map_fastq(fastq, os.path.join(HERE, ".bench_cache",
                                              "kernel_ab_align.sam"))
    qc, args_dev = sub.first["_sub_batch"]
    parent_align = load_align(parent, parent_kernels)
    aligners = {"this": al,
                "parent": parent_align.BandedAligner(index, dev,
                                                     pair_batch=BATCH)}
    P = qc.shape[0]
    qpk = upload_u32(align.pack_qcodes(qc), dev)
    run_cap = -(-al.run_cap_per_pair * P // 2) * 2
    sub = {side: (lambda a=a: a._align_runs(qpk, *args_dev, run_cap=run_cap))
           for side, a in aligners.items()}
    vecs = {side: run() for side, run in sub.items()}
    if not torch.equal(vecs["this"], vecs["parent"]):
        raise RuntimeError("the two trees' sub-batch vectors differ")
    times = in_turns(sub, lambda r: call_ms(torch, r, reps=5, warmup=1))
    result["align_sub_batch"] = {"pairs": P, "one_call": times,
                                 "header": vecs["this"][:4].tolist()}
    log(f"[align] one whole sub-batch ({P} pairs), one call on an idle "
        f"device: ms this tree {times['this']}, other tree "
        f"{times['parent']}; header {vecs['this'][:4].tolist()}")

    # each tree's DP body (dp_fwd) and this tree's fused DP, L2 flushed
    qlen, bids, offs, is_rc, width = args_dev
    Qp = qpk.shape[1] * 16
    qfull = torch.zeros((P, Qp), dtype=torch.uint8, device=dev)
    qfull[:, :qc.shape[1]] = torch.from_numpy(qc.astype("uint8")).to(dev)
    textp, band, lo = al._text_windows(Qp, bids, offs, is_rc, width)
    full = (textp, qfull, qlen, width, band, lo)
    fwd = {"this": lambda: align.dp_fwd(*full),
           "parent": lambda: parent_align.dp_fwd(*full)}
    got = {side: run() for side, run in fwd.items()}
    if not all(torch.equal(a, b) for a, b in zip(got["this"],
                                                  got["parent"])):
        raise RuntimeError("the two trees' dp_fwd outputs differ")
    del got
    times = in_turns(fwd, lambda r: timer.ms(r, reps=5, cold=True))
    result["dp_fwd"] = {"pairs": P, "Q": Qp, "band": band, "cold": times}
    log(f"[dp_fwd] {P} pairs, Q {Qp}, band {band}, L2 flushed: device ms "
        f"this tree {times['this']}, other tree {times['parent']}")
    # the fused DP: in turns where the other tree has it too
    fused = {side: (lambda m=m: m.dp_runs(*full, True))
             for side, m in (("this", align), ("parent", parent_align))
             if hasattr(m, "dp_runs")}
    got = {side: run() for side, run in fused.items()}
    if any(not all(torch.equal(a, b) for a, b in zip(g, got["this"]))
           for g in got.values()):
        raise RuntimeError("the two trees' dp_runs outputs differ")
    del got
    times = (in_turns(fused, lambda r: timer.ms(r, reps=5, cold=True))
             if len(fused) == 2 else
             {"this": [timer.ms(fused["this"], reps=5, cold=True)]})
    result["dp_runs"] = {"cold": times}
    log(f"[dp_runs] the same pairs, L2 flushed: device ms this tree "
        f"{times['this']}, other tree {times.get('parent', 'absent')}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
