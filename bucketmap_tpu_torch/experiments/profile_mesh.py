"""The (1, 1) mesh step against the single-device step: the port's
counterpart of the JAX build's experiments/profile_mesh.py.

    python -m bucketmap_tpu_torch.experiments.profile_mesh [NB] [B] [MODE] \
        [--genome-mbp 1700] [--reads 1000000] [--cache-dir .bench_cache] \
        [--device cuda]

The JAX build's done-criterion for its bucket-sharded mesh step: on a
(1, 1) mesh it lands within ~10% of the single-device step, so that the
mesh path (the collective candidate policy, the sharded tables) costs
nothing when the mesh is trivial. On the first NB batches (default 8) of
B reads (default 16384) of the bench FASTQ (bench_torch.py's cache, made
here where it lacks it), DeviceMapper(pairs_per_read=4, vote_chunk=1024)
takes a warm-up step and NB steps, whose vectors decode_out reads; per
mapper its reads/s, seconds, accepted count and vote path, and one step
by stage (experiments/stages.py). MODE "single" (default) runs the
single-device mapper, "mesh" the (1, 1) mesh's, in a process group of
one rank (nccl on a card, gloo on the CPU), and "both" runs the two in
turn in one process and checks that each batch's decoded accepted lanes
and counts are the same.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

MODES = ("single", "mesh", "both")


def _with_mapper(index, device, batch: int, mesh, label: str, fn):
    from bucketmap_tpu_torch.mapper.device_pipeline import DeviceMapper

    t0 = time.perf_counter()
    dm = DeviceMapper(index, device, batch_size=batch, pairs_per_read=4,
                      vote_chunk=1024, mesh=mesh)
    return fn(label, dm, time.perf_counter() - t0)


def over_mappers(index, device, mode: str, batch: int, fn,
                 init_method: str | None = None) -> dict:
    """{label: fn(label, mapper, its init seconds)} for the mode's mappers
    in turn: "single", then "mesh 1x1" inside a process group of one rank
    (parallel.distributed.one_rank_group). Each mapper is built for its
    call and dropped after it."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    out = {}
    if mode in ("single", "both"):
        out["single"] = _with_mapper(index, device, batch, None, "single", fn)
    if mode in ("mesh", "both"):
        from bucketmap_tpu_torch.parallel.distributed import one_rank_group
        from bucketmap_tpu_torch.parallel.sharding import make_mesh

        with one_rank_group(device, init_method):
            out["mesh 1x1"] = _with_mapper(index, device, batch,
                                           make_mesh(1, 1), "mesh 1x1", fn)
    return out


def run(dm, reads, nb: int) -> dict:
    """The JAX script's run (its :44-62): a warm-up step on the first
    batch and its decode, then nb steps and their vectors decoded.
    Returns {"seconds" of the nb steps and decodes, "accepted", "decoded":
    [decode_out of each batch]}."""
    codes, quals, lengths = reads
    B = dm.batch_size
    if codes.shape[0] < nb * B:
        raise ValueError(f"{codes.shape[0]} reads do not fill {nb} batches "
                         f"of {B}")
    dm.decode_out(dm.step(codes[:B], quals[:B], lengths[:B]))
    t0 = time.perf_counter()
    outs = [dm.step(codes[i * B:(i + 1) * B], quals[i * B:(i + 1) * B],
                    lengths[i * B:(i + 1) * B]) for i in range(nb)]
    decoded = [dm.decode_out(v) for v in outs]
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "decoded": decoded,
            "accepted": sum(int(d["n_accept"].sum()) for d in decoded)}


def accepted_rows(d: dict) -> np.ndarray:
    """A batch's decoded accepted lanes as sorted unique rows (read,
    strand, bucket, offset, votes)."""
    cols = ("lane_read", "lane_rc", "lane_bucket", "offset", "votes")
    return np.unique(np.stack([np.asarray(d[c], np.int64) for c in cols],
                              axis=1).reshape(-1, len(cols)), axis=0)


def same(a: list, b: list) -> bool:
    """Whether two runs' decoded batches hold the same accepted lanes and
    counts."""
    return len(a) == len(b) and all(
        np.array_equal(accepted_rows(x), accepted_rows(y))
        and np.array_equal(x["counts"], y["counts"]) for x, y in zip(a, b))


def decompose(index, reads, nb: int, batch: int, device, mode: str = "both",
              init_method: str | None = None) -> dict:
    """Each mapper's run on nb batches of `batch` reads. Returns {label:
    run's dict, "equal": whether the mappers decode the same (True for
    one)}."""
    out = over_mappers(index, device, mode, batch,
                       lambda label, dm, _: run(dm, reads, nb), init_method)
    runs = [r["decoded"] for r in out.values()]
    out["equal"] = all(same(runs[0], r) for r in runs[1:])
    return out


def profile(index, reads, nb: int = 8, batch: int = 16384,
            mode: str = "single", device="cuda", trace_dir=None, log=print,
            init_method: str | None = None) -> dict:
    """Time each mapper's run on the card and one of its steps by stage,
    print them, and with mode "both" the ratio of the two rates; raise
    unless the mappers decode the same. Returns {label: {"reads_per_s",
    "seconds", "accepted", "vote_path", "init_s", "stages"}, "equal",
    "ratio" (mesh over single, "both" only)}."""
    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report)

    B = batch
    decoded = {}

    def timed(label, dm, init_s):
        log(f"{label} init {init_s:.1f}s")
        r = run(dm, reads, nb)
        decoded[label] = r["decoded"]
        packed = dm.pack(*(a[:B] for a in reads))

        def one_step(clock):
            prev, dm.stage = dm.stage, lambda name: clock(f"{label}: {name}")
            try:
                with clock(f"{label}: step"):
                    dm.step_packed(packed).cpu()
            finally:
                dm.stage = prev

        report = stage_report(one_step, dm.device, 3, trace_dir)
        rate = nb * B / r["seconds"]
        log(f"{label}: {rate:.0f} reads/s ({r['seconds']:.2f}s, "
            f"{r['accepted']} accepted, path {dm.vote_path})")
        print_stages(report, f"one {B}-read step of the {label} mapper by "
                     f"stage", log)
        return {"reads_per_s": rate, "seconds": r["seconds"],
                "accepted": r["accepted"], "vote_path": dm.vote_path,
                "init_s": init_s, "stages": report}

    out = over_mappers(index, device, mode, B, timed, init_method)
    runs = list(decoded.values())
    out["equal"] = all(same(runs[0], r) for r in runs[1:])
    if mode == "both":
        out["ratio"] = out["mesh 1x1"]["reads_per_s"] / \
            out["single"]["reads_per_s"]
        log(f"mesh 1x1 / single: {out['ratio']:.4f} of the reads/s; decoded "
            f"accepted lanes and counts equal {out['equal']}")
    if not out["equal"]:
        raise RuntimeError("profile_mesh: the (1, 1) mesh decodes other "
                           "accepted lanes or counts than the single device")
    return out


def bench_reads(index, fastq: str, n: int):
    """(codes, quals, lengths) of the first n reads of fastq, the lengths
    cut at read_len, as the JAX script takes them."""
    from bucketmap_tpu_torch import world

    batch = world.first_reads(fastq, n)
    return (batch.codes, batch.quals,
            np.minimum(batch.lengths, index.config.read_len).astype(np.int32))


def main(argv=None):
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import add_flags

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_batches", nargs="?", type=int, default=8)
    ap.add_argument("batch", nargs="?", type=int, default=16384)
    ap.add_argument("mode", nargs="?", default="single", choices=MODES)
    args = add_flags(ap).parse_args(argv)
    dev = resolve_device(args.device)
    index = world.bench_index(args.cache_dir, args.genome_mbp,
                              world.bench_config())[0]
    print(f"index: {index.n_buckets} buckets")
    fastq, _, _ = world.bench_reads(args.cache_dir, args.reads,
                                    args.genome_mbp)
    reads = bench_reads(index, fastq, args.n_batches * args.batch)
    if dev.type != "cuda":
        out = decompose(index, reads, args.n_batches, args.batch, dev,
                        args.mode)
        print(f"mesh on the CPU ({args.mode}): accepted "
              f"{[r['accepted'] for k, r in out.items() if k != 'equal']}, "
              f"equal {out['equal']} (no device times on the CPU)")
        return out
    return profile(index, reads, args.n_batches, args.batch, args.mode, dev,
                   args.trace_dir or os.path.join(args.cache_dir,
                                                  "profile_mesh_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
