"""The bench world: a seeded genome, its index and simulated reads with
ground truth, cached on disk.

Made exactly as `bench.py` makes its workloads (repeat_genome, or with
uniform=True random_genome, seed 1 over 4 references;
MapperConfig(bucket_len=65536, read_len=300); ShortReadSimulator seed 2
at dwgsim-like error rates, or LongReadSimulator's ONT reads), with the
same cache file names, so one cache serves both: the default align-free
world, its FracMinHash variant (`kmer_fraction`, the 3.1 Gbp f=0.25
world), and the ONT long reads (`bench_reads(long=True)`, mapped at
`ont_config`'s query flags on the shared index; `bench_index` puts a
run's query flags over a cached index's). Host-only: no device work
happens here.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index import builder
from bucketmap_tpu_torch.io.fastq import ReadBatch, iter_fastq_batches
from bucketmap_tpu_torch.sim.simulator import (LongReadSimulator,
                                               ShortReadSimulator,
                                               random_genome, repeat_genome)


def _genome_tag(genome_mbp: float, kmer_fraction: float = 1.0,
                uniform: bool = False) -> str:
    """bench.py's genome tag: "u" for the uniform genome, else "rep2"; the
    f suffix only where f != 1, so that the default world keeps its cache
    names."""
    return f"{genome_mbp:g}{'u' if uniform else 'rep2'}" + (
        f"_f{kmer_fraction:g}" if kmer_fraction != 1.0 else "")


def index_name(genome_mbp: float, kmer_fraction: float = 1.0,
               uniform: bool = False) -> str:
    """The indicator under which `bench_index` saves its index."""
    return f"idx_{_genome_tag(genome_mbp, kmer_fraction, uniform)}"


def reads_name(genome_mbp: float, n_reads: int, kmer_fraction: float = 1.0,
               uniform: bool = False, long: bool = False) -> str:
    """The indicator of `bench_reads`' FASTQ and ground-truth files."""
    return (f"reads_g{_genome_tag(genome_mbp, kmer_fraction, uniform)}m_r"
            f"{n_reads}" + ("_long" if long else ""))


def ont_config(cfg: MapperConfig) -> MapperConfig:
    """The reference's long-read query flags, -s 30 -e 0.9 -n 0.1 -p 20
    -u 5 (bench.py's BMTPU_BENCH_LONG=1), on an index's config: they
    change sampling and thresholds only, so the index is shared."""
    return dataclasses.replace(cfg, mapper_samples=30, seed_miss_rate=0.9,
                               indel_rate=0.1, locator_samples=20,
                               quality_threshold=5)


# the flags of a query, which an index built under other flags serves
QUERY_FLAGS = ("mapper_samples", "seed_miss_rate", "indel_rate",
               "locator_samples", "quality_threshold")


def bench_config(kmer_fraction: float = 1.0, long: bool = False
                 ) -> MapperConfig:
    """bench.py's MapperConfig: 65,536 bp buckets, 300 bp reads, the
    FracMinHash fraction, and with long=True the long-read query flags."""
    cfg = MapperConfig(bucket_len=65536, read_len=300,
                       kmer_fraction=kmer_fraction)
    return ont_config(cfg) if long else cfg


def bench_genome(genome_mbp: float = 1700.0, uniform: bool = False):
    """The bench world's genome: the records its index was built from;
    uniform=True is bench.py's BMTPU_BENCH_UNIFORM=1 repeat-free genome."""
    make = random_genome if uniform else repeat_genome
    return make(int(genome_mbp * 1e6), seed=1, n_refs=4)


def bench_index(cache_dir: str, genome_mbp: float, cfg: MapperConfig,
                genome=None, uniform: bool = False, host_fine: bool = False,
                log=print):
    """(index, genome or None, seconds of the build or None on a cache
    hit), as bench.py makes it: on a miss, built from `genome` (made by
    bench_genome where None) under `cfg`, with the host fine tables where
    host_fine (BMTPU_BENCH_HOST_FINE=1), and saved; on a hit, loaded,
    with cfg's QUERY_FLAGS put over the flags it was built with, so that
    a hit never drops -s/-e/-n/-p/-u."""
    name = index_name(genome_mbp, cfg.kmer_fraction, uniform)
    os.makedirs(cache_dir, exist_ok=True)
    if os.path.exists(os.path.join(cache_dir, f"{name}.bmtpu.json")):
        index = builder.load_index(cache_dir, name)
        index.config = dataclasses.replace(
            index.config, **{f: getattr(cfg, f) for f in QUERY_FLAGS})
        return index, genome, None
    if genome is None:
        t0 = time.perf_counter()
        genome = bench_genome(genome_mbp, uniform)
        log(f"[world] genome {genome_mbp:g} Mbp made in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    index = builder.build_index(genome, cfg)
    if host_fine:
        builder.build_fine_index(index)
    build_s = time.perf_counter() - t0
    builder.save_index(index, cache_dir, name)
    log(f"[world] index built in {build_s:.1f} s ({index.n_buckets} "
        f"buckets)")
    return index, genome, build_s


def bench_reads(cache_dir: str, n_reads: int, genome_mbp: float = 1700.0,
                genome=None, kmer_fraction: float = 1.0,
                uniform: bool = False, long: bool = False, log=print):
    """(fastq_path, ground_truth_path, seconds spent making them) of
    n_reads bench reads from `genome` (made by bench_genome where the
    cache lacks the reads and none is given): 300 bp at 0.2%
    substitutions and 0.025% insertions and deletions each, or with
    long=True ONT-like reads of ~7.5 kbp (5-15 kbp) at 2% of each, as
    bench.py simulates them, under its names."""
    tag = reads_name(genome_mbp, n_reads, kmer_fraction, uniform, long)
    os.makedirs(cache_dir, exist_ok=True)
    fastq = os.path.join(cache_dir, f"{tag}.fastq")
    gt = os.path.join(cache_dir, f"{tag}.position_ground_truth")
    t0 = time.perf_counter()
    if os.path.exists(fastq):
        return fastq, gt, 0.0
    if genome is None:
        genome = bench_genome(genome_mbp, uniform)
        log(f"[world] genome {genome_mbp:g} Mbp made in "
            f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    if long:
        sim = LongReadSimulator(genome, mean_len=7500, sd_len=1500,
                                min_len=5000, substitution_rate=0.02,
                                insertion_rate=0.02, deletion_rate=0.02,
                                seed=2)
    else:
        sim = ShortReadSimulator(bench_config(kmer_fraction),
                                 substitution_rate=0.002,
                                 insertion_rate=0.00025,
                                 deletion_rate=0.00025, seed=2)
        sim.read(genome)
    sim.generate(cache_dir, tag, n_reads)
    log(f"[world] {n_reads} {'long ' if long else ''}reads simulated in "
        f"{time.perf_counter() - t1:.1f} s")
    return fastq, gt, time.perf_counter() - t0


def bench_world(cache_dir: str, genome_mbp: float = 1700.0,
                n_reads: int = 131072, log=print, genome=None,
                kmer_fraction: float = 1.0, uniform: bool = False):
    """(index, fastq_path, ground_truth_path, seconds spent making what
    the cache lacked): bench_index at bench_config(kmer_fraction) and
    bench_reads' 300 bp reads. `genome`, bench_genome(genome_mbp) made by
    the caller, saves making it again where the cache lacks something.
    kmer_fraction < 1 keeps that FracMinHash fraction of the q-grams in
    the coarse index (bench.py's BMTPU_BENCH_FRAC)."""
    t0 = time.perf_counter()
    index, genome, _ = bench_index(cache_dir, genome_mbp,
                                   bench_config(kmer_fraction), genome,
                                   uniform, log=log)
    fastq, gt, _ = bench_reads(cache_dir, n_reads, genome_mbp, genome,
                               kmer_fraction, uniform, log=log)
    return index, fastq, gt, time.perf_counter() - t0


def first_reads(fastq_path: str, n: int) -> ReadBatch:
    """The first n reads of a FASTQ file."""
    return next(iter(iter_fastq_batches(fastq_path, reads_per_batch=n)))


def score_sam(sam_path: str, gt_path: str, index, tol: int = 10):
    """(% reads mapped, % reads with a record at the true reference,
    strand and 1-based position within +-tol), bench.py's scoring."""
    gt_rid, gt_pos, gt_rc = [], [], []
    with open(gt_path) as f:
        for line in f:
            a, b, c, _ = line.split(maxsplit=3)
            gt_rid.append(int(a))
            gt_pos.append(int(b))
            gt_rc.append(int(c))
    gt_rid = np.asarray(gt_rid, np.int32)
    gt_pos = np.asarray(gt_pos, np.int64)
    gt_rc = np.asarray(gt_rc, bool)
    n_gt = len(gt_rid)
    ref_short = {n.split(" ")[0]: i for i, n in enumerate(index.ref_names)}
    qname, flag, rname, pos = [], [], [], []
    with open(sam_path) as f:
        for line in f:
            if line[0] == "@":
                continue
            c = line.split("\t", 4)
            qname.append(c[0])
            flag.append(c[1])
            rname.append(c[2])
            pos.append(c[3])
    qname = np.asarray(qname, np.int64)
    flag = np.asarray(flag, np.int32)
    rid = np.asarray([ref_short.get(r, -1) for r in rname], np.int32)
    pos = np.asarray(pos, np.int64)
    mapped = np.zeros(n_gt, bool)
    mapped[qname] = True
    ok = ((rid == gt_rid[qname])
          & (((flag & 16) == 16) == gt_rc[qname])
          & (np.abs(pos - gt_pos[qname]) <= tol))
    correct = np.zeros(n_gt, bool)
    correct[qname[ok]] = True
    return mapped.mean() * 100.0, correct.mean() * 100.0
