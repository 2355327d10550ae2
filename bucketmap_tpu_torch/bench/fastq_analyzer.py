"""FASTQ statistics — port of benchmark/fastq_analyzer.cpp (B2).

The port's copy of `bucketmap_tpu/bench/fastq_analyzer.py`, on the
port's FASTQ reader: the same statistics and printed lines.

Reports read count, length distribution, base-quality distribution, and
the quality-implied expected error rate (mean of 10^(-q/10)).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bucketmap_tpu_torch.io.fastq import read_fastq


@dataclasses.dataclass
class FastqStats:
    num_reads: int
    total_bases: int
    min_length: int
    max_length: int
    mean_length: float
    mean_quality: float
    quality_histogram: dict[int, int]
    estimated_error_rate: float


def analyze_fastq(path, quiet: bool = False) -> FastqStats:
    batch = read_fastq(path)
    lens = batch.lengths
    mask = np.arange(batch.quals.shape[1])[None, :] < lens[:, None]
    quals = batch.quals[mask].astype(np.int64)
    hist = np.bincount(quals)
    err = float(np.mean(np.power(10.0, -quals / 10.0))) if len(quals) else 0.0
    stats = FastqStats(
        num_reads=batch.num_reads,
        total_bases=int(lens.sum()),
        min_length=int(lens.min()) if len(lens) else 0,
        max_length=int(lens.max()) if len(lens) else 0,
        mean_length=float(lens.mean()) if len(lens) else 0.0,
        mean_quality=float(quals.mean()) if len(quals) else 0.0,
        quality_histogram={int(q): int(c) for q, c in enumerate(hist) if c},
        estimated_error_rate=err,
    )
    if not quiet:
        print(f"[BENCHMARK]\tNumber of reads: {stats.num_reads}.")
        print(f"[BENCHMARK]\tTotal bases: {stats.total_bases}.")
        print(f"[BENCHMARK]\tRead length: min {stats.min_length}, "
              f"max {stats.max_length}, mean {stats.mean_length:.2f}.")
        print(f"[BENCHMARK]\tMean base quality: {stats.mean_quality:.2f}.")
        print(f"[BENCHMARK]\tEstimated error rate: {stats.estimated_error_rate:.5f}.")
    return stats
