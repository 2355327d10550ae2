"""Deterministic uniform sampling, bit-compatible with the reference Sampler
(utils.h:146-179). The port's copy of `bucketmap_tpu/ops/sampler.py`.

The reference samples n indices over [0, upper_bound]:
    delta = double(upper_bound + 1) / (n - 1)          (0 if n == 1)
    samples[i] = floor(i * delta)   for i in [0, n-2]
    samples[n-1] = upper_bound
Note the arithmetic is *IEEE double*, not exact rational — e.g. n-1=3,
ub+1=7 gives floor(3 * 2.3333...) = 6, not 7. Which k-mers get sampled
shapes every downstream result, so we replicate the double rounding
exactly (numpy float64 == C++ double here).

For device use we precompute a lookup table over all reachable upper
bounds (reads are <= read_len, so ub <= read_len) and gather rows inside
jit — exact and branch-free.
"""

from __future__ import annotations

import functools

import numpy as np


def sample_deterministic(n: int, upper_bound: int) -> np.ndarray:
    """Reference-exact sample of n indices over [0, upper_bound]."""
    if n == 1:
        return np.array([upper_bound], dtype=np.int32)
    delta = np.float64(upper_bound + 1) / np.float64(n - 1)
    i = np.arange(n - 1, dtype=np.float64)
    head = np.floor(i * delta).astype(np.int32)
    return np.concatenate([head, np.array([upper_bound], dtype=np.int32)])


@functools.lru_cache(maxsize=None)
def sample_table(n: int, max_upper_bound: int) -> np.ndarray:
    """(max_upper_bound+1, n) int32 table: row ub = sample_deterministic(n, ub).

    Tiny (reads cap ub at ~read_len), computed once on host, gathered on
    device — this keeps the exact double semantics out of the jit trace.
    """
    rows = [sample_deterministic(n, ub) for ub in range(max_upper_bound + 1)]
    return np.stack(rows).astype(np.int32)
