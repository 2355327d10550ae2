"""Research-tree bucket classifiers (reference mcomp_project/, SURVEY §2.4).

The port's copy of `research/classifiers.py`: numpy in both packages, so
each model's matrices and answers equal the JAX build's exactly.

Compact reimplementations of the exploratory models that preceded the
shipping bit-parallel index — useful for studying the design space:

  * KMerExistence  (P4, kmer_existence.py): boolean k-mer-presence matrix;
    query = count of present sampled k-mers per bucket, argmax.
  * KMerFrequency  (P2, kmer_frequency.py): per-bucket k-mer log-frequency
    matrix; query = argmax of summed log-probabilities.
  * GappedKMerFrequency (P2, kmer_frequency.py:162-256): the same model
    over a gapped seed shape — k positions sampled from a wider span, so
    one substitution error cannot corrupt every overlapping seed. The
    reference's documented bridge between frequency models and seed
    shapes.
  * MarkovChain    (P3, markov_chain.py): order-q Markov chain per bucket
    (initial + transition log-probs); query by log-likelihood.

All vectorized numpy; buckets follow the same decomposition as the
production index.
"""

from __future__ import annotations

import numpy as np

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index.builder import iterate_buckets
from bucketmap_tpu_torch.ops.host_encoding import kmer_hashes


class _BucketModel:
    def __init__(self, cfg: MapperConfig, k: int):
        self.cfg = cfg
        self.k = k
        self.n_buckets = 0

    def _buckets(self, records):
        for _rid, _start, codes in iterate_buckets(records, self.cfg):
            yield codes


class KMerExistence(_BucketModel):
    def read(self, records) -> None:
        rows = []
        for codes in self._buckets(records):
            present = np.zeros(4**self.k, dtype=bool)
            if len(codes) >= self.k:
                present[np.unique(kmer_hashes(codes, self.k))] = True
            rows.append(present)
        self.matrix = np.stack(rows)          # (N, 4^k) bool
        self.n_buckets = len(rows)

    def query(self, codes: np.ndarray, num_samples: int = 15) -> int:
        h = kmer_hashes(codes, self.k)
        sel = np.linspace(0, len(h) - 1, num_samples).astype(int)
        scores = self.matrix[:, h[sel]].sum(axis=1)
        return int(np.argmax(scores))


class KMerFrequency(_BucketModel):
    """Log-frequency model with add-one smoothing (kmer_frequency.py:9-160)."""

    def read(self, records) -> None:
        rows = []
        for codes in self._buckets(records):
            counts = np.ones(4**self.k, dtype=np.float64)  # +1 smoothing
            if len(codes) >= self.k:
                np.add.at(counts, kmer_hashes(codes, self.k), 1.0)
            rows.append(np.log(counts / counts.sum()))
        self.matrix = np.stack(rows)          # (N, 4^k) float
        self.n_buckets = len(rows)

    def query(self, codes: np.ndarray, num_samples: int = 15) -> int:
        h = kmer_hashes(codes, self.k)
        sel = np.linspace(0, len(h) - 1, num_samples).astype(int)
        scores = self.matrix[:, h[sel]].sum(axis=1)
        return int(np.argmax(scores))


class GappedKMerFrequency(KMerFrequency):
    """KMerFrequency over a gapped seed shape (kmer_frequency.py:162-256).

    The shape is k sorted positions drawn from a span of ``k + gap``
    (reference: ``random.sample(range(order + gapped_k_mer_sequence),
    k=order)`` at :167, or a caller-provided position list). A gapped
    seed tolerates substitutions landing in its gaps, trading contiguity
    for error robustness — the design question this prototype answers.

    Hashing is vectorized: all gapped windows are gathered at once as a
    (n_windows, k) position matrix and reduced with the 4^j base powers,
    instead of the reference's per-window string join (:176-180).
    """

    def __init__(self, cfg: MapperConfig, k: int, gap: int = 5,
                 shape: list[int] | None = None, seed: int = 0):
        super().__init__(cfg, k)
        if shape is not None:
            if len(shape) != k or sorted(set(shape)) != list(shape):
                raise ValueError("shape must be k strictly increasing positions")
            self.shape = np.asarray(shape, np.int64)
        else:
            rng = np.random.default_rng(seed)
            self.shape = np.sort(rng.choice(k + gap, size=k, replace=False))
        self.span = int(self.shape[-1]) + 1

    def _gapped_hashes(self, codes: np.ndarray) -> np.ndarray:
        n = len(codes) - self.span + 1
        if n <= 0:
            return np.zeros(0, np.int64)
        pos = np.arange(n)[:, None] + self.shape[None, :]   # (n, k)
        powers = 4 ** np.arange(self.k - 1, -1, -1, dtype=np.int64)
        return codes[pos].astype(np.int64) @ powers

    def read(self, records) -> None:
        rows = []
        for codes in self._buckets(records):
            counts = np.ones(4**self.k, dtype=np.float64)  # +1 smoothing
            h = self._gapped_hashes(codes)
            if len(h):
                np.add.at(counts, h, 1.0)
            rows.append(np.log(counts / counts.sum()))
        self.matrix = np.stack(rows)          # (N, 4^k) float
        self.n_buckets = len(rows)

    def query(self, codes: np.ndarray, num_samples: int = 15) -> int:
        h = self._gapped_hashes(codes)
        sel = np.linspace(0, len(h) - 1, num_samples).astype(int)
        scores = self.matrix[:, h[sel]].sum(axis=1)
        return int(np.argmax(scores))


class MarkovChain(_BucketModel):
    """Order-(k-1) Markov chain per bucket (markov_chain.py:7-200):
    transition probability from the (k-1)-mer prefix to the last base."""

    def read(self, records) -> None:
        k = self.k
        trans = []
        for codes in self._buckets(records):
            counts = np.ones((4 ** (k - 1), 4), dtype=np.float64)
            if len(codes) >= k:
                h = kmer_hashes(codes, k)
                prefix = h >> 2
                last = h & 3
                np.add.at(counts, (prefix, last), 1.0)
            trans.append(np.log(counts / counts.sum(axis=1, keepdims=True)))
        self.trans = np.stack(trans)          # (N, 4^(k-1), 4)
        self.n_buckets = len(trans)

    def query(self, codes: np.ndarray) -> int:
        h = kmer_hashes(codes, self.k)
        prefix = h >> 2
        last = h & 3
        scores = self.trans[:, prefix, last].sum(axis=1)
        return int(np.argmax(scores))
