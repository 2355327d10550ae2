"""Theoretical correctness model for the bucket-classification design
space (P6) — re-design of the reference's SimulateKMerFrequency
(mcomp_project/simulation/simulate_kmer_frequency.py:6-81). The port's
copy of `research/theory.py`: numpy only, so its numbers equal the JAX
build's exactly.

Answers, before building anything: given a genome size, bucket count,
seed shape (k effective bases out of l) and number of sampled k-mers,
what is the probability that the true bucket out-scores every background
bucket?  Background per-(bucket, sample) k-mer counts are modeled
negative-binomial (overdispersed Poisson, parameter rho); the score is
the sum of log(count + prior) over samples — the probabilistic
log-frequency score of the P2 KMerFrequency classifier.

The reference loops `simulate_num` python iterations and plots a
histogram; here the whole simulation is one vectorized draw and the
numbers are returned (no matplotlib / no printing side effects).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class KmerFrequencyModel:
    genome_size: int
    bucket_num: int
    sample_num: int
    k: int              # effective bases in the (gapped) seed
    l: int              # full seed length
    r: int = 100        # read length
    prior: float = 0.01
    rho: float = 0.3    # negative-binomial dispersion

    @property
    def bucket_size(self) -> int:
        return math.ceil(self.genome_size / self.bucket_num)

    @property
    def mu(self) -> float:
        """Expected background occurrences of a seed in a bucket
        (simulate_kmer_frequency.py:37)."""
        return (self.bucket_size - self.l) / (4 ** self.k)

    @property
    def hit_mu(self) -> float:
        """Expected occurrences in the true bucket: the planted one plus
        background (:38)."""
        return 1 + (self.bucket_size - self.r) / (4 ** self.k)

    # ------------------------------------------------------------------
    def simulate_max_background_scores(self, n_sim: int = 1000,
                                       seed: int = 0) -> np.ndarray:
        """Max over background buckets of the summed log-score, per
        simulation (:43-59) — one vectorized draw instead of the
        reference's python loop."""
        rng = np.random.RandomState(seed)
        shape = (n_sim, self.bucket_num - 1, self.sample_num)
        counts = rng.negative_binomial(n=self.mu, p=self.rho,
                                       size=shape) + self.prior
        scores = np.log(counts).sum(axis=2)          # (n_sim, buckets-1)
        return scores.max(axis=1)

    def correctness(self, n_sim: int = 1000, seed: int = 0) -> dict:
        """Probability the true bucket wins (:65-76).

        expectation: the true bucket's expected score (log(hit_mu+prior)
        per sample, minus the reference's 0.5 safety margin);
        lower_bound: worst case — every sampled k-mer occurs exactly
        once in the true bucket."""
        expectation = np.log(self.hit_mu + self.prior) * self.sample_num - 0.5
        lower_bound = np.log(1 + self.prior) * self.sample_num
        bg = self.simulate_max_background_scores(n_sim, seed)
        return {
            "expectation": float(expectation),
            "lower_bound": float(lower_bound),
            "simulated_correctness": float((bg < expectation).mean()),
            "worst_case_correctness": float((bg < lower_bound).mean()),
            "mu": self.mu,
            "hit_mu": self.hit_mu,
        }

    # ------------------------------------------------------------------
    def sweep(self, ks: list[int], sample_nums: list[int],
              n_sim: int = 200, seed: int = 0) -> list[dict]:
        """Design-space sweep: correctness for each (k, sample_num) —
        what the reference ran by hand to pick k=9..12 / s=15."""
        out = []
        for k in ks:
            for s in sample_nums:
                m = dataclasses.replace(self, k=k, sample_num=s)
                res = m.correctness(n_sim, seed)
                res.update(k=k, sample_num=s)
                out.append(res)
        return out
