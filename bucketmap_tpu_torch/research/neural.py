"""Neural / RL research-tree components (reference P5 + P7, SURVEY §2.4).

The port's counterpart of `research/neural.py`, on torch tensors on an
explicit device:

  * canonical k-mer profiles (`seed_selection/utils.py:86-117`,
    `dataset.py:23-33`): every k-mer maps to min(hash, revcomp-hash) and
    each sequence to a binary presence vector over the canonical k-mers.
    The table is numpy, the profiles a scatter-max on the device; both
    are integers, so they equal the JAX build's exactly.
  * ``ReadDataset``: the (read, bucket) sampler, numpy, the same batches
    as the JAX build's for the same seed.
  * ``MLPBucketClassifier`` (`seed_selection/dataset.py:111-129`):
    Linear(d_model) -> ReLU -> Linear(n_buckets), trained with Adam on the
    mean cross-entropy. Its layers start as flax's `Dense` does (LeCun
    normal truncated at two standard deviations, zero bias), drawn by
    numpy's `Generator` seeded by `seed` in the calling thread, so the
    card and the CPU start from the same weights.
  * ``RepetitiveRegionFilter`` (`seed_selection/filter.py:8-31`): the
    bucket-pairwise Jaccard-index matrix as one (B, G) x (G, B) product
    and inclusion-exclusion. Each intersection is a sum of 0/1 products
    below 2^24, exact in float32 in any order, so the matrix equals the
    JAX build's bit for bit.
  * ``ReferenceGenomeEnv`` + ``DQNAgent`` (`reinforcement_learning.py`):
    the single-step bucket-guessing environment (numpy, as the JAX
    build's) and a replay-buffer DQN whose target is the reward.

``params_from_flax`` carries a JAX model's weights into the port's
network, so that the two packages can be compared on the same network.
The JAX build's profiles and Jaccard product are XLA, not Pallas, so
they are plain torch here on the card as on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.device import resolve_device
from bucketmap_tpu_torch.index.builder import iterate_buckets
from bucketmap_tpu_torch.io.fasta import FastaRecord
from bucketmap_tpu_torch.ops.encoding import kmer_hashes
from bucketmap_tpu_torch.ops.host_encoding import revcomp_hash

# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps the variance
_TRUNC_STD = 0.87962566103423978


# ---------------------------------------------------------------------------
# Canonical k-mer profiles (P7)
# ---------------------------------------------------------------------------

def canonical_kmer_table(k: int) -> tuple[np.ndarray, int]:
    """hash -> dense canonical index. The canonical form of a k-mer is
    itself if hash < revcomp hash else the revcomp (seed_selection/
    utils.py:110-111). Returns (table (4^k,) int32, n_canonical)."""
    h = np.arange(4**k, dtype=np.uint32)
    canon = np.minimum(h, revcomp_hash(h, k))
    uniq, inv = np.unique(canon, return_inverse=True)
    return inv.astype(np.int32), len(uniq)


def kmer_profile_batch(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                       table: torch.Tensor, n_canonical: int) -> torch.Tensor:
    """Binary canonical-k-mer presence profiles of a batch of sequences
    (dataset.py:23-33): (B, L) codes, (B,) lengths -> (B, n_canonical)
    float32 on the codes' device. Windows past lengths - (k - 1) count
    for nothing; `table` is canonical_kmer_table's, on the same device."""
    B, L = codes.shape
    km = kmer_hashes(codes, k)                                   # (B, K)
    pos = torch.arange(L - k + 1, device=codes.device)
    valid = pos[None, :] < (lengths.to(torch.int64)[:, None] - (k - 1))
    prof = torch.zeros((B, n_canonical), dtype=torch.float32,
                       device=codes.device)
    return prof.scatter_reduce_(1, table[km], valid.to(torch.float32), "amax")


def _device_table(k: int, device) -> tuple[torch.Tensor, int]:
    table, n_can = canonical_kmer_table(k)
    return torch.from_numpy(table.astype(np.int64)).to(device), n_can


# ---------------------------------------------------------------------------
# Read dataset (P5's torch Dataset stub, completed)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReadDataset:
    """Samples (read codes, true bucket) with substitution errors, the
    training stream for the classifier/agent."""

    records: list[FastaRecord]
    cfg: MapperConfig
    substitution_rate: float = 0.02
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._buckets = [(rid, start, codes) for rid, start, codes
                         in iterate_buckets(self.records, self.cfg)]

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def batch(self, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (codes (n, read_len) uint8, lengths (n,), bucket (n,))."""
        rl = self.cfg.read_len
        codes = np.zeros((n, rl), np.uint8)
        bucket = self._rng.integers(0, self.n_buckets, n)
        for i, b in enumerate(bucket):
            seq = self._buckets[b][2]
            s = int(self._rng.integers(0, max(1, len(seq) - rl)))
            r = seq[s:s + rl].copy()
            err = self._rng.random(len(r)) < self.substitution_rate
            r[err] = (r[err] + self._rng.integers(1, 4, err.sum())) % 4
            codes[i, : len(r)] = r
        return codes, np.full(n, rl, np.int32), bucket.astype(np.int32)


# ---------------------------------------------------------------------------
# The one-hidden-layer network of both models
# ---------------------------------------------------------------------------

def truncated_normal(gen: np.random.Generator, shape) -> np.ndarray:
    """float32 unit normal draws truncated to [-2, 2], the draws outside
    drawn again, all in the calling thread."""
    w = gen.standard_normal(shape, dtype=np.float32)
    flat = w.reshape(-1)
    out = np.flatnonzero(np.abs(flat) > 2)
    while out.size:
        flat[out] = gen.standard_normal(out.size, dtype=np.float32)
        out = out[np.abs(flat[out]) > 2]
    return w


def mlp(n_in: int, d: int, n_out: int, seed: int) -> nn.Sequential:
    """Linear(n_in, d) -> ReLU -> Linear(d, n_out) on the CPU, initialised
    as flax's Dense: weights LeCun normal truncated at +-2 standard
    deviations, biases zero, drawn from np.random.default_rng(seed).
    torch's trunc_normal_ spreads its erfinv over the intra-op threads,
    and two of its draws with one seed in one long process differed past
    element 2^27 of a 2^28-element weight."""
    net = nn.Sequential(nn.utils.skip_init(nn.Linear, n_in, d), nn.ReLU(),
                        nn.utils.skip_init(nn.Linear, d, n_out))
    gen = np.random.default_rng(seed)
    with torch.no_grad():
        for layer in (net[0], net[2]):
            w = truncated_normal(gen, tuple(layer.weight.shape))
            w *= np.float32(math.sqrt(1.0 / layer.in_features) / _TRUNC_STD)
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.zero_()
    return net


def params_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """A flax Dense stack's params ({"params": {"Dense_i": {"kernel",
    "bias"}}}, or the inner dict) -> the state_dict of `mlp`'s network:
    Dense_i is the i-th Linear, its weight the kernel transposed."""
    p = flax_params.get("params", flax_params)
    out = {}
    for i in range(len(p)):
        dense = p[f"Dense_{i}"]
        out[f"{2 * i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))
        out[f"{2 * i}.bias"] = torch.from_numpy(
            np.array(dense["bias"], np.float32))
    return out


# ---------------------------------------------------------------------------
# MLP bucket classifier (P7)
# ---------------------------------------------------------------------------

class MLPBucketClassifier:
    """profile -> ReLU(Linear(d_model)) -> Linear(n_buckets)
    (seed_selection/dataset.py:111-129), Adam on the mean cross-entropy.
    The network exists once `init` (or `fit`) knows the bucket count."""

    def __init__(self, k: int = 9, d_model: int = 2048, lr: float = 1e-3,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.k = k
        self.table, self.n_canonical = _device_table(k, self.device)
        self.d_model = d_model
        self.lr = lr
        self._seed = seed
        self.net: nn.Sequential | None = None
        self.opt: torch.optim.Adam | None = None

    def init(self, n_buckets: int) -> None:
        self.net = mlp(self.n_canonical, self.d_model, n_buckets,
                       self._seed).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=self.lr)

    def profiles(self, codes: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        dev = self.device
        return kmer_profile_batch(
            torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev),
            self.k, self.table, self.n_canonical)

    def train_step(self, profiles: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """One Adam step on a batch; returns the loss before it (a 0-d
        tensor on the device)."""
        loss = F.cross_entropy(self.net(profiles), labels)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit(self, dataset: ReadDataset, steps: int = 200,
            batch_size: int = 128, log_every: int = 0) -> list[float]:
        if self.net is None:
            self.init(dataset.n_buckets)
        losses = []
        for t in range(steps):
            codes, lens, labels = dataset.batch(batch_size)
            losses.append(self.train_step(
                self.profiles(codes, lens),
                torch.from_numpy(labels.astype(np.int64)).to(self.device)))
            if log_every and t % log_every == 0:
                print(f"[mlp] step {t} loss {float(losses[-1]):.4f}")
        return torch.stack(losses).tolist() if losses else []

    @torch.no_grad()
    def predict(self, codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        logits = self.net(self.profiles(codes, lengths))
        return logits.argmax(dim=1).cpu().numpy()

    def accuracy(self, dataset: ReadDataset, n: int = 512) -> float:
        codes, lens, labels = dataset.batch(n)
        return float((self.predict(codes, lens) == labels).mean())


# ---------------------------------------------------------------------------
# Repetitive-region filter (P7)
# ---------------------------------------------------------------------------

def jaccard(inter: torch.Tensor, size_r: torch.Tensor,
            size_c: torch.Tensor) -> torch.Tensor:
    """Jaccard indices from pairwise intersections and set sizes, in
    place of `inter`: inter / (size_r + size_c - inter) where that union
    is positive, else 0 (filter.py:8-31; neural.py:_ji's ops, in float32)."""
    union = size_r[:, None] + size_c[None, :] - inter
    return inter.div_(union).masked_fill_(union <= 0, 0.0)


class RepetitiveRegionFilter:
    """Bucket-pairwise Jaccard similarity over canonical k-mer presence
    profiles (seed_selection/filter.py:8-31). The reference loops over
    O(B^2) python pairs; here intersections are ONE (B, G) x (G, B)
    product and the union follows by inclusion-exclusion."""

    def __init__(self, cfg: MapperConfig, k: int = 9, device="cuda",
                 buckets_per_call: int = 256):
        self.cfg = cfg
        self.k = k
        self.device = resolve_device(device)
        self.table, self.n_canonical = _device_table(k, self.device)
        self.buckets_per_call = buckets_per_call

    def profile_buckets(self, buckets: list[np.ndarray]) -> torch.Tensor:
        """Profiles of code arrays, (len(buckets), n_canonical) float32, in
        calls of buckets_per_call rows padded to the call's longest and
        masked by length (so a row is its bucket's alone)."""
        out = torch.empty((len(buckets), self.n_canonical),
                          dtype=torch.float32, device=self.device)
        for s in range(0, len(buckets), self.buckets_per_call):
            part = buckets[s:s + self.buckets_per_call]
            lens = np.array([len(b) for b in part], np.int32)
            codes = np.zeros((len(part), max(int(lens.max()), self.k)),
                             np.uint8)
            for i, b in enumerate(part):
                codes[i, :len(b)] = b
            out[s:s + len(part)] = kmer_profile_batch(
                torch.from_numpy(codes).to(self.device),
                torch.from_numpy(lens).to(self.device), self.k, self.table,
                self.n_canonical)
        return out

    def read(self, records: list[FastaRecord]) -> torch.Tensor:
        """Per-bucket profiles, (B, n_canonical) float32 on the device."""
        return self.profile_buckets([codes for _rid, _start, codes
                                     in iterate_buckets(records, self.cfg)])

    @torch.no_grad()
    def ji_matrix(self, profiles: torch.Tensor) -> np.ndarray:
        """(B, B) Jaccard indices, the diagonal zeroed (ref :27)."""
        sizes = profiles.sum(dim=1)
        ji = jaccard(profiles @ profiles.T, sizes, sizes)
        return ji.fill_diagonal_(0.0).cpu().numpy()


# ---------------------------------------------------------------------------
# RL environment + DQN (P5)
# ---------------------------------------------------------------------------

class ReferenceGenomeEnv:
    """The reference's gym Env (reinforcement_learning.py:9-52) without
    the gym dependency: observation = read codes (read_len,), action =
    bucket id, reward = 1 iff correct, every episode one step."""

    def __init__(self, records: list[FastaRecord], bucket_length: int = 100_000,
                 read_length: int = 100, substitution_rate: float = 0.02,
                 seed: int = 0):
        self.bucket_length = bucket_length
        self.read_length = read_length
        self.substitution_rate = substitution_rate
        self.sequence = np.concatenate([r.codes for r in records])
        self.sequence_length = len(self.sequence)
        self.num_chunks = int(np.ceil(self.sequence_length / bucket_length))
        self.action_space_n = self.num_chunks
        self._rng = np.random.default_rng(seed)
        self.last_observation_bucket: int | None = None

    def _observe(self) -> np.ndarray:
        index = int(self._rng.integers(
            0, self.sequence_length - self.read_length - 1))
        self.last_observation_bucket = index // self.bucket_length
        obs = self.sequence[index:index + self.read_length].copy()
        err = self._rng.random(len(obs)) < self.substitution_rate
        obs[err] = (obs[err] + self._rng.integers(1, 4, err.sum())) % 4
        return obs

    def reset(self) -> np.ndarray:
        return self._observe()

    def step(self, action: int):
        reward = 1 if self.last_observation_bucket == action else 0
        return self._observe(), reward, True, {}


class DQNAgent:
    """Compact DQN over the env: Q(profile) with an MLP, epsilon-greedy,
    replay buffer, TD(0) targets. Single-step episodes make the target
    just the reward — the env is a contextual bandit, which is exactly
    what the reference's DQN reduces to."""

    def __init__(self, env: ReferenceGenomeEnv, k: int = 6,
                 d_model: int = 512, lr: float = 1e-3, eps: float = 0.1,
                 seed: int = 0, device="cuda"):
        self.env = env
        self.k = k
        self.device = resolve_device(device)
        self.table, self.n_canonical = _device_table(k, self.device)
        self.eps = eps
        self._rng = np.random.default_rng(seed)
        self.net = mlp(self.n_canonical, d_model, env.action_space_n,
                       seed).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr)

    def _profile(self, obs: np.ndarray) -> torch.Tensor:
        dev = self.device
        return kmer_profile_batch(
            torch.from_numpy(np.ascontiguousarray(obs[None, :])).to(dev),
            torch.tensor([len(obs)], dtype=torch.int32, device=dev),
            self.k, self.table, self.n_canonical)

    @torch.no_grad()
    def q_values(self, profiles: torch.Tensor) -> torch.Tensor:
        return self.net(profiles)

    def _act(self, profile: torch.Tensor) -> int:
        if self._rng.random() < self.eps:
            return int(self._rng.integers(0, self.env.action_space_n))
        return int(self.q_values(profile)[0].argmax())

    def act(self, obs: np.ndarray) -> int:
        return self._act(self._profile(obs))

    def train_step(self, profiles: torch.Tensor, actions: torch.Tensor,
                   rewards: torch.Tensor) -> torch.Tensor:
        """One Adam step on mean((Q[a] - r)^2); returns the loss before it."""
        q = self.net(profiles)
        qa = q.gather(1, actions.to(torch.int64)[:, None])[:, 0]
        loss = torch.mean((qa - rewards) ** 2)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def learn(self, total_timesteps: int = 500, batch_size: int = 64,
              buffer_size: int = 2048) -> float:
        """Train; returns the final-100-step average reward."""
        buf_prof, buf_act, buf_rew = [], [], []
        rewards = []
        obs = self.env.reset()
        for _ in range(total_timesteps):
            prof = self._profile(obs)
            a = self._act(prof)
            obs, r, _done, _ = self.env.step(a)
            rewards.append(r)
            buf_prof.append(prof[0])
            buf_act.append(a)
            buf_rew.append(r)
            if len(buf_prof) > buffer_size:
                buf_prof.pop(0), buf_act.pop(0), buf_rew.pop(0)
            if len(buf_prof) >= batch_size:
                sel = self._rng.integers(0, len(buf_prof), batch_size)
                self.train_step(
                    torch.stack([buf_prof[i] for i in sel]),
                    torch.tensor([buf_act[i] for i in sel],
                                 device=self.device),
                    torch.tensor([buf_rew[i] for i in sel],
                                 dtype=torch.float32, device=self.device))
        return float(np.mean(rewards[-100:]))
