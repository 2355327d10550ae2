"""The coarse-stage formulations on a made occupancy table at real
shapes: the port's counterpart of the JAX build's
experiments/profile_coarse.py.

    python -m bucketmap_tpu_torch.experiments.profile_coarse [MBP] [B] \
        [--cache-dir .bench_cache] [--device cuda]

A made index (random bits at the shapes of an MBP-Mbp genome, default
1700: N buckets of bucket_len, w = ceil(N/32) words, G = 4^q + 1 rows)
and B random reads (default 8192), drawn as the JAX script draws them,
no world built. Each read-strand takes s k-mers at a fixed stride (the
JAX script's sample_hashes, no quality gate). Rows A-G are the JAX
script's formulations in plain torch on the card:
  A  bit-plane loop: per sample the AND of its g rows, ripple-carried
     into bit planes, the counts unpacked, the max
  B  unpack-sum: each sample's presence bits unpacked and summed
  C  gather-only: the same gathers and ANDs, a word sum for a reduction
  D  one gather of all s*g rows, then the ANDs and the unpacked sum
  E  paired 10-gram: a table of the AND of each 10-gram's two 9-gram rows
     (its build time and size printed) halves the gathers; then as A
  F  paired gather-only
  G  single gather-only: one row a sample, the row-fetch rate
and two more time the port's shipping formulations on the same table
and rows:
  K  the coarse_score kernel, its per-word max reduced to a read-strand
     max
  S  the staged pair: the presence_gather kernel, then chunk_scan.
Each row: the minimum of 5 calls in ms a batch, reads/s and its checksum
(the sum of its (B, 2) result); A, B, D, E, K and S count the same hits
and must share one checksum, C, F and G time gathers only. Then a table
by row (experiments/stages.py) with each row's launches.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from bucketmap_tpu_torch.utils.debug import no_stage

COUNTED = ("A", "B", "D", "E", "K", "S")     # the rows that count hits
NAMES = {"A": "A bit-plane loop", "B": "B unpack-sum", "C": "C gather-only",
         "D": "D one-gather", "E": "E paired 10-gram",
         "F": "F paired gather-only", "G": "G single gather-only",
         "K": "K coarse_score kernel", "S": "S presence_gather+chunk_scan"}


def made_index(mbp: float, batch: int, cfg=None, seed: int = 0) -> dict:
    """The JAX script's made index and reads (its :25-37), drawn with
    default_rng(seed) in its call order: {"qgram_words" (G, w) uint32,
    "kmer_to_row" (4^k,) int32, "codes" (batch, read_len) uint8, "N",
    "w", "G", "cfg"}."""
    from bucketmap_tpu_torch.config import MapperConfig

    cfg = cfg or MapperConfig()
    N = int(mbp * 1e6) // cfg.bucket_len
    w = (N + 31) // 32
    G = 4**cfg.index_seed + 1
    rng = np.random.default_rng(seed)
    qgram_words = rng.integers(0, 2**32, (G, w), dtype=np.uint64) \
        .astype(np.uint32)
    kmer_to_row = rng.integers(0, G, 4**cfg.query_seed).astype(np.int32)
    codes = rng.integers(0, 4, (batch, cfg.read_len)).astype(np.uint8)
    return {"qgram_words": qgram_words, "kmer_to_row": kmer_to_row,
            "codes": codes, "N": N, "w": w, "G": G, "cfg": cfg}


class Formulations:
    """Rows A-G, K and S on one device, over the made index's table (int32
    bit patterns), its row map and reads. Each row is a method of no
    arguments returning its (n, 2) result over the n reads."""

    def __init__(self, made: dict, device):
        import torch

        from bucketmap_tpu_torch.device import host_tensor, upload_u32

        self.torch = torch
        cfg = made["cfg"]
        self.s, self.k, self.q = (cfg.mapper_samples, cfg.query_seed,
                                  cfg.index_seed)
        self.g = self.k - self.q + 1
        self.n_planes = self.s.bit_length()
        self.dev = torch.device(device)
        self.table = upload_u32(made["qgram_words"], self.dev)
        # only q-grams index the row map: its first 4^q entries
        self.k2r = host_tensor(made["kmer_to_row"][:4**self.q]
                               .astype(np.int64)).to(self.dev)
        self.codes = host_tensor(made["codes"]).to(self.dev)
        self.n, self.w = self.codes.shape[0], self.table.shape[1]
        self.paired = None

    # -- sampling and reductions ---------------------------------------
    def sample_hashes(self):
        """(n, 2, s) int64: every K // s-th k-mer of each read, the first s,
        and their reverse complements (the JAX script's :40-44)."""
        from bucketmap_tpu_torch.ops.encoding import kmer_hashes, revcomp_hash

        kmers = kmer_hashes(self.codes, self.k)
        samp = kmers[:, :: max(1, kmers.shape[1] // self.s)][:, :self.s]
        return self.torch.stack([samp, revcomp_hash(samp, self.k)], dim=1)

    def _presence(self, h, grams):
        """The AND, over grams' (shift, table, mask, row map or None), of
        the table rows of h's gram at each shift."""
        torch = self.torch
        p = torch.full(h.shape + (self.w,), -1, dtype=torch.int32,
                       device=self.dev)
        for shift, tab, mask, k2r in grams:
            gram = (h >> shift) & mask
            p = p & tab[gram if k2r is None else k2r[gram]]
        return p

    def _grams9(self):
        return [(2 * i, self.table, 4**self.q - 1, self.k2r)
                for i in range(self.g)]

    def _grams10(self):
        return [(2 * i, self.paired, 4**(self.q + 1) - 1, None)
                for i in range(0, self.g, 2)]

    def _bits(self, words):
        """(..., w) int32 words -> (..., 4w, 8) uint8 bits, as the JAX
        script's bitcast to bytes and shift."""
        torch = self.torch
        by = words.contiguous().view(torch.uint8)
        shifts = torch.arange(8, dtype=torch.uint8, device=self.dev)
        bits = by[..., None] >> shifts
        bits &= 1
        return bits

    def _planes_max(self, planes):
        """Each read-strand's largest count over the 32w bucket bits of its
        bit planes."""
        torch = self.torch
        hits = torch.zeros((self.n, 2, 4 * self.w, 8), dtype=torch.uint8,
                           device=self.dev)
        for j, plane in enumerate(planes):
            hits += self._bits(plane) << j
        return hits.reshape(self.n, 2, -1).amax(dim=2)

    def _ripple(self, grams):
        torch = self.torch
        both = self.sample_hashes()
        planes = [torch.zeros((self.n, 2, self.w), dtype=torch.int32,
                              device=self.dev) for _ in range(self.n_planes)]
        for si in range(self.s):
            carry = self._presence(both[:, :, si], grams)
            for j in range(self.n_planes):
                t = planes[j] & carry
                planes[j] = planes[j] ^ carry
                carry = t
        return self._planes_max(planes)

    def _word_sum(self, grams):
        """The gather-only rows' reduction: the presence words summed with
        uint32 wrap over the samples, then over the words (int32 adds
        wrap the same bits; the last sum masked to 32 bits)."""
        torch = self.torch
        both = self.sample_hashes()
        acc = torch.zeros((self.n, 2, self.w), dtype=torch.int32,
                          device=self.dev)
        for si in range(self.s):
            acc = acc + self._presence(both[:, :, si], grams)
        return acc.sum(dim=2) & 0xFFFFFFFF

    def rows(self):
        """(n*2*s, g) int32 occupancy rows of each sample's q-grams,
        sample-minor: the kernels' argument."""
        torch = self.torch
        both = self.sample_hashes()
        shifts = 2 * torch.arange(self.g, dtype=torch.int64, device=self.dev)
        grams = (both[..., None] >> shifts) & (4**self.q - 1)
        return self.k2r[grams].reshape(-1, self.g).to(torch.int32) \
            .contiguous()

    # -- the rows ------------------------------------------------------
    def A(self):
        return self._ripple(self._grams9())

    def B(self):
        torch = self.torch
        both = self.sample_hashes()
        hits = torch.zeros((self.n, 2, 4 * self.w, 8), dtype=torch.uint8,
                           device=self.dev)
        for si in range(self.s):
            hits += self._bits(self._presence(both[:, :, si],
                                              self._grams9()))
        return hits.reshape(self.n, 2, -1).amax(dim=2)

    def C(self):
        return self._word_sum(self._grams9())

    def D(self):
        torch = self.torch
        both = self.sample_hashes()
        shifts = 2 * torch.arange(self.g, dtype=torch.int64, device=self.dev)
        allrows = self.table[self.k2r[(both[..., None] >> shifts)
                                      & (4**self.q - 1)]]   # (n, 2, s, g, w)
        presence = allrows[..., 0, :]
        for i in range(1, self.g):
            presence = presence & allrows[..., i, :]
        del allrows
        hits = self._bits(presence).sum(dim=2, dtype=torch.uint8)
        return hits.reshape(self.n, 2, -1).amax(dim=2)

    def build_paired(self, block: int = 1 << 16):
        """The paired 10-gram table: row t is the AND of the rows of t's
        high and low 9-grams (the JAX script's build_paired), built in
        blocks of 10-grams."""
        torch = self.torch
        n = 4**(self.q + 1)
        qm = 4**self.q - 1
        self.paired = torch.empty((n, self.w), dtype=torch.int32,
                                  device=self.dev)
        for t0 in range(0, n, block):
            t = torch.arange(t0, min(n, t0 + block), dtype=torch.int64,
                             device=self.dev)
            self.paired[t0:t0 + block] = self.table[self.k2r[(t >> 2) & qm]] \
                & self.table[self.k2r[t & qm]]
        return self.paired

    def E(self):
        return self._ripple(self._grams10())

    def F(self):
        return self._word_sum(self._grams10())

    def G(self):
        torch = self.torch
        both = self.sample_hashes()
        acc = torch.zeros((self.n, 2, self.w), dtype=torch.int32,
                          device=self.dev)
        for si in range(self.s):
            acc = acc + self.table[self.k2r[both[:, :, si]
                                            & (4**self.q - 1)]]
        return acc.sum(dim=2) & 0xFFFFFFFF

    def K(self):
        from bucketmap_tpu_torch.ops.coarse import coarse_score

        cm, _, _ = coarse_score(self.table, self.rows(), 32 * self.w, self.s)
        return cm.amax(dim=1).reshape(self.n, 2)

    def S(self):
        from bucketmap_tpu_torch.ops.coarse import chunk_scan, presence_gather

        presence = presence_gather(self.table, self.rows())
        cm, _, _ = chunk_scan(presence.reshape(-1, self.s, self.w),
                              32 * self.w)
        return cm.amax(dim=1).reshape(self.n, 2)

    def fns(self) -> dict:
        """{row letter: its method}, in the JAX script's order and then K
        and S."""
        return {c: getattr(self, c) for c in NAMES}


def checksum(out) -> int:
    """The JAX script's checksum of a row's (B, 2) result."""
    import torch

    return int(out.to(torch.int64).sum())


def decompose(f: Formulations, stage=no_stage) -> dict:
    """Each row once under `stage` (its NAMES entry), the paired table
    built first where it is not. Returns {letter: (B, 2) result,
    "checksums": {letter: checksum}, "equal": whether the COUNTED rows
    share one checksum}."""
    if f.paired is None:
        f.build_paired()
    out = {}
    for c, fn in f.fns().items():
        with stage(NAMES[c]):
            out[c] = fn()
    out["checksums"] = {c: checksum(out[c]) for c in NAMES}
    out["equal"] = len({out["checksums"][c] for c in COUNTED}) == 1
    return out


def profile(made: dict, device, trace_dir=None, log=print) -> dict:
    """Time every row on the card (min of 5) and by stage, print them, and
    raise unless the counting rows share one checksum. Returns {letter:
    {"ms", "reads_per_s", "checksum"}, "paired_build_s", "paired_gb",
    "stages", "equal"}."""
    import torch

    from bucketmap_tpu_torch.experiments.stages import (print_stages,
                                                        stage_report, wall_ms)

    f = Formulations(made, device)
    B = f.n
    log(f"N={made['N']} buckets, w={f.w} words, G={made['G']} rows, B={B} "
        f"reads, s={f.s}, g={f.g}")
    torch.cuda.synchronize(f.dev)
    t0 = time.perf_counter()
    f.build_paired()
    torch.cuda.synchronize(f.dev)
    build_s = time.perf_counter() - t0
    gb = f.paired.numel() * 4 / 1e9
    log(f"paired 10-gram table built in {build_s:.2f}s, {gb:.2f} GB")
    res = {"paired_build_s": build_s, "paired_gb": gb}
    for c, fn in f.fns().items():
        ms = min(wall_ms(fn, f.dev, 5))
        res[c] = {"ms": ms, "reads_per_s": B / ms * 1e3,
                  "checksum": checksum(fn())}
        log(f"{NAMES[c]:30s}: {ms:.3f} ms/batch -> {B / ms * 1e3:,.0f} "
            f"reads/s  (checksum {res[c]['checksum']})")
    checks = {}

    def run(clock):
        checks.update(decompose(f, clock))

    report = stage_report(run, f.dev, 3, trace_dir)
    print_stages(report, f"the coarse formulations on {B} reads x {f.w} "
                 f"words", log)
    sums = {c: res[c]["checksum"] for c in COUNTED}
    equal = checks["equal"] and len(set(sums.values())) == 1
    log(f"checksums of {', '.join(COUNTED)} equal {equal}: {sums}")
    if not equal:
        raise RuntimeError(f"profile_coarse: the counting rows' checksums "
                           f"differ: {sums}")
    res.update(stages=report, equal=True)
    return res


def main(argv=None):
    from bucketmap_tpu_torch.device import resolve_device
    from bucketmap_tpu_torch.experiments.stages import add_flags

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mbp", nargs="?", type=float, default=1700.0)
    ap.add_argument("batch", nargs="?", type=int, default=8192)
    args = add_flags(ap, ("cache-dir", "trace-dir", "device")) \
        .parse_args(argv)
    dev = resolve_device(args.device)
    made = made_index(args.mbp, args.batch)
    if dev.type != "cuda":
        out = decompose(Formulations(made, dev))
        print(f"coarse formulations on the CPU: checksums "
              f"{out['checksums']}, counting rows equal {out['equal']} (no "
              f"device times on the CPU)")
        return out
    return profile(made, dev, args.trace_dir or os.path.join(
        args.cache_dir, "profile_coarse_trace"))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
