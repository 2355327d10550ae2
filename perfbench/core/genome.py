"""The configurations' genomes, made from a fixed world seed and cached
2-bit packed.

`repeat_genome` is a frozen copy of the generator of the same name in
`bucketmap_tpu_torch/sim/simulator.py`: the same seed gives the same
bases. The benchmark keeps its own copy, so that a change to the
program cannot change the world it is measured on.

The bucket layout (`buckets`) is the mapper's: per record,
ceil(len / bucket_len) buckets of [i * L, i * L + L + read_len), a
residual of read_len or less dropped (the upstream utils.h:60-102).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - np.asarray(codes, dtype=np.uint8))[..., ::-1]


def repeat_genome(length: int, seed: int = 0, n_refs: int = 1,
                  dup_frac: float = 0.20, mobile_frac: float = 0.07,
                  tandem_frac: float = 0.01, divergence: float = 0.02,
                  identical_frac: float = 0.60,
                  name_prefix: str = "synthrep") -> list[tuple[str, np.ndarray]]:
    """A random backbone with segmental duplications (60% of them
    identical copies), diverged mobile elements and short tandem arrays;
    (name, uint8 codes) per record."""
    rng = np.random.RandomState(seed)
    per = length // n_refs

    def mutate(seg: np.ndarray, can_be_identical: bool = False) -> np.ndarray:
        if can_be_identical and rng.random_sample() < identical_frac:
            return seg
        m = rng.random_sample(len(seg)) < divergence
        if m.any():
            seg = seg.copy()
            seg[m] = (seg[m] + rng.randint(1, 4, int(m.sum()))) % 4
        return seg

    n_elems = 8
    elem_lens = rng.randint(300, 3001, n_elems)
    elems = [rng.randint(0, 4, L).astype(np.uint8) for L in elem_lens]

    recs = []
    for i in range(n_refs):
        codes = rng.randint(0, 4, size=per).astype(np.uint8)

        covered = 0
        target = mobile_frac * per
        while covered < target:
            e = elems[rng.randint(n_elems)]
            if rng.randint(2):
                e = revcomp_codes(e)
            at = rng.randint(0, per - len(e))
            codes[at: at + len(e)] = mutate(e)
            covered += len(e)

        covered = 0
        target = dup_frac * per
        while covered < target:
            seg_len = int(rng.randint(2000, 20001))
            src = rng.randint(0, per - seg_len)
            dst = rng.randint(0, per - seg_len)
            seg = codes[src: src + seg_len].copy()
            if rng.randint(2):
                seg = revcomp_codes(seg)
            codes[dst: dst + seg_len] = mutate(seg, can_be_identical=True)
            covered += seg_len

        covered = 0
        target = tandem_frac * per
        while covered < target:
            unit_len = int(rng.randint(2, 101))
            arr_len = int(rng.randint(200, 2001))
            unit = rng.randint(0, 4, unit_len).astype(np.uint8)
            at = rng.randint(0, per - arr_len)
            codes[at: at + arr_len] = np.tile(
                unit, arr_len // unit_len + 1)[:arr_len]
            covered += arr_len

        recs.append((f"{name_prefix}_{i}", codes))
    return recs


GENERATORS = {"repeat_genome": repeat_genome}


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes -> uint32 words, 16 bases a word, base j at bit
    2 * (j % 16) of word j // 16; the tail word zero-padded."""
    n = len(codes)
    out = np.zeros(-(-n // 16), np.uint32)
    step = 1 << 24
    for s in range(0, n, step):
        c = codes[s:s + step].astype(np.uint32)
        pad = (-len(c)) % 16
        if pad:
            c = np.concatenate([c, np.zeros(pad, np.uint32)])
        c = c.reshape(-1, 16) << (2 * np.arange(16, dtype=np.uint32))
        out[s // 16: s // 16 + len(c)] = np.bitwise_or.reduce(c, axis=1)
    return out


def unpack_range(words: np.ndarray, start: int, stop: int) -> np.ndarray:
    """The bases [start, stop) of a packed record as uint8 codes."""
    w0, w1 = start >> 4, -(-stop // 16)
    ww = np.asarray(words[w0:w1], np.uint32)
    b = (ww[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    return b.reshape(-1).astype(np.uint8)[start - 16 * w0: stop - 16 * w0]


class Genome:
    """A genome held 2-bit packed: names, lengths and words per record."""

    def __init__(self, names: list[str], lengths: list[int],
                 words: list[np.ndarray]):
        self.names = list(names)
        self.lengths = [int(n) for n in lengths]
        self.words = words

    def codes(self, rec: int, start: int, stop: int) -> np.ndarray:
        return unpack_range(self.words[rec], start, stop)

    def buckets(self, bucket_len: int, read_len: int) -> dict:
        """The mapper's bucket layout: per bucket its record, start,
        length and ordinal within the record (the SAM offset is
        ordinal * bucket_len)."""
        rec, start, length, ordinal = [], [], [], []
        for r, total in enumerate(self.lengths):
            n_b = -(-total // bucket_len)
            o = 0
            for i in range(n_b):
                s = i * bucket_len
                e = min(s + bucket_len + read_len, total)
                if e - s <= read_len:
                    continue
                rec.append(r)
                start.append(s)
                length.append(e - s)
                ordinal.append(o)
                o += 1
        return {"rec": np.asarray(rec, np.int64),
                "start": np.asarray(start, np.int64),
                "length": np.asarray(length, np.int64),
                "ordinal": np.asarray(ordinal, np.int64)}


def _save(directory: str, genome_recs) -> None:
    tmp = directory + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    names, lengths = [], []
    for i, (name, codes) in enumerate(genome_recs):
        np.save(os.path.join(tmp, f"words_{i}.npy"), pack_2bit(codes))
        names.append(name)
        lengths.append(len(codes))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"names": names, "lengths": lengths}, f)
    os.replace(tmp, directory)


def load(directory: str) -> Genome:
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    words = [np.load(os.path.join(directory, f"words_{i}.npy"))
             for i in range(len(meta["names"]))]
    return Genome(meta["names"], meta["lengths"], words)


def ensure(cache_dir: str, spec: dict) -> tuple[Genome, float]:
    """The configuration's genome from the cache, made first where the
    cache lacks it; (genome, seconds spent making it, 0 on a hit).
    spec: the configuration's "genome" object (generator, bp, n_refs,
    seed)."""
    directory = os.path.join(cache_dir, "genome")
    made_s = 0.0
    if not os.path.exists(os.path.join(directory, "meta.json")):
        t0 = time.perf_counter()
        make = GENERATORS[spec["generator"]]
        recs = make(int(spec["bp"]), seed=int(spec["seed"]),
                    n_refs=int(spec["n_refs"]))
        _save(directory, recs)
        del recs
        made_s = time.perf_counter() - t0
    return load(directory), made_s
