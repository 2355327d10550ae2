"""Ground-truth-emitting short-read simulator.

The port's copy of `bucketmap_tpu/sim/simulator.py`: the same seed
writes the same FASTQ and ground-truth bytes.

Behavioral port of the reference short_read_simulator
(tools/short_read_simulator.h:18-242), which is both a public-facing
feature (README.md:86-129) and the source of ground truth for every
accuracy test:

  * reads sampled uniformly: bucket ~ U[0, N), start ~ U[0, blen-read_len-1)
    (:157-189),
  * per-read error counts ~ Poisson(rate * read_len) for substitutions,
    insertions, deletions; ops applied in the order deletions ->
    insertions -> substitutions at uniform positions (:104-117),
  * the ground-truth CIGAR mirrors the reference's quirky bookkeeping:
    one op per entry; a deletion removes a base but *replaces* the op at
    that index with 'D'; an insertion inserts both (:40-61),
  * 50% of reads are reverse-complemented (:69-82),
  * outputs: .fastq (constant quality 'E'), .bucket_ground_truth
    ("bucket offset revcomp cigar") and .position_ground_truth
    ("ref_id 1-based-pos revcomp cigar") (:213-232).

The RNG is numpy (seeded, reproducible) rather than C rand(); the
*distributions* match, the streams don't — ground truth files make that
irrelevant.
"""

from __future__ import annotations

import os
import numpy as np

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.io.fasta import FastaRecord, read_fasta
from bucketmap_tpu_torch.index.builder import iterate_buckets
from bucketmap_tpu_torch.ops.host_encoding import decode_to_ascii, revcomp_codes


def _cigar_to_string(ops: list[str]) -> str:
    """Run-length encode a per-position op list (utils.h:254-280)."""
    if not ops:
        return ""
    out = []
    last, count = ops[0], 0
    for op in ops:
        if op == last:
            count += 1
        else:
            out.append(f"{count}{last}")
            last, count = op, 1
    out.append(f"{count}{last}")
    return "".join(out)


class ShortReadSimulator:
    def __init__(self, cfg: MapperConfig, substitution_rate: float = 0.0,
                 insertion_rate: float = 0.0, deletion_rate: float = 0.0,
                 seed: int = 0):
        self.cfg = cfg
        self.sub_lam = substitution_rate * cfg.read_len
        self.ins_lam = insertion_rate * cfg.read_len
        self.del_lam = deletion_rate * cfg.read_len
        self.rng = np.random.RandomState(seed)
        self.bucket_codes: list[np.ndarray] = []
        self.bucket_ids: list[tuple[int, int]] = []  # (ref_id, ordinal in ref)

    def read(self, fasta: str | os.PathLike | list[FastaRecord]) -> None:
        records = fasta if isinstance(fasta, list) else read_fasta(fasta)
        last_id, ref_id, ordinal = None, -1, 0
        for rec_id, _start, codes in iterate_buckets(records, self.cfg):
            self.bucket_codes.append(codes)
            if rec_id != last_id:
                last_id, ref_id, ordinal = rec_id, ref_id + 1, 0
            self.bucket_ids.append((ref_id, ordinal))
            ordinal += 1
        if not self.bucket_codes:
            raise ValueError("genome produced no buckets")

    def sample(self, simulate_error: bool = True):
        """One read: (codes, bucket, offset, rev_comp, cigar_string)."""
        rng = self.rng
        rl = self.cfg.read_len
        bucket = int(rng.randint(len(self.bucket_codes)))
        cur = self.bucket_codes[bucket]
        start = 0
        if len(cur) > rl + 1:
            start = int(rng.randint(len(cur) - rl - 1))
        end = min(start + rl, len(cur))
        seq = list(cur[start:end])
        cigar = ["="] * len(seq)

        if simulate_error:
            n_sub = int(rng.poisson(self.sub_lam))
            n_ins = int(rng.poisson(self.ins_lam))
            n_del = int(rng.poisson(self.del_lam))
            # order matches add_errors: deletions, insertions, substitutions
            # (short_read_simulator.h:114-116)
            for _ in range(n_del):
                idx = int(rng.randint(len(seq)))
                del seq[idx]
                cigar[idx] = "D"
            for _ in range(n_ins):
                idx = int(rng.randint(len(seq)))
                seq.insert(idx, int(rng.randint(4)))
                cigar.insert(idx, "I")
            for _ in range(n_sub):
                idx = int(rng.randint(len(seq)))
                new = int(rng.randint(4))
                while new == seq[idx]:
                    new = int(rng.randint(4))
                seq[idx] = new
                cigar[idx] = "X"

        codes = np.asarray(seq, dtype=np.uint8)
        rev_comp = bool(rng.randint(2))
        if rev_comp:
            codes = revcomp_codes(codes)
        return codes, bucket, start, rev_comp, _cigar_to_string(cigar)

    def generate(self, out_dir: str | os.PathLike, indicator: str, size: int,
                 simulate_error: bool = True,
                 vectorized: bool | None = None) -> dict[str, str]:
        """Write {indicator}.fastq / .bucket_ground_truth / .position_ground_truth.

        vectorized=True (default for large sizes) draws all error-free
        reads and substitution-only reads with batched numpy and loops
        only over the rare indel reads — same distributions, different
        random stream than the per-read path.
        """
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "fastq": os.path.join(out_dir, indicator + ".fastq"),
            "bucket_gt": os.path.join(out_dir, indicator + ".bucket_ground_truth"),
            "position_gt": os.path.join(out_dir, indicator + ".position_ground_truth"),
        }
        if vectorized is None:
            vectorized = size >= 50_000
        bl = self.cfg.bucket_len
        if vectorized:
            rows = self._generate_vectorized(size, simulate_error)
        else:
            rows = []
            for _ in range(size):
                rows.append(self.sample(simulate_error))
        fq, bgt, pgt = [], [], []
        for i, (codes, bucket, offset, rc, cigar) in enumerate(rows):
            seq = decode_to_ascii(codes).decode()
            fq.append(f"@{i}\n{seq}\n+\n{'E' * len(seq)}\n")
            bgt.append(f"{bucket} {offset} {int(rc)} {cigar}\n")
            ref_id, ordinal = self.bucket_ids[bucket]
            pgt.append(f"{ref_id} {ordinal * bl + offset + 1} {int(rc)} {cigar}\n")
        with open(paths["fastq"], "w") as f:
            f.write("".join(fq))
        with open(paths["bucket_gt"], "w") as f:
            f.write("".join(bgt))
        with open(paths["position_gt"], "w") as f:
            f.write("".join(pgt))
        return paths

    def _generate_vectorized(self, size: int, simulate_error: bool):
        """Batched sampling: same distributions as sample()."""
        rng = self.rng
        rl = self.cfg.read_len
        nb = len(self.bucket_codes)
        blens = np.asarray([len(c) for c in self.bucket_codes])
        buckets = rng.randint(0, nb, size)
        spans = np.maximum(blens[buckets] - rl - 1, 1)
        starts = (rng.randint(0, 1 << 30, size) % spans) * \
            (blens[buckets] > rl + 1)
        # gather reads (dense bucket matrix; genomes here fit host RAM)
        maxb = int(blens.max())
        dense = np.zeros((nb, maxb), np.uint8)
        for i, c in enumerate(self.bucket_codes):
            dense[i, : len(c)] = c
        col = np.arange(rl)
        ends = np.minimum(starts + rl, blens[buckets])
        lens = (ends - starts).astype(np.int64)
        idx = np.minimum(starts[:, None] + col[None, :], maxb - 1)
        reads = dense[buckets[:, None], idx]                     # (size, rl)

        if simulate_error:
            n_sub = rng.poisson(self.sub_lam, size)
            n_ins = rng.poisson(self.ins_lam, size)
            n_del = rng.poisson(self.del_lam, size)
        else:
            n_sub = n_ins = n_del = np.zeros(size, np.int64)
        rc_flags = rng.randint(0, 2, size).astype(bool)

        indel_rows = np.nonzero((n_ins + n_del) > 0)[0]
        sub_only = np.nonzero((n_sub > 0) & ((n_ins + n_del) == 0))[0]

        # vectorized substitutions for sub-only rows
        cigars: dict[int, str] = {}
        for r in sub_only:
            L = int(lens[r])
            ops = ["="] * L
            for _ in range(int(n_sub[r])):
                p = int(rng.randint(L))
                new = int(rng.randint(4))
                while new == reads[r, p]:
                    new = int(rng.randint(4))
                reads[r, p] = new
                ops[p] = "X"
            cigars[r] = _cigar_to_string(ops)

        rows = []
        for r in range(size):
            L = int(lens[r])
            if r in cigars:
                codes = reads[r, :L]
                cig = cigars[r]
            elif int(n_ins[r] + n_del[r]) > 0:
                # rare indel rows: full per-read error model
                seq = list(reads[r, :L])
                ops = ["="] * L
                for _ in range(int(n_del[r])):
                    p = int(rng.randint(len(seq)))
                    del seq[p]
                    ops[p] = "D"
                for _ in range(int(n_ins[r])):
                    p = int(rng.randint(len(seq)))
                    seq.insert(p, int(rng.randint(4)))
                    ops.insert(p, "I")
                for _ in range(int(n_sub[r])):
                    p = int(rng.randint(len(seq)))
                    new = int(rng.randint(4))
                    while new == seq[p]:
                        new = int(rng.randint(4))
                    seq[p] = new
                    ops[p] = "X"
                codes = np.asarray(seq, np.uint8)
                cig = _cigar_to_string(ops)
            else:
                codes = reads[r, :L]
                cig = f"{L}="
            if rc_flags[r]:
                codes = revcomp_codes(codes)
            rows.append((codes, int(buckets[r]), int(starts[r]),
                         bool(rc_flags[r]), cig))
        return rows


def random_genome(length: int, seed: int = 0, n_refs: int = 1,
                  name_prefix: str = "synth") -> list[FastaRecord]:
    """Synthetic uniform-random genome (for benches; no egress for real ones)."""
    rng = np.random.RandomState(seed)
    per = length // n_refs
    recs = []
    for i in range(n_refs):
        codes = rng.randint(0, 4, size=per).astype(np.uint8)
        recs.append(FastaRecord(id=f"{name_prefix}_{i}", codes=codes))
    return recs


def repeat_genome(length: int, seed: int = 0, n_refs: int = 1,
                  dup_frac: float = 0.20, mobile_frac: float = 0.07,
                  tandem_frac: float = 0.01, divergence: float = 0.02,
                  identical_frac: float = 0.60,
                  name_prefix: str = "synthrep") -> list[FastaRecord]:
    """Synthetic genome with repeat structure (a uniform-random genome is
    too easy: 1.00006 candidate pairs/read vs. the reference's 1.14-2.7
    locations/read on real genomes, benchmark/README.md:178).

    Three repeat classes layered onto a random backbone:
      * segmental duplications: ~dup_frac of the genome overwritten with
        copies of 2-20 kb segments from elsewhere (like recent SDs);
      * interspersed mobile elements: a small library of 300-3000 bp
        elements pasted many times (LINE/SINE-like) — the main driver
        of multi-mapping reads;
      * short tandem arrays: 2-100 bp units tiled into 0.2-2 kb arrays
        (microsatellite-like) — stresses occurrence multiplicity.

    Each SEGMENTAL-DUP copy is pasted UNMUTATED with probability
    `identical_frac`, else mutated at `divergence` per-base. Identical
    2-copy dups are what produce genuine multi-location reads: a
    diverged copy loses the coarse stage's at-max-hit-count tie
    (best_results, q_gram_mapper.h:90-102) against the original and
    never reaches the locator, so with divergence-only repeats
    locations/read stays ~1.0 (round-2 bench: 1.0131 vs the reference's
    1.14538 on Egu.v3). Mobile elements are ALWAYS diverged: an
    identical ~9000-copy family would push every read inside it past
    the 30-candidate cap and clear it (q_gram_mapper.h:471-476) — real
    LINE/SINE families are old and diverged; only recent SDs are
    near-identical.
    """
    rng = np.random.RandomState(seed)
    per = length // n_refs

    def mutate(seg: np.ndarray, can_be_identical: bool = False) -> np.ndarray:
        if can_be_identical and rng.random_sample() < identical_frac:
            return seg
        m = rng.random_sample(len(seg)) < divergence
        if m.any():
            seg = seg.copy()
            # shift by 1..3 guarantees a different base
            seg[m] = (seg[m] + rng.randint(1, 4, int(m.sum()))) % 4
        return seg

    # mobile-element library shared across refs (elements transpose
    # genome-wide)
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
            codes[at : at + len(e)] = mutate(e)
            covered += len(e)

        covered = 0
        target = dup_frac * per
        while covered < target:
            seg_len = int(rng.randint(2000, 20001))
            src = rng.randint(0, per - seg_len)
            dst = rng.randint(0, per - seg_len)
            seg = codes[src : src + seg_len].copy()
            if rng.randint(2):
                seg = revcomp_codes(seg)
            codes[dst : dst + seg_len] = mutate(seg, can_be_identical=True)
            covered += seg_len

        covered = 0
        target = tandem_frac * per
        while covered < target:
            unit_len = int(rng.randint(2, 101))
            arr_len = int(rng.randint(200, 2001))
            unit = rng.randint(0, 4, unit_len).astype(np.uint8)
            at = rng.randint(0, per - arr_len)
            codes[at : at + arr_len] = np.tile(
                unit, arr_len // unit_len + 1)[:arr_len]
            covered += arr_len

        recs.append(FastaRecord(id=f"{name_prefix}_{i}", codes=codes))
    return recs


class LongReadSimulator:
    """ONT/PacBio-like long-read generator (the reference benchmarks its
    long-read mode on pbsim3 reads, benchmark/long_read/benchmark_map.sh;
    zero-egress here, so this stands in for pbsim3).

    Reads are sampled uniformly from the reference records (not from
    buckets — long reads span bucket boundaries), lengths ~
    N(mean_len, sd_len) clipped to [min_len, 2*mean_len], errors applied
    with the same Poisson D->I->X model and CIGAR bookkeeping as the
    short-read simulator but at long-read rates (5-10% total), 50%
    reverse complement. Ground truth: .position_ground_truth rows
    "ref_id 1-based-pos revcomp cigar" (same format the analyzers read).
    """

    def __init__(self, records: list[FastaRecord], mean_len: int = 5000,
                 sd_len: int = 1500, min_len: int = 1000,
                 substitution_rate: float = 0.02,
                 insertion_rate: float = 0.02, deletion_rate: float = 0.02,
                 seed: int = 0):
        self.records = records
        self.mean_len, self.sd_len, self.min_len = mean_len, sd_len, min_len
        self.rates = (substitution_rate, insertion_rate, deletion_rate)
        self.rng = np.random.RandomState(seed)
        lens = np.asarray([len(r.codes) for r in records], np.float64)
        self._ref_p = lens / lens.sum()

    def sample(self):
        """One read: (codes, ref_id, offset, rev_comp, cigar)."""
        rng = self.rng
        L = int(np.clip(rng.normal(self.mean_len, self.sd_len),
                        self.min_len, 2 * self.mean_len))
        ref_id = int(rng.choice(len(self.records), p=self._ref_p))
        rec = self.records[ref_id].codes
        L = min(L, len(rec))
        start = int(rng.randint(0, len(rec) - L + 1))
        seq = list(rec[start : start + L])
        cigar = ["="] * L
        sub_r, ins_r, del_r = self.rates
        for _ in range(int(rng.poisson(del_r * L))):
            idx = int(rng.randint(len(seq)))
            del seq[idx]
            cigar[idx] = "D"
        for _ in range(int(rng.poisson(ins_r * L))):
            idx = int(rng.randint(len(seq)))
            seq.insert(idx, int(rng.randint(4)))
            cigar.insert(idx, "I")
        for _ in range(int(rng.poisson(sub_r * L))):
            idx = int(rng.randint(len(seq)))
            new = int(rng.randint(4))
            while new == seq[idx]:
                new = int(rng.randint(4))
            seq[idx] = new
            cigar[idx] = "X"
        codes = np.asarray(seq, dtype=np.uint8)
        rc = bool(self.rng.randint(2))
        if rc:
            codes = revcomp_codes(codes)
        return codes, ref_id, start, rc, _cigar_to_string(cigar)

    def generate(self, out_dir: str | os.PathLike, indicator: str,
                 size: int) -> dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "fastq": os.path.join(out_dir, indicator + ".fastq"),
            "position_gt": os.path.join(out_dir,
                                        indicator + ".position_ground_truth"),
        }
        fq, pgt = [], []
        for i in range(size):
            codes, ref_id, offset, rc, cigar = self.sample()
            seq = decode_to_ascii(codes).decode()
            fq.append(f"@{i}\n{seq}\n+\n{'E' * len(seq)}\n")
            pgt.append(f"{ref_id} {offset + 1} {int(rc)} {cigar}\n")
        with open(paths["fastq"], "w") as f:
            f.write("".join(fq))
        with open(paths["position_gt"], "w") as f:
            f.write("".join(pgt))
        return paths
