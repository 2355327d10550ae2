"""SAM accuracy scorer — behavioral port of benchmark/sam_file_analyzer.cpp.

The port's copy of `bucketmap_tpu/bench/sam_analyzer.py`, on the port's
own FASTA/FASTQ/SAM readers: the same truth, the same scores and the
same printed report, line for line.

Ground-truth sources (all of the reference's modes, :60-248):
  * the project simulator's .position_ground_truth / .bucket_ground_truth
    ("origin position revcomp cigar", one line per read index),
  * dwgsim-encoded read names (chr_pos_..._strand_..._random flags),
  * pbsim3 .maf alignment records,
  * a trusted mapper's SAM as pseudo-truth (read_best_alignment_file).

benchmark() reports the reference's metric set (:250-358): %mapped,
sensitivity vs uniquely-mapped truth, false positives on random reads,
mapped locations per read, and precision within an offset tolerance.
"""

from __future__ import annotations

import dataclasses
import os
import re

from bucketmap_tpu_torch.io.sam import read_sam


def _space_to_underscore(s: str) -> str:
    return s.replace(" ", "_")


def _strip_after_slash_or_blank(s: str) -> str:
    cut = len(s)
    for ch in ("/", " "):
        p = s.find(ch)
        if p >= 0:
            cut = min(cut, p)
    return s[:cut]


@dataclasses.dataclass
class MapPosition:
    reverse_complement: bool
    sequence_id: int
    offset: int
    is_random: bool = False


@dataclasses.dataclass
class BenchmarkResult:
    total_reads: int
    random_reads: int
    uniquely_mapped_truth: int
    mapped_reads: int
    pct_mapped: float
    correctly_mapped: int
    sensitivity_pct: float
    mapped_random_reads: int
    false_positive_pct: float
    mapped_locations: int
    locations_per_mapped_read: float
    acceptable_locations: int
    precision_pct: float


class SamAnalyzer:
    def __init__(self, error_tolerance: int = 5):
        self.tol = error_tolerance
        self.read_id_to_index: dict[str, int] = {}
        self.sequence_id_to_index: dict[str, int] = {}
        self.answer: list[list[MapPosition]] = []
        self.is_random_read: list[bool] = []
        self.ref_name_to_id: dict[str, int] = {}

    # ---- truth ingestion ---------------------------------------------------
    def read_fasta_file(self, fasta_path) -> None:
        from bucketmap_tpu_torch.io.fasta import read_fasta
        for i, rec in enumerate(read_fasta(fasta_path)):
            self.sequence_id_to_index[_strip_after_slash_or_blank(rec.id)] = i

    def read_sequence_file(self, fastq_path, is_dwgsim: bool = False) -> None:
        from bucketmap_tpu_torch.io.fastq import read_fastq
        batch = read_fastq(fastq_path)
        for i, rid in enumerate(batch.ids):
            renamed = _strip_after_slash_or_blank(_space_to_underscore(rid))
            self.read_id_to_index.setdefault(renamed, i)
            if is_dwgsim:
                parts = re.split("[_:]", renamed)
                gt = MapPosition(
                    reverse_complement=bool(int(parts[4])),
                    sequence_id=self.sequence_id_to_index.get(
                        parts[0] + "_" + parts[1], 0),
                    offset=int(parts[2]),
                    is_random=bool(int(parts[6])),
                )
                self.is_random_read.append(gt.is_random)
                self.answer.append([gt])
            else:
                self.answer.append([])
                self.is_random_read.append(False)

    def read_ground_truth_file(self, path) -> None:
        path = os.fspath(path)
        if path.endswith(".maf"):
            toks = open(path).read().split()
            # pbsim3 maf: 15 whitespace tokens per record pair (see :151-176)
            for i in range(0, len(toks) - 14, 15):
                offset = int(toks[i + 3])
                read_name = toks[i + 9]
                rc = toks[i + 12] == "-"
                if read_name not in self.read_id_to_index:
                    continue
                seq_id = int(read_name[read_name.find("S") + 1 : read_name.find("_")]) - 1
                self.answer[self.read_id_to_index[read_name]].append(
                    MapPosition(rc, seq_id, offset))
        else:
            # project simulator: "origin position revcomp cigar" per read index
            for idx, line in enumerate(open(path)):
                parts = line.split()
                if len(parts) < 3 or idx >= len(self.answer):
                    break
                self.answer[idx].append(MapPosition(
                    reverse_complement=bool(int(parts[2])),
                    sequence_id=int(parts[0]), offset=int(parts[1])))

    def read_best_alignment_file(self, sam_path) -> None:
        """Use a trusted mapper's SAM as pseudo-ground-truth (:85-123)."""
        self._ensure_ref_ids(sam_path)
        for rec in read_sam(sam_path):
            renamed = _strip_after_slash_or_blank(_space_to_underscore(rec["qname"]))
            idx = self.read_id_to_index.get(renamed)
            if idx is None or rec["flag"] & 4:
                continue
            self.answer[idx].append(MapPosition(
                reverse_complement=bool(rec["flag"] & 16),
                sequence_id=self.ref_name_to_id.get(rec["rname"], -1),
                offset=rec["pos"] - 1))

    def _ensure_ref_ids(self, sam_path) -> None:
        if self.ref_name_to_id:
            return
        with open(sam_path) as f:
            n = 0
            for line in f:
                if not line.startswith("@"):
                    break
                if line.startswith("@SQ"):
                    sn = dict(kv.split(":", 1) for kv in line.rstrip().split("\t")[1:])["SN"]
                    self.ref_name_to_id[sn] = n
                    n += 1

    # ---- scoring -----------------------------------------------------------
    def benchmark(self, sam_path, quiet: bool = False) -> BenchmarkResult:
        n = len(self.answer)
        mapped = [False] * n
        correct = [False] * n
        mapped_random = [False] * n
        mapped_locations = 0
        acceptable = 0
        self._ensure_ref_ids(sam_path)

        for rec in read_sam(sam_path):
            renamed = _strip_after_slash_or_blank(_space_to_underscore(rec["qname"]))
            idx = self.read_id_to_index.get(renamed)
            if idx is None or rec["flag"] & 4:
                continue
            mapped[idx] = True
            mapped_locations += 1
            if self.is_random_read[idx]:
                mapped_random[idx] = True
                continue
            rc = bool(rec["flag"] & 16)
            ref_id = self.ref_name_to_id.get(rec["rname"], -2)
            # 0-based SAM position against the truth's offset as its file
            # has it: the simulator's position truth is 1-based, so this
            # window sits one base off `world.score_sam`'s, as in the JAX
            # package, whose scores this must equal
            pos0 = rec["pos"] - 1
            ok = False
            for ans in self.answer[idx]:
                if (rc == ans.reverse_complement and ref_id == ans.sequence_id
                        and abs(pos0 - ans.offset) <= self.tol):
                    correct[idx] = True
                    ok = True
            if ok:
                acceptable += 1

        num_random = sum(self.is_random_read)
        unique_truth = sum(1 for a in self.answer if len(a) == 1)
        num_mapped = sum(mapped)
        num_correct = sum(correct)
        num_mapped_random = sum(mapped_random)
        res = BenchmarkResult(
            total_reads=n, random_reads=num_random,
            uniquely_mapped_truth=unique_truth,
            mapped_reads=num_mapped,
            pct_mapped=100.0 * num_mapped / max(1, n - num_random),
            correctly_mapped=num_correct,
            sensitivity_pct=100.0 * num_correct / max(1, unique_truth),
            mapped_random_reads=num_mapped_random,
            false_positive_pct=100.0 * num_mapped_random / max(1, num_random),
            mapped_locations=mapped_locations,
            locations_per_mapped_read=mapped_locations / max(1, num_mapped),
            acceptable_locations=acceptable,
            precision_pct=100.0 * acceptable / max(1, mapped_locations),
        )
        if not quiet:
            print(f"[BENCHMARK]\t============ {sam_path} ============")
            print(f"[BENCHMARK]\tTotal number of reads: {res.total_reads}.")
            print(f"[BENCHMARK]\tTotal number of random reads: {res.random_reads}.")
            print(f"[BENCHMARK]\tTotal number of mapped reads: {res.mapped_reads} "
                  f"({res.pct_mapped:.4g}%).")
            print(f"[BENCHMARK]\tCorrectly mapped (sensitivity): {res.correctly_mapped} "
                  f"({res.sensitivity_pct:.4g}%).")
            print(f"[BENCHMARK]\tMapped random reads (false positives): "
                  f"{res.mapped_random_reads} ({res.false_positive_pct:.4g}%).")
            print(f"[BENCHMARK]\tMapped locations: {res.mapped_locations} "
                  f"({res.locations_per_mapped_read:.4g} per mapped read).")
            print(f"[BENCHMARK]\tAcceptable locations (precision): "
                  f"{res.acceptable_locations} ({res.precision_pct:.4g}%).")
        return res

    def benchmark_directory(self, directory) -> dict[str, BenchmarkResult]:
        out = {}
        for name in sorted(os.listdir(directory)):
            if name.endswith(".sam"):
                out[name] = self.benchmark(os.path.join(directory, name))
        return out
