"""SAM output reproducing the reference's header and record semantics.

The port's copy of `bucketmap_tpu/io/sam.py`; the default program name
stays the JAX package's, so both packages write the same bytes.

Header (bucket_locator.h:472-503): one @SQ per run of identical bucket
names; SN = name truncated at the first space; LN = buckets_in_run *
bucket_len (the reference's acknowledged upper bound, not the true
length). Records carry the full original read sequence and qualities
even for reverse-strand hits (the reference passes record.sequence()
unchanged), flag 16 for reverse strand, POS 1-based, CIGAR '*' in
alignment-free mode.
"""

from __future__ import annotations

import os


class SamWriter:
    def __init__(self, path: str | os.PathLike, ref_names: list[str],
                 ref_lengths: list[int], program_name: str = "bucketmap_tpu"):
        self._f = open(path, "w")
        self._f.write("@HD\tVN:1.6\n")
        for name, length in zip(ref_names, ref_lengths):
            sn = name.split(" ")[0]
            self._f.write(f"@SQ\tSN:{sn}\tLN:{length}\n")
        self._f.write(f"@PG\tID:{program_name}\tPN:{program_name}\n")

    def write(self, qname: str, flag: int, rname: str, pos0: int, mapq: int,
              seq: str, qual: str, cigar: str = "*") -> None:
        """pos0 is 0-based (the reference's ref_offset); SAM POS is 1-based."""
        rname = rname.split(" ")[0]
        self._f.write(
            f"{qname}\t{flag}\t{rname}\t{pos0 + 1}\t{mapq}\t{cigar}\t*\t0\t0\t{seq}\t{qual}\n")

    def write_bytes(self, records: bytes) -> None:
        """Append pre-formatted record lines (the native formatter's)
        after every line written so far."""
        self._f.flush()
        self._f.buffer.write(records)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_sam(path: str | os.PathLike):
    """Minimal SAM reader for the analyzer: yields dict records."""
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            parts = line.rstrip("\n").split("\t")
            yield {
                "qname": parts[0], "flag": int(parts[1]), "rname": parts[2],
                "pos": int(parts[3]), "mapq": int(parts[4]), "cigar": parts[5],
                "seq": parts[9], "qual": parts[10],
            }
