"""Host-side FASTA reading (vectorized numpy byte-wrangling).

The port's copy of `bucketmap_tpu/io/fasta.py`. Returns 2-bit base codes
per record; the downstream indexer handles the bucket decomposition.
Matches the reference's dna4 semantics: any non-ACGT character (incl. N)
decodes as 'A' (utils.h:181-189; seqan3 dna4 conversion).
"""

from __future__ import annotations

import dataclasses
import os
import numpy as np

from bucketmap_tpu_torch.ops.host_encoding import encode_ascii


@dataclasses.dataclass
class FastaRecord:
    id: str          # full header line after '>' (seqan3 record.id())
    codes: np.ndarray  # uint8 base codes


def read_fasta(path: str | os.PathLike) -> list[FastaRecord]:
    with open(path, "rb") as f:
        data = f.read()
    records: list[FastaRecord] = []
    # split on '>' record starts
    if not data:
        return records
    chunks = data.split(b">")
    for chunk in chunks:
        if not chunk:
            continue
        nl = chunk.find(b"\n")
        if nl < 0:
            continue
        header = chunk[:nl].decode().rstrip("\r")
        seq = chunk[nl + 1 :].translate(None, b"\r\n")
        records.append(FastaRecord(id=header, codes=encode_ascii(seq)))
    return records


def write_fasta(path: str | os.PathLike, records: list[tuple[str, bytes]], width: int = 80) -> None:
    with open(path, "wb") as f:
        for rid, seq in records:
            f.write(b">" + rid.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")
