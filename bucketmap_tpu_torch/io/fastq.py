"""Host-side FASTQ reading into fixed-shape batch arrays.

The port's copy of `bucketmap_tpu/io/fastq.py`. The device pipeline
needs static shapes: reads are encoded into (num_reads, max_len) uint8
code/quality-rank matrices plus a length vector. Parsing is the native
host library's where it builds, else vectorized numpy (newline scan +
fancy indexing), so the host input pipeline is not the bottleneck.

Quality follows phred94: rank = ASCII - 33 (utils.h:192-204).
"""

from __future__ import annotations

import dataclasses
import os
import numpy as np

from bucketmap_tpu_torch.ops.host_encoding import _ASCII_TO_CODE
from bucketmap_tpu_torch.utils.debug import no_stage

# bytes iter_fastq_batches reads from the stream at a time
READ_BLOCK = 8 << 20
# the bytes bytes.strip() takes away: a last piece of only these is no
# chunk
_BLANK = np.zeros(256, bool)
_BLANK[list(b" \t\n\r\x0b\x0c")] = True


@dataclasses.dataclass
class ReadBatch:
    codes: np.ndarray       # (n, max_len) uint8, 0-padded
    quals: np.ndarray       # (n, max_len) uint8 phred ranks, 0-padded
    lengths: np.ndarray     # (n,) int32
    seq_ascii: np.ndarray   # (n, max_len) uint8 raw sequence bytes (for SAM echo)
    qual_ascii: np.ndarray  # (n, max_len) uint8 raw quality bytes (for SAM echo)
    # read names kept as one concatenated byte buffer + offsets — python
    # string lists at millions of reads cost seconds on the host path;
    # the SAM formatter consumes the buffers directly
    ids_buf: np.ndarray     # (total_bytes,) uint8 concatenated names
    id_offsets: np.ndarray  # (n+1,) int64
    _ids: list | None = None

    @property
    def ids(self) -> list[str]:
        """Materialized name list (lazy; prefer ids_buf/id_offsets)."""
        if self._ids is None:
            raw = self.ids_buf.tobytes()
            off = self.id_offsets
            self._ids = [raw[off[i]:off[i + 1]].decode()
                         for i in range(len(off) - 1)]
        return self._ids

    @property
    def num_reads(self) -> int:
        return len(self.lengths)

    def head(self, n: int) -> "ReadBatch":
        """First-n-reads view (for warmup batches)."""
        return ReadBatch(codes=self.codes[:n], quals=self.quals[:n],
                         lengths=self.lengths[:n],
                         seq_ascii=self.seq_ascii[:n],
                         qual_ascii=self.qual_ascii[:n],
                         ids_buf=self.ids_buf,
                         id_offsets=self.id_offsets[: n + 1])

    @classmethod
    def from_arrays(cls, ids: list[str], codes: np.ndarray,
                    quals: np.ndarray, lengths: np.ndarray) -> "ReadBatch":
        """Build a batch from code/qual arrays (tests, simulators)."""
        lut = np.frombuffer(b"ACGT", np.uint8)
        col = np.arange(codes.shape[1])
        mask = col[None, :] < np.asarray(lengths)[:, None]
        seq_ascii = np.where(mask, lut[codes % 4], 0).astype(np.uint8)
        qual_ascii = np.where(mask, quals.astype(np.int16) + 33, 0).astype(np.uint8)
        ids_buf, id_offsets = cls.pack_ids(ids)
        return cls(codes=codes, quals=quals,
                   lengths=np.asarray(lengths, np.int32),
                   seq_ascii=seq_ascii, qual_ascii=qual_ascii,
                   ids_buf=ids_buf, id_offsets=id_offsets)

    @staticmethod
    def pack_ids(ids: list[str]) -> tuple[np.ndarray, np.ndarray]:
        enc = [i.encode() for i in ids]
        off = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=off[1:])
        buf = np.frombuffer(b"".join(enc), np.uint8) if enc else \
            np.zeros(0, np.uint8)
        return buf, off


def read_fastq(path: str | os.PathLike, max_len: int | None = None,
               use_native: bool = True) -> ReadBatch:
    with open(path, "rb") as f:
        data = f.read()
    return parse_fastq(data, max_len=max_len, use_native=use_native)


def parse_fastq(data, max_len: int | None = None,
                use_native: bool = True) -> ReadBatch:
    """Parse one FASTQ buffer (bytes, or a contiguous uint8 view, read in
    place) into a ReadBatch (the body of read_fastq, factored out for the
    streaming iterator). No array of the batch shares memory with
    `data`."""
    if use_native:
        from bucketmap_tpu_torch.io import native
        res = native.parse_fastq_bytes(data, max_len=max_len)
        if res is not None:
            ids_buf, id_offsets, codes, quals, lengths, seq_ascii, qual_ascii = res
            return ReadBatch(codes=codes, quals=quals,
                             lengths=lengths, seq_ascii=seq_ascii,
                             qual_ascii=qual_ascii, ids_buf=ids_buf,
                             id_offsets=id_offsets)
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) and buf[-1] == ord("\n"):
        buf = buf[:-1]
    # Line index via newline scan (no per-read python loop for the payload).
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [len(buf)]])
    nlines = len(starts)
    if nlines % 4 != 0:
        raise ValueError(f"FASTQ line count {nlines} not a multiple of 4")
    n = nlines // 4

    seq_s, seq_e = starts[1::4], ends[1::4]
    qual_s, qual_e = starts[3::4], ends[3::4]
    lengths = (seq_e - seq_s).astype(np.int32)
    if np.any((qual_e - qual_s) != lengths):
        raise ValueError("FASTQ sequence/quality length mismatch")
    L = int(lengths.max()) if max_len is None else int(max_len)

    # gather: row i, col j  <- buf[seq_s[i] + j], masked by length
    col = np.arange(L)
    idx = seq_s[:, None] + col[None, :]
    mask = col[None, :] < lengths[:, None]
    idx = np.where(mask, idx, 0)
    seq_ascii = np.where(mask, buf[idx], 0).astype(np.uint8)
    qidx = np.where(mask, qual_s[:, None] + col[None, :], 0)
    qual_ascii = np.where(mask, buf[qidx], 0).astype(np.uint8)

    codes = _ASCII_TO_CODE[seq_ascii]
    quals = np.where(mask, qual_ascii.astype(np.int16) - 33, 0).astype(np.uint8)

    # ids: concatenated header bytes (strip '@' and trailing '\r')
    id_s = starts[0::4] + 1
    id_e = ends[0::4].copy()
    crl = buf[np.maximum(id_e - 1, 0)] == ord("\r")
    id_e[crl] -= 1
    id_lens = id_e - id_s
    id_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(id_lens, out=id_offsets[1:])
    icol = np.arange(int(id_lens.max()) if n else 0)
    imask = icol[None, :] < id_lens[:, None]
    gath = np.where(imask, buf[np.where(imask, id_s[:, None] + icol[None, :], 0)], 0)
    ids_buf = gath[imask].astype(np.uint8)
    return ReadBatch(codes=codes, quals=quals, lengths=lengths,
                     seq_ascii=seq_ascii, qual_ascii=qual_ascii,
                     ids_buf=ids_buf, id_offsets=id_offsets)


def iter_fastq_batches(path: str | os.PathLike,
                       reads_per_batch: int = 131072,
                       max_len: int | None = None,
                       use_native: bool = True,
                       bytes_per_batch: int = 128 << 20,
                       stage=no_stage, stats=None):
    """Stream a FASTQ as ReadBatch chunks of `reads_per_batch` reads
    (the last one smaller), holding ~one chunk of file bytes at a time.

    The full-file path materializes 4 dense (n, L) matrices plus the
    whole byte buffer — ~2 GB for 1M x 300bp — before mapping even
    starts; the reference holds ~0.87 GB TOTAL (benchmark/README.md:168).
    Streaming parse + map + emit per chunk is the memory story: peak
    host residency is one chunk being mapped plus one being written.

    The stream is read in READ_BLOCK blocks into one reused buffer, and
    after each block the chunks it completes are cut and parsed in place.
    Record boundaries: a FASTQ record is exactly 4 lines, so the cut
    point after k complete records is the byte after the 4k-th newline,
    found by the host library's cut (numpy's newline scan without it),
    which scans each byte once.

    `bytes_per_batch` also caps a chunk's FILE bytes, so long-read files
    (7.5 kb+ records) chunk by volume instead of record count — a 100k
    x 7.5 kb file as one "chunk" would both blow host RSS (4 dense
    (n, max_len) matrices) and serialize its whole parse ahead of
    mapping: once the pending bytes reach it, after a block, every
    complete record pending makes the chunk. The buffer holds at most
    one chunk's bytes plus one block.

    `stage(name)` is entered as "parse" around each chunk's parse_fastq
    (the pipeline's stage hook; nothing by default). Where `stats` is
    given (a MapStats), each chunk adds 1 to its `parse_chunks`, and to
    its `parse_native_chunks` where the host library parsed it.
    """
    from bucketmap_tpu_torch.io import native
    use_native = use_native and native.available()
    target_nl = 4 * reads_per_batch
    buf = np.empty(0, np.uint8)
    # the pending bytes are buf[start:end]; buf[start:scanned] holds
    # `seen` newlines, and no cut lies before `scanned`
    start = scanned = end = seen = 0

    def cut(lo: int, want: int) -> tuple[int, int]:
        """(newlines of buf[lo:end] counted up to `want`, the byte after
        the last one counted)"""
        view = buf[lo:end]
        found = native.fastq_cut(view, want) if use_native else None
        if found is not None:
            got, after = found
        else:
            nl = np.flatnonzero(view == ord("\n"))[:want]
            got, after = len(nl), (int(nl[-1]) + 1 if len(nl) else 0)
        return got, lo + after

    def parse(lo: int, hi: int) -> ReadBatch:
        with stage("parse"):
            batch = parse_fastq(buf[lo:hi], max_len=max_len,
                                use_native=use_native)
        if stats is not None:
            stats.parse_chunks += 1
            stats.parse_native_chunks += use_native
        return batch

    with open(path, "rb") as f:
        while True:
            rest = end - start
            if rest + READ_BLOCK > len(buf):
                grown = np.empty(max(2 * len(buf), rest + READ_BLOCK),
                                 np.uint8)
                grown[:rest] = buf[start:end]
                buf = grown
            elif start:
                buf[:rest] = buf[start:end]
            scanned -= start
            start, end = 0, rest
            n = f.readinto(memoryview(buf)[end:end + READ_BLOCK])
            if not n:
                break
            end += n
            while True:
                got, at = cut(scanned, target_nl - seen)
                if seen + got < target_nl:
                    seen += got
                    scanned = end
                    break
                yield parse(start, at)
                start = scanned = at
                seen = 0
            if end - start >= bytes_per_batch and seen >= 4:
                _, at = cut(start, seen - seen % 4)
                yield parse(start, at)
                start = at
                seen %= 4
    if end > start and not _BLANK[buf[start:end]].all():
        yield parse(start, end)
