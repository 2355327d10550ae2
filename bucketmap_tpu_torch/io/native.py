"""ctypes bindings for the native host library (csrc/host/bmtpu_io.cpp,
csrc/host/bmtpu_index.cpp).

The port's copy of `bucketmap_tpu/io/native.py`. Builds the shared
library with g++ on first use, into
`csrc/build/host/<hash of sources and flags>/` beside the CUDA build,
and falls back to the numpy implementations when it is unavailable. The
device pipeline is unaffected either way — this accelerates the host
edges (FASTQ parse ~10x, SAM formatting ~10x over the python/numpy
paths).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("bmtpu_io.cpp", "bmtpu_index.cpp")
# no -march=native (the JAX package's Makefile has it): a library built
# on one host must load on another that gets a copy of the tree
_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str:
    """Compile the host library unless this exact build exists; returns
    its path. Writes to a temporary name first, so processes that build
    at once never load a half-written file."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    srcs = [os.path.join(_CSRC, "host", name) for name in _SOURCES]
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    out_dir = os.path.join(_CSRC, "build", "host", h.hexdigest()[:16])
    so = os.path.join(out_dir, "libbmtorch_host.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        subprocess.run(["g++", *_FLAGS, "-o", tmp, *srcs], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
            i64, i32, u8p, c_p = (ctypes.c_int64, ctypes.c_int32,
                                  np.ctypeslib.ndpointer(np.uint8),
                                  ctypes.c_void_p)
            i64p = np.ctypeslib.ndpointer(np.int64)
            i32p = np.ctypeslib.ndpointer(np.int32)
            i64_out = ctypes.POINTER(ctypes.c_int64)
            lib.bmtpu_fastq_stat.restype = i64
            lib.bmtpu_fastq_stat.argtypes = [c_p, i64, i64_out, i64_out]
            lib.bmtpu_fastq_parse.restype = i64
            lib.bmtpu_fastq_parse.argtypes = [
                c_p, i64, i64, u8p, u8p, u8p, u8p, i32p, i64p,
                np.ctypeslib.ndpointer(np.uint8), i64]
            lib.bmtpu_fastq_cut.restype = i64
            lib.bmtpu_fastq_cut.argtypes = [c_p, i64, i64, i64_out]
            lib.bmtpu_pack_reads.restype = None
            lib.bmtpu_pack_reads.argtypes = [
                i64, i64, u8p, u8p, i32p, i64, i64,
                np.ctypeslib.ndpointer(np.uint32)]
            lib.bmtpu_cigar_rle.restype = i64
            lib.bmtpu_cigar_rle.argtypes = [
                i64, i64, i64, np.ctypeslib.ndpointer(np.uint32),
                np.ctypeslib.ndpointer(np.uint8), i64, i64p]
            lib.bmtpu_runs_to_cigar.restype = i64
            lib.bmtpu_runs_to_cigar.argtypes = [
                i64, np.ctypeslib.ndpointer(np.uint16), i64p,
                np.ctypeslib.ndpointer(np.uint8), i64, i64p]
            lib.bmtpu_format_sam.restype = i64
            lib.bmtpu_format_sam.argtypes = [
                i64, i32p, i64p, np.ctypeslib.ndpointer(np.uint8),
                i32p, i32p, i64p, np.ctypeslib.ndpointer(np.uint8),
                i64p, i32p, i64p, np.ctypeslib.ndpointer(np.uint8),
                i32p, i32p, u8p, u8p, i64, np.ctypeslib.ndpointer(np.uint8), i64]
            u32p = np.ctypeslib.ndpointer(np.uint32)
            lib.bmtpu_build_occupancy.restype = i64
            lib.bmtpu_build_occupancy.argtypes = [
                u8p, i64, i64, i64, i64, i32p, u32p, i64, i64, u32p, i64]
            lib.bmtpu_build_fine.restype = i64
            lib.bmtpu_build_fine.argtypes = [
                u32p, i64, i64, i32p, i64, i64, u32p, i32p, i64]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def parse_fastq_bytes(data, max_len: int | None = None):
    """Native FASTQ parse of `data` (bytes, or a contiguous uint8 view
    such as a slice of the streaming reader's buffer, read in place) ->
    (ids_buf, id_offsets, codes, quals, lengths, seq_ascii, qual_ascii),
    or None when the native library is unavailable. Read names stay as
    one byte buffer + offsets (no python string list); no array returned
    shares memory with `data`."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    ptr, size = buf.ctypes.data, len(buf)
    n = ctypes.c_int64()
    ml = ctypes.c_int64()
    if lib.bmtpu_fastq_stat(ptr, size, ctypes.byref(n), ctypes.byref(ml)) != 0:
        raise ValueError("malformed FASTQ (native parser)")
    n, ml_detected = n.value, ml.value
    L = ml_detected if max_len is None else max(max_len, ml_detected)
    codes = np.zeros((n, L), np.uint8)
    quals = np.zeros((n, L), np.uint8)
    seq_ascii = np.zeros((n, L), np.uint8)
    qual_ascii = np.zeros((n, L), np.uint8)
    lengths = np.zeros(n, np.int32)
    id_offsets = np.zeros(n + 1, np.int64)
    # names are typically ~8-30 bytes; a size-sized buffer added
    # ~100 MB/chunk of transient RSS to the streamed path. Start small;
    # the C side returns -1 on capacity overflow and one retry at full
    # size covers pathological name lengths.
    ids_cap = min(size, max(1 << 20, n * 64))
    ids_buf = np.zeros(ids_cap, np.uint8)
    r = lib.bmtpu_fastq_parse(ptr, size, L, codes, quals, seq_ascii,
                              qual_ascii, lengths, id_offsets, ids_buf,
                              len(ids_buf))
    if r < 0 and ids_cap < size:
        ids_buf = np.zeros(size, np.uint8)
        r = lib.bmtpu_fastq_parse(ptr, size, L, codes, quals,
                                  seq_ascii, qual_ascii, lengths,
                                  id_offsets, ids_buf, len(ids_buf))
    if r < 0:
        raise ValueError("malformed FASTQ (native parser, pass 2)")
    return (ids_buf[:r].copy(), id_offsets, codes, quals, lengths,
            seq_ascii, qual_ascii)


def fastq_cut(view: np.ndarray, want: int):
    """Native record cut: (newlines counted in the contiguous uint8
    `view`, up to `want`; the byte after the last one counted, 0 if
    none), or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    after = ctypes.c_int64()
    seen = lib.bmtpu_fastq_cut(view.ctypes.data, len(view), want,
                               ctypes.byref(after))
    return seen, after.value


def pack_reads(codes, quals, lengths, k: int, min_kmer_quality: int):
    """Native batched transfer packing (encoding.pack_reads twin) ->
    (B, cw+qw+1) uint32, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    quals = np.ascontiguousarray(quals, np.uint8)
    B, L = codes.shape
    cw = (L + 15) // 16
    qw = (L - k + 1 + 31) // 32
    out = np.empty((B, cw + qw + 1), np.uint32)
    lib.bmtpu_pack_reads(B, L, codes, quals,
                         np.ascontiguousarray(lengths, np.int32),
                         k, min_kmer_quality, out)
    return out


def cigar_rle(packed: np.ndarray, max_ops: int):
    """Native CIGAR run-length encoding of 2-bit packed reversed
    traceback rows -> (cigar_buf bytes, offsets (n+1,) int64), or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint32)
    n, ow = packed.shape
    offsets = np.zeros(n + 1, np.int64)
    # worst case: alternating ops, 2+ bytes per op; 8*max_ops is generous
    buf = np.empty(max(4096, 8 * max_ops * max(n, 1)), np.uint8)
    w = lib.bmtpu_cigar_rle(n, ow, max_ops, packed, buf, len(buf), offsets)
    if w < 0:
        raise RuntimeError("CIGAR RLE buffer overflow")
    return buf[:w].tobytes(), offsets


def runs_to_cigar(runs: np.ndarray, row_off: np.ndarray):
    """Native CIGAR formatting of device-RLE'd runs (uint16
    length << 2 | op, query order) -> (cigar_buf bytes, offsets (n,1,)
    int64 == row byte spans), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    runs = np.ascontiguousarray(runs, np.uint16)
    row_off = np.ascontiguousarray(row_off, np.int64)
    n = len(row_off) - 1
    offsets = np.zeros(n + 1, np.int64)
    buf = np.empty(max(4096, 8 * int(row_off[-1])), np.uint8)
    w = lib.bmtpu_runs_to_cigar(n, runs, row_off, buf, len(buf), offsets)
    if w < 0:
        raise RuntimeError("CIGAR runs buffer overflow")
    return buf[:w].tobytes(), offsets


def format_sam_records(qid, id_offsets, ids_buf, flag, rid, rname_offsets,
                       rnames_buf, pos0, mapq, cigar_offsets, cigar_buf,
                       read_row, seq_len, seq_ascii, qual_ascii):
    """Native batched SAM record formatting -> bytes, or None if lib absent."""
    lib = _load()
    if lib is None:
        return None
    n = len(qid)
    max_len = seq_ascii.shape[1]
    est = int(cigar_offsets[-1]) + int(2 * np.sum(seq_len)) + 96 * n + \
        int(id_offsets[-1]) + int(rname_offsets[-1])
    out = np.zeros(est + 4096, np.uint8)
    w = lib.bmtpu_format_sam(
        n, np.ascontiguousarray(qid, np.int32),
        np.ascontiguousarray(id_offsets, np.int64),
        np.frombuffer(ids_buf, np.uint8) if isinstance(ids_buf, bytes) else ids_buf,
        np.ascontiguousarray(flag, np.int32),
        np.ascontiguousarray(rid, np.int32),
        np.ascontiguousarray(rname_offsets, np.int64),
        np.frombuffer(rnames_buf, np.uint8) if isinstance(rnames_buf, bytes) else rnames_buf,
        np.ascontiguousarray(pos0, np.int64),
        np.ascontiguousarray(mapq, np.int32),
        np.ascontiguousarray(cigar_offsets, np.int64),
        np.frombuffer(cigar_buf, np.uint8) if isinstance(cigar_buf, bytes) else cigar_buf,
        np.ascontiguousarray(read_row, np.int32),
        np.ascontiguousarray(seq_len, np.int32),
        np.ascontiguousarray(seq_ascii, np.uint8),
        np.ascontiguousarray(qual_ascii, np.uint8),
        max_len, out, len(out))
    if w < 0:
        raise RuntimeError("SAM output buffer overflow")
    return out[:w].tobytes()


def build_occupancy(codes, total, q, bucket_len, read_len, ktr, qg, b0, bp):
    """Native occupancy scatter + bucket packing for one FASTA record
    (csrc/bmtpu_index.cpp). Mutates qg/bp in place; returns the bucket
    count emitted, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.bmtpu_build_occupancy(
        np.ascontiguousarray(codes, np.uint8), total, q, bucket_len,
        read_len, np.ascontiguousarray(ktr, np.int32), qg, qg.shape[1],
        b0, bp, bp.shape[1]))


def build_fine(bp, lengths, k, low_bits, fine_packed, ptab):
    """Native LSD-radix fine-index build (csrc/bmtpu_index.cpp).
    Fills fine_packed/ptab in place; returns max segment length, or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n, lpos = fine_packed.shape
    r = int(lib.bmtpu_build_fine(
        np.ascontiguousarray(bp, np.uint32), n, bp.shape[1],
        np.ascontiguousarray(lengths, np.int32), k, low_bits,
        fine_packed, ptab, lpos))
    if r < 0:
        raise RuntimeError("bmtpu_build_fine: bad arguments")
    return r
