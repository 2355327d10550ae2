"""Offline index construction.

The port's copy of `bucketmap_tpu/index/builder.py`, without the JAX
package's slab upload and memmap staging for its remote device link,
and without its BMTPU_HOST_BUILD_NATIVE switch: the native host library
is used wherever it builds, else the numpy path. The on-disk artifact is
the same, so one saved index serves both packages; `index_from_arrays`
carries an index held in memory across.

Produces the three logical tables of the reference index
(bucket_indexer.h:76-127) in a device-friendly layout:

  * q-gram occupancy bit-matrix: uint32[G+1, W] words (W = ceil(N/32));
    bit b of word w = bucket 32w+b present. Row G is an all-ones
    sentinel standing in for q-grams not sampled by FracMinHash (the
    reference skips those in the AND chain, q_gram_mapper.h:404-405).
  * kmer_to_row: int32[4^q], -1 for unsampled q-grams, else row index —
    the FracMinHash table (bucket_indexer.h:147-159).
  * bucket metadata: names (the full FASTA id, repeated per bucket, as
    in .bucket_id), per-reference bucket ordinals, and actual lengths.

Plus what the reference rebuilds at locate time (its 384s hotspot,
bucket_locator.h:162-177): we instead keep every bucket's sequence
2-bit-packed as a dense uint32[N, Wb] matrix so the fine stage is a
single gather + vectorized compare on device.

Bucket decomposition matches utils.h:60-102: per record,
ceil(len/bucket_len) buckets of [i*L, i*L+L+read_len), residuals
<= read_len dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import numpy as np

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.io.fasta import FastaRecord, read_fasta
from bucketmap_tpu_torch.ops.host_encoding import kmer_hashes, pack_2bit

# Prime table for the universal hash (hash_function_generator.h:25-88 keeps a
# standard SGI/tr1 prime ladder; we only ever need the first prime above
# 10*hash_table_size, so a short ladder suffices).
_PRIMES = [
    5, 11, 23, 47, 97, 199, 409, 823, 1741, 3469, 6949, 14033, 28411, 57557,
    116731, 236897, 480881, 976369, 1982627, 4026031, 8175383, 16601593,
    33712729, 68460391, 139022417, 282312799, 573292817, 1164186217,
    2364114217, 4294967291,
]


def _choose_prime_larger_than(size: int) -> int:
    for p in _PRIMES:
        if p > size:
            return p
    raise ValueError(f"no prime above {size} in table")


def frac_min_hash_table(cfg: MapperConfig) -> np.ndarray:
    """kmer_to_row: int32[4^q]; row index if sampled by FracMinHash else -1.

    Universal hash h(x) = (a*x + b) % p % table_size, keep iff
    h(g) <= table_size * fraction (main.cpp:176-185,
    hash_function_generator.h:105-117). Reference seeds with time(); we
    use a seeded RNG for reproducibility.
    """
    p = _choose_prime_larger_than(10 * cfg.hash_table_size)
    rng = np.random.RandomState(cfg.frac_hash_seed)
    a = rng.randint(1, p - 1)
    b = rng.randint(0, p)
    g = np.arange(cfg.num_qgrams, dtype=np.uint64)
    hv = (np.uint64(a) * g + np.uint64(b)) % np.uint64(p) % np.uint64(cfg.hash_table_size)
    keep = hv <= np.uint64(cfg.frac_hash_threshold)
    rows = np.cumsum(keep, dtype=np.int64) - 1
    return np.where(keep, rows, -1).astype(np.int32)


@dataclasses.dataclass
class BucketIndex:
    config: MapperConfig
    ref_names: list[str]          # collapsed reference names (first token kept at SAM time)
    bucket_names: list[str]       # full record id per bucket (.bucket_id content)
    bucket_ref: np.ndarray        # (N,) int32 index into ref_names
    bucket_ordinal: np.ndarray    # (N,) int32 bucket index within its reference
    bucket_lengths: np.ndarray    # (N,) int32 true sequence length incl. overlap
    kmer_to_row: np.ndarray       # (4^q,) int32
    qgram_words: np.ndarray       # (G+1, W) uint32; row G all-ones sentinel
    zeros: np.ndarray             # (G+1,) int32 N - popcount; sentinel row = -1
    buckets_packed: np.ndarray    # (N, Wb) uint32
    # Optional positional fine index: per bucket, k-mer POSITIONS ordered
    # by ascending k-mer hash (stable, so equal hashes keep position
    # order); -1 pads past the bucket's valid k-mers. The fine stage
    # binary-searches occurrences, deriving the hash at a probe from the
    # packed bucket sequence — storing positions only (4 B/base instead
    # of 8) is what lets a 1.7 Gbp index fit one chip's HBM (SURVEY §7.1).
    fine_pos: np.ndarray | None = None    # (N, Lpos) int32, -1-padded
    # Prefix acceleration for the fine index (built alongside fine_pos
    # when 2*query_seed - 12 <= 16): the sorted hash at each slot is
    # split into a 12-bit prefix and (2k-12) low bits;
    #   fine_ptab[b, p] = first slot in bucket b whose hash prefix >= p
    #   fine_low[b, i]  = low bits of the sorted hash at slot i (0xFFFF pad)
    # so a lookup is ONE ptab gather + a short binary search over uint16
    # instead of 17 packed-row derivations (3 gathers each). The max
    # prefix-segment length bounds the search depth (fine_search_steps).
    fine_ptab: np.ndarray | None = None   # (N, 4097) int32
    fine_low: np.ndarray | None = None    # (N, Lpos) uint16
    fine_search_steps: int = 0
    # Fused slot encoding (preferred fine path): position and low bits in
    # ONE uint32 per slot, (pos << low_bits) | low — the occurrence
    # phase reads position AND verifies the hash with a single gather,
    # and HBM holds 4 B/base instead of fine_pos+fine_low's 6 B/base.
    # Available when lpos <= 2^(32 - low_bits) (true for the production
    # k=12 / 64 KiB-bucket config: 20 position bits >> 17 needed).
    fine_packed: np.ndarray | None = None  # (N, Lpos) uint32, 0xFFFFFFFF pad
    fine_low_bits: int = 0

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_names)

    @property
    def words_per_row(self) -> int:
        return self.qgram_words.shape[1]

    def ref_offset_of_bucket(self) -> np.ndarray:
        """Offset of each bucket inside its (SAM) reference:
        ordinal * bucket_len (bucket_locator.h:497)."""
        return self.bucket_ordinal.astype(np.int64) * self.config.bucket_len

    def sam_ref_lengths(self) -> list[int]:
        """Reference lengths for the SAM header: buckets-per-ref * bucket_len —
        the reference's (acknowledged) upper bound (bucket_locator.h:491)."""
        counts = np.bincount(self.bucket_ref, minlength=len(self.ref_names))
        return [int(c) * self.config.bucket_len for c in counts]


def iterate_buckets(records: list[FastaRecord], cfg: MapperConfig):
    """Yield (record_id, start, codes_slice) per bucket (utils.h:60-102)."""
    for rec in records:
        total = len(rec.codes)
        n_b = int(np.ceil(total / cfg.bucket_len)) if total else 0
        for i in range(n_b):
            start = i * cfg.bucket_len
            end = min(start + cfg.bucket_len + cfg.read_len, total)
            if end - start <= cfg.read_len:
                continue
            yield rec.id, start, rec.codes[start:end]


def build_fine_index(index: BucketIndex, row_chunk: int = 512,
                     keep_unpacked: bool | None = None) -> None:
    """Attach the positional fine index (hash-ordered k-mer positions) to
    an index in place.

    Preferred layout: `fine_packed` — one uint32 per slot holding
    (position << low_bits) | hash-low-bits — plus the 12-bit-prefix
    segment table `fine_ptab`. 4 bytes per genome base. When the packed
    encoding doesn't fit (very long buckets x large k), or with
    keep_unpacked=True (kernel-equality tests), the separate
    fine_pos/fine_low arrays are kept instead/as well."""
    from bucketmap_tpu_torch.ops.host_encoding import kmer_hashes, unpack_2bit

    cfg = index.config
    k = cfg.query_seed
    if k >= 16:
        raise ValueError("positional fine index requires query_seed <= 15 "
                         "(the sort uses 0xFFFFFFFF as the padding sentinel)")
    n = index.n_buckets
    lb = index.buckets_packed.shape[1] * 16
    lpos = lb - k + 1
    low_bits = 2 * k - 12
    with_prefix = 0 <= low_bits <= 16
    with_packed = with_prefix and lpos <= (1 << (32 - low_bits))
    if keep_unpacked is None:
        keep_unpacked = not with_packed
    fine_pos = np.empty((n, lpos), dtype=np.int32) if keep_unpacked else None
    fine_ptab = np.empty((n, 4097), dtype=np.int32) if with_prefix else None
    fine_low = np.empty((n, lpos), dtype=np.uint16) \
        if (with_prefix and keep_unpacked) else None
    fine_packed = np.empty((n, lpos), dtype=np.uint32) if with_packed else None
    if not with_packed and not keep_unpacked:
        keep_unpacked = True
        fine_pos = np.empty((n, lpos), dtype=np.int32)
    if with_packed and not keep_unpacked:
        # native threaded LSD-radix build (csrc/bmtpu_index.cpp):
        # bit-identical to the numpy stable-argsort path below at
        # ~15x its speed (the argsorts dominate the host build)
        from bucketmap_tpu_torch.io import native
        if native.available():
            max_seg = native.build_fine(
                np.ascontiguousarray(index.buckets_packed),
                index.bucket_lengths, k, low_bits, fine_packed, fine_ptab)
            index.fine_pos = None
            index.fine_ptab = fine_ptab
            index.fine_low = None
            index.fine_packed = fine_packed
            index.fine_low_bits = low_bits
            index.fine_search_steps = int(max(1, max_seg)).bit_length()
            return
    max_seg = 1
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        codes = unpack_2bit(index.buckets_packed[s:e], lb)
        hashes = kmer_hashes(codes, k)                    # (rows, lpos)
        # invalidate positions beyond each bucket's true length; the
        # sentinel sorts last so -1 pads the tail
        posv = np.arange(lpos, dtype=np.int32)
        invalid = posv[None, :] > (index.bucket_lengths[s:e, None] - k)
        hashes = np.where(invalid, np.uint32(0xFFFFFFFF), hashes)
        order = np.argsort(hashes, axis=1, kind="stable").astype(np.int32)
        sorted_invalid = np.take_along_axis(invalid, order, axis=1)
        if fine_pos is not None:
            fine_pos[s:e] = np.where(sorted_invalid, -1, order)
        if with_prefix:
            sh = np.take_along_axis(hashes, order, axis=1)
            prefix = (sh >> np.uint32(low_bits)).astype(np.int32)
            prefix = np.where(sorted_invalid, 4096, prefix)
            low = sh & np.uint32((1 << low_bits) - 1)
            if fine_low is not None:
                fine_low[s:e] = np.where(sorted_invalid, np.uint16(0xFFFF),
                                         low.astype(np.uint16))
            if with_packed:
                fine_packed[s:e] = np.where(
                    sorted_invalid, np.uint32(0xFFFFFFFF),
                    (order.astype(np.uint32) << np.uint32(low_bits)) | low)
            # segment starts: ptab[p] = count of prefixes < p, from one
            # flattened bincount (prefixes are bounded by the 4096
            # invalid sentinel, so 4097 bins per row)
            rows_n = e - s
            flat = (np.arange(rows_n, dtype=np.int64)[:, None] * 4097
                    + prefix.astype(np.int64)).ravel()
            counts = np.bincount(flat, minlength=rows_n * 4097) \
                .reshape(rows_n, 4097)
            ptab = np.zeros((rows_n, 4097), dtype=np.int32)
            ptab[:, 1:] = np.cumsum(counts[:, :4096], axis=1)
            fine_ptab[s:e] = ptab
            max_seg = max(max_seg, int(counts[:, :4096].max()))
    index.fine_pos = fine_pos
    index.fine_ptab = fine_ptab
    index.fine_low = fine_low
    index.fine_packed = fine_packed
    index.fine_low_bits = low_bits if with_packed else 0
    # lower_bound over a segment of length max_seg: gap max_seg -> 0 takes
    # bit_length(max_seg) halvings (max_seg-1 would be one short whenever
    # max_seg is a power of two)
    index.fine_search_steps = int(max(1, max_seg)).bit_length() \
        if with_prefix else 0


def build_index(records: list[FastaRecord], cfg: MapperConfig,
                verbose: bool = False) -> BucketIndex:
    cfg.validate()
    q = cfg.index_seed
    kmer_to_row = frac_min_hash_table(cfg)
    g_rows = int(kmer_to_row.max()) + 1 if (kmer_to_row >= 0).any() else 0

    # ---- pass 1: bucket metadata -------------------------------------------
    bucket_names: list[str] = []
    bucket_lengths: list[int] = []
    for rec_id, _start, codes in iterate_buckets(records, cfg):
        bucket_names.append(rec_id)
        bucket_lengths.append(len(codes))
    n = len(bucket_names)
    if n == 0:
        raise ValueError("no buckets produced (genome shorter than read_len?)")
    w = (n + 31) // 32

    ref_names: list[str] = []
    bucket_ref = np.zeros(n, dtype=np.int32)
    bucket_ordinal = np.zeros(n, dtype=np.int32)
    last = None
    ordinal = 0
    for i, name in enumerate(bucket_names):
        if name != last:
            ref_names.append(name)
            last = name
            ordinal = 0
        bucket_ref[i] = len(ref_names) - 1
        bucket_ordinal[i] = ordinal
        ordinal += 1

    # ---- pass 2: occupancy matrix + packed sequences -----------------------
    qgram_words = np.zeros((g_rows + 1, w), dtype=np.uint32)
    wb = (max(bucket_lengths) + 15) // 16
    buckets_packed = np.zeros((n, wb), dtype=np.uint32)

    # per-record q-gram hashes and packing computed once, sliced per bucket.
    # The native builder (csrc/bmtpu_index.cpp) does the same walk as a
    # threaded rolling-hash scatter at ~6 ns/base; the numpy path below is
    # the bit-identical fallback/oracle (tests/test_index_and_sim.py).
    from bucketmap_tpu_torch.io import native
    use_native = native.available()
    b = 0
    for rec_idx, rec in enumerate(records):
        if use_native:
            emitted = native.build_occupancy(
                rec.codes, len(rec.codes), q, cfg.bucket_len, cfg.read_len,
                kmer_to_row, qgram_words, b, buckets_packed)
            b += emitted
            if verbose:
                print(f"[index] record {rec_idx} "
                      f"({rec.id.split()[0] if rec.id else ''}): "
                      f"{len(rec.codes)} bp -> buckets so far: {b}")
            continue
        hashes = None
        rec_packed = None
        total = len(rec.codes)
        n_b = int(np.ceil(total / cfg.bucket_len)) if total else 0
        for i in range(n_b):
            start = i * cfg.bucket_len
            end = min(start + cfg.bucket_len + cfg.read_len, total)
            if end - start <= cfg.read_len:
                continue
            if hashes is None:
                hashes = kmer_hashes(rec.codes, q) if total >= q else np.zeros(0, np.uint32)
                rec_packed = pack_2bit(rec.codes)
            rows = kmer_to_row[hashes[start : end - q + 1]]
            rows = rows[rows >= 0]
            # duplicate rows are fine: |= scatters the same bit once
            qgram_words[rows, b >> 5] |= np.uint32(1 << (b & 31))
            # bucket starts are 16-aligned (bucket_len % 16 == 0), so the
            # bucket's words are a slice of the record's packing — except
            # the record-tail word, which may contain bases past `end`;
            # repack the final word from codes to keep padding zeroed.
            w0 = start // 16
            w1 = (end + 15) // 16
            buckets_packed[b, : w1 - w0] = rec_packed[w0:w1]
            tail_base = (w1 - 1) * 16
            if end - tail_base < 16:
                buckets_packed[b, w1 - w0 - 1] = pack_2bit(
                    rec.codes[tail_base:end])[0]
            b += 1
        if verbose:
            print(f"[index] record {rec_idx} ({rec.id.split()[0] if rec.id else ''}): "
                  f"{total} bp -> buckets so far: {b}")
    assert b == n

    # all-ones sentinel row (stands in for unsampled q-grams in the AND chain)
    qgram_words[g_rows, :] = np.uint32(0xFFFFFFFF)

    # distinguishability support: zeros[g] = N - popcount(row)
    # (q_gram_mapper.h:171-187)
    pop = np.bitwise_count(qgram_words[:g_rows]).sum(axis=1).astype(np.int64)
    zeros = np.concatenate([(n - pop).astype(np.int32), np.array([-1], np.int32)])

    return BucketIndex(
        config=cfg, ref_names=ref_names, bucket_names=bucket_names,
        bucket_ref=bucket_ref, bucket_ordinal=bucket_ordinal,
        bucket_lengths=np.asarray(bucket_lengths, dtype=np.int32),
        kmer_to_row=kmer_to_row, qgram_words=qgram_words, zeros=zeros,
        buckets_packed=buckets_packed,
    )


def build_index_from_fasta(path: str | os.PathLike, cfg: MapperConfig,
                           verbose: bool = False) -> BucketIndex:
    return build_index(read_fasta(path), cfg, verbose=verbose)


# ---- on-disk artifact -------------------------------------------------------

def save_index(index: BucketIndex, directory: str | os.PathLike, indicator: str,
               overwrite: bool = False) -> None:
    """Native artifact: one .npz + json meta. This is the 'checkpoint' the
    reference keeps as .qgram/.bucket_id/.kmers_index (§5 of SURVEY).

    Refuses to clobber an existing artifact unless overwrite=True — the
    reference's check_extension_in/check_filename_in guard semantics
    (utils.h:104-144: an existing index file aborts the write so a
    previously built index is never silently destroyed)."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, indicator)
    if not overwrite and os.path.exists(base + ".bmtpu.json"):
        raise FileExistsError(
            f"index artifact already exists: {base}.bmtpu.json "
            "(pass overwrite=True to replace it; utils.h:104-144 semantics)")
    arrays = dict(
        bucket_ref=index.bucket_ref, bucket_ordinal=index.bucket_ordinal,
        bucket_lengths=index.bucket_lengths, kmer_to_row=index.kmer_to_row,
        qgram_words=index.qgram_words, zeros=index.zeros,
        buckets_packed=index.buckets_packed,
    )
    if index.fine_pos is not None:
        arrays["fine_pos"] = index.fine_pos
    if index.fine_ptab is not None:
        arrays["fine_ptab"] = index.fine_ptab
        if index.fine_low is not None:
            arrays["fine_low"] = index.fine_low
    if index.fine_packed is not None:
        arrays["fine_packed"] = index.fine_packed
    # one .npy per array: mmap-able on load (a multi-GB npz cannot be)
    for name, arr in arrays.items():
        np.save(f"{base}.bmtpu.{name}.npy", arr)
    meta = {
        "config": dataclasses.asdict(index.config),
        "ref_names": index.ref_names,
        "bucket_names": index.bucket_names,
        "fine_search_steps": index.fine_search_steps,
        "fine_low_bits": index.fine_low_bits,
        "version": 2,
    }
    with open(base + ".bmtpu.json", "w") as f:
        json.dump(meta, f)


def load_index(directory: str | os.PathLike, indicator: str) -> BucketIndex:
    base = os.path.join(directory, indicator)
    with open(base + ".bmtpu.json") as f:
        meta = json.load(f)
    if os.path.exists(base + ".bmtpu.qgram_words.npy"):
        def arr(name, optional=False):
            path = f"{base}.bmtpu.{name}.npy"
            if optional and not os.path.exists(path):
                return None
            return np.load(path, mmap_mode="r")
    else:  # legacy single-npz artifact
        arrs = np.load(base + ".bmtpu.npz")
        def arr(name, optional=False):
            return arrs[name] if (not optional or name in arrs) else None
    return BucketIndex(
        config=MapperConfig(**meta["config"]),
        ref_names=meta["ref_names"], bucket_names=meta["bucket_names"],
        bucket_ref=np.asarray(arr("bucket_ref")),
        bucket_ordinal=np.asarray(arr("bucket_ordinal")),
        bucket_lengths=np.asarray(arr("bucket_lengths")),
        kmer_to_row=np.asarray(arr("kmer_to_row")),
        qgram_words=arr("qgram_words"), zeros=np.asarray(arr("zeros")),
        buckets_packed=arr("buckets_packed"),
        fine_pos=arr("fine_pos", optional=True),
        fine_ptab=arr("fine_ptab", optional=True),
        fine_low=arr("fine_low", optional=True),
        fine_packed=arr("fine_packed", optional=True),
        fine_low_bits=int(meta.get("fine_low_bits", 0)),
        fine_search_steps=int(meta.get("fine_search_steps", 0)),
    )


def index_from_arrays(config_fields: dict, arrays: dict) -> BucketIndex:
    """A BucketIndex from another package's index held in memory: the
    MapperConfig's fields by name, and every other BucketIndex field by
    name (the numpy tables, the two name lists and the two fine-index
    integers; the optional fine tables may be left out). The arrays are
    shared, not copied. Raises on a missing or unknown name."""
    fields = {f.name for f in dataclasses.fields(BucketIndex)} - {"config"}
    optional = {f.name for f in dataclasses.fields(BucketIndex)
                if f.default is not dataclasses.MISSING}
    unknown = set(arrays) - fields
    missing = fields - optional - set(arrays)
    if unknown or missing:
        raise ValueError(f"index_from_arrays: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    kw = dict(arrays)
    kw["ref_names"] = list(kw["ref_names"])
    kw["bucket_names"] = list(kw["bucket_names"])
    for name in ("fine_search_steps", "fine_low_bits"):
        if name in kw:
            kw[name] = int(kw[name])
    return BucketIndex(config=MapperConfig(**config_fields), **kw)


# ---- reference-format interop (.qgram / .bucket_id / .kmers_index) ----------

def export_reference_format(index: BucketIndex, directory: str | os.PathLike,
                            indicator: str, overwrite: bool = False) -> None:
    """Write the reference's exact on-disk index formats
    (bucket_indexer.h:76-127): .qgram = (N+7)/8 packed bytes per sampled
    q-gram row (bit j of byte j>>3 at j&7 — identical to our
    little-endian uint32 words); .bucket_id = one full record id per
    bucket; .kmers_index = 4^q newline-separated ints.

    Like the reference (utils.h:104-144 via bucket_indexer.h:178-186),
    refuses to overwrite existing .qgram/.bucket_id/.kmers_index files."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, indicator)
    if not overwrite:
        for ext in (".qgram", ".bucket_id", ".kmers_index"):
            if os.path.exists(base + ext):
                raise FileExistsError(
                    f"index file already exists: {base + ext} "
                    "(utils.h:104-144 refuses to overwrite)")
    n = index.n_buckets
    row_bytes = (n + 7) // 8
    with open(base + ".qgram", "wb") as f:
        rows = index.qgram_words[:-1]  # drop sentinel
        byte_view = rows.astype("<u4").tobytes()
        per_row = index.words_per_row * 4
        for i in range(rows.shape[0]):
            f.write(byte_view[i * per_row : i * per_row + row_bytes])
    with open(base + ".bucket_id", "w") as f:
        for name in index.bucket_names:
            f.write(name + "\n")
    with open(base + ".kmers_index", "w") as f:
        for v in index.kmer_to_row:
            f.write(f"{int(v)}\n")


def import_reference_format(directory: str | os.PathLike, indicator: str,
                            cfg: MapperConfig,
                            fasta_path: str | os.PathLike | None = None) -> BucketIndex:
    """Load a reference-built index. The packed bucket sequences are not
    part of the reference artifact (it reloads the FASTA at locate time,
    bucket_locator.h:151-160), so a fasta_path is needed for the fine
    stage; pass None for coarse-only use."""
    base = os.path.join(directory, indicator)
    with open(base + ".kmers_index") as f:
        kmer_to_row = np.array([int(line) for line in f], dtype=np.int32)
    if len(kmer_to_row) != cfg.num_qgrams:
        raise ValueError("kmers_index length does not match 4^index_seed")
    with open(base + ".bucket_id") as f:
        bucket_names = [line.rstrip("\n") for line in f]
    n = len(bucket_names)
    w = (n + 31) // 32
    row_bytes = (n + 7) // 8
    g_rows = int(kmer_to_row.max()) + 1
    raw = np.fromfile(base + ".qgram", dtype=np.uint8)
    if len(raw) != g_rows * row_bytes:
        raise ValueError(".qgram size mismatch")
    rows = raw.reshape(g_rows, row_bytes)
    padded = np.zeros((g_rows + 1, w * 4), dtype=np.uint8)
    padded[:g_rows, :row_bytes] = rows
    qgram_words = padded.view("<u4").reshape(g_rows + 1, w).copy()
    qgram_words[g_rows] = np.uint32(0xFFFFFFFF)

    pop = np.bitwise_count(qgram_words[:g_rows]).sum(axis=1).astype(np.int64)
    zeros = np.concatenate([(n - pop).astype(np.int32), np.array([-1], np.int32)])

    ref_names, bucket_ref, bucket_ordinal = [], np.zeros(n, np.int32), np.zeros(n, np.int32)
    last, ordinal = None, 0
    for i, name in enumerate(bucket_names):
        if name != last:
            ref_names.append(name)
            last, ordinal = name, 0
        bucket_ref[i] = len(ref_names) - 1
        bucket_ordinal[i] = ordinal
        ordinal += 1

    if fasta_path is not None:
        records = read_fasta(fasta_path)
        lengths, packs = [], []
        for _rid, _start, codes in iterate_buckets(records, cfg):
            lengths.append(len(codes))
            packs.append(pack_2bit(codes))
        wb = (max(lengths) + 15) // 16
        buckets_packed = np.zeros((n, wb), dtype=np.uint32)
        for i, p in enumerate(packs):
            buckets_packed[i, : len(p)] = p
        bucket_lengths = np.asarray(lengths, dtype=np.int32)
    else:
        buckets_packed = np.zeros((n, 1), dtype=np.uint32)
        bucket_lengths = np.full(n, cfg.bucket_len + cfg.read_len, dtype=np.int32)

    return BucketIndex(
        config=cfg, ref_names=ref_names, bucket_names=bucket_names,
        bucket_ref=bucket_ref, bucket_ordinal=bucket_ordinal,
        bucket_lengths=bucket_lengths, kmer_to_row=kmer_to_row,
        qgram_words=qgram_words, zeros=zeros, buckets_packed=buckets_packed,
    )
