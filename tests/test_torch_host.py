"""The port's own host modules against the JAX package's, exactly
(tolerance 0): config, FASTA/FASTQ parse (native and numpy), SAM bytes,
the host encoding, the sampler, the index builder (native and numpy,
the fine index included), the on-disk artifacts read across packages,
the simulators' files, shard_fastq, the command line's config, and
index_from_arrays. One subprocess imports every module of the port and
chip_smoke.py and finds neither jax nor the JAX package loaded."""

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from bucketmap_tpu import cli as jax_cli
from bucketmap_tpu import config as jax_config
from bucketmap_tpu.index import builder as jax_builder
from bucketmap_tpu.io import fasta as jax_fasta
from bucketmap_tpu.io import fastq as jax_fastq
from bucketmap_tpu.io import sam as jax_sam
from bucketmap_tpu.ops import encoding as jax_enc
from bucketmap_tpu.ops import sampler as jax_sampler
from bucketmap_tpu.parallel import distributed as jax_dist
from bucketmap_tpu.sim import simulator as jax_sim
from bucketmap_tpu_torch import cli
from bucketmap_tpu_torch import config
from bucketmap_tpu_torch.index import builder
from bucketmap_tpu_torch.io import fasta, fastq, native, sam
from bucketmap_tpu_torch.ops import host_encoding, sampler
from bucketmap_tpu_torch.parallel import distributed
from bucketmap_tpu_torch.sim import simulator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(bucket_len=1024, read_len=100, index_seed=5, query_seed=8,
           mapper_samples=6, locator_samples=5, max_candidate_buckets=4)


def port_index(index):
    """The port's BucketIndex holding a JAX package index's tables (the
    arrays are shared), through index_from_arrays."""
    fields = dict(vars(index))
    return builder.index_from_arrays(
        dataclasses.asdict(fields.pop("config")), fields)


def assert_same_index(a, b):
    """Two BucketIndex objects, of either package, field for field."""
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    names = [f.name for f in dataclasses.fields(a) if f.name != "config"]
    assert names == [f.name for f in dataclasses.fields(b)
                     if f.name != "config"]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, name
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def _genome(pkg, length=40_000, n_refs=2, repeats=True):
    make = pkg.repeat_genome if repeats else pkg.random_genome
    return make(length, seed=7, n_refs=n_refs)


# ---- config --------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    {}, CFG, dict(query_seed=15, index_seed=7, kmer_fraction=0.25),
    dict(query_seed=4, index_seed=5), dict(query_seed=17),
    dict(bucket_len=1000)])
def test_config_defaults_derived_and_validate(fields):
    a, b = config.MapperConfig(**fields), jax_config.MapperConfig(**fields)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    derived = [n for n, v in vars(jax_config.MapperConfig).items()
               if isinstance(v, property)]
    assert len(derived) >= 10
    assert [getattr(a, n) for n in derived] == [getattr(b, n) for n in derived]
    errors = []
    for cfg in (a, b):
        try:
            cfg.validate()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (fields in ({}, CFG, dict(
        query_seed=15, index_seed=7, kmer_fraction=0.25)))


def test_cli_flags_give_the_same_config():
    argv = ["-k", "6", "-l", "11", "-r", "150", "-s", "9", "-d", "0.4",
            "-b", "20", "-e", "0.3", "-n", "0.05", "-p", "7", "-u", "30",
            "-f", "0.5", "--bucket-len", "4096"]
    got = []
    for add, make in ((cli._add_param_flags, cli._config_from),
                      (jax_cli._add_param_flags, jax_cli._config_from)):
        for args in (argv, []):
            p = argparse.ArgumentParser()
            add(p)
            got.append(dataclasses.asdict(make(p.parse_args(args))))
    assert got[:2] == got[2:]
    assert got[1] == dataclasses.asdict(config.MapperConfig())


# ---- FASTA, FASTQ, SAM ---------------------------------------------------

def _fastq_bytes(seed, n=60, crlf=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(20, 120))
        seq = "".join(rng.choice(list("ACGTNacgt"), L))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 41, L))
        nl = "\r\n" if crlf and i % 3 == 0 else "\n"
        out.append(f"@read_{i} extra{nl}{seq}\n+\n{qual}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("max_len", [None, 150])
def test_fastq_parse_matches(use_native, max_len, tmp_path):
    """The port's parse (its C++ library, or numpy) against the JAX
    package's numpy parse and the port's own numpy parse. The JAX side
    stays on numpy: its library is built at first use by whichever test
    process finds it missing, so another process can load it half
    written and keep that failure."""
    if use_native:
        assert native.available()
    data = _fastq_bytes(3, crlf=not use_native)
    got = fastq.parse_fastq(data, max_len=max_len, use_native=use_native)
    wants = (jax_fastq.parse_fastq(data, max_len=max_len, use_native=False),
             fastq.parse_fastq(data, max_len=max_len, use_native=False))
    for want in wants:
        for name in ("codes", "quals", "lengths", "seq_ascii", "qual_ascii",
                     "ids_buf", "id_offsets"):
            x, y = getattr(got, name), getattr(want, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert got.ids == want.ids and len(got.ids) == 60
    path = tmp_path / "r.fastq"
    path.write_bytes(data * 3)
    batches = [list(fastq.iter_fastq_batches(path, reads_per_batch=50,
                                             use_native=use_native)),
               list(jax_fastq.iter_fastq_batches(path, reads_per_batch=50,
                                                 use_native=False))]
    assert [b.num_reads for b in batches[0]] == [50, 50, 50, 30]
    for g, w in zip(*batches):
        np.testing.assert_array_equal(g.codes, w.codes)
        assert g.ids == w.ids


# The reader's byte work: the table-driven native parse against the
# reference parse it replaced (the JAX package's csrc/bmtpu_io.cpp, built
# apart), and the record cut against the rule it keeps.

_ARRAYS = ("codes", "quals", "lengths", "seq_ascii", "qual_ascii",
           "ids_buf", "id_offsets")


@pytest.fixture(scope="module")
def reference_parse(tmp_path_factory):
    """parse(data, max_len) -> the arrays of parse_fastq_bytes, through
    the C++ parse of csrc/bmtpu_io.cpp (the per-byte `switch` one),
    built into a test directory; ValueError where its stat or parse
    returns -1."""
    so = tmp_path_factory.mktemp("reference_io") / "libreference_io.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so),
                    os.path.join(REPO, "csrc", "bmtpu_io.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    i64, i64_out = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    u8p = np.ctypeslib.ndpointer(np.uint8)
    lib.bmtpu_fastq_stat.restype = i64
    lib.bmtpu_fastq_stat.argtypes = [ctypes.c_char_p, i64, i64_out, i64_out]
    lib.bmtpu_fastq_parse.restype = i64
    lib.bmtpu_fastq_parse.argtypes = [
        ctypes.c_char_p, i64, i64, u8p, u8p, u8p, u8p,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int64),
        u8p, i64]

    def parse(data: bytes, max_len=None):
        n, ml = ctypes.c_int64(), ctypes.c_int64()
        if lib.bmtpu_fastq_stat(data, len(data), ctypes.byref(n),
                                ctypes.byref(ml)) != 0:
            raise ValueError("malformed FASTQ (reference parser)")
        n = n.value
        L = ml.value if max_len is None else max(max_len, ml.value)
        out = {name: np.zeros((n, L), np.uint8)
               for name in ("codes", "quals", "seq_ascii", "qual_ascii")}
        out["lengths"] = np.zeros(n, np.int32)
        out["id_offsets"] = np.zeros(n + 1, np.int64)
        ids = np.zeros(len(data), np.uint8)
        r = lib.bmtpu_fastq_parse(
            data, len(data), L, out["codes"], out["quals"], out["seq_ascii"],
            out["qual_ascii"], out["lengths"], out["id_offsets"], ids,
            len(ids))
        if r < 0:
            raise ValueError("malformed FASTQ (reference parser, pass 2)")
        out["ids_buf"] = ids[:r]
        return out
    return parse


def _records(rng, n, seq_alphabet, qual_alphabet=range(33, 75),
             lengths=(1, 160), names=None, nl=b"\n"):
    """n FASTQ records whose sequence and quality bytes are drawn from
    the given byte values."""
    seq_alphabet = np.asarray(list(seq_alphabet), np.uint8)
    qual_alphabet = np.asarray(list(qual_alphabet), np.uint8)
    out = []
    for i in range(n):
        L = int(rng.integers(*lengths)) if len(lengths) == 2 else lengths[i]
        seq = rng.choice(seq_alphabet, L).tobytes()
        qual = rng.choice(qual_alphabet, L).tobytes()
        name = b"read_%d x" % i if names is None else names[i % len(names)]
        out.append(b"@" + name + nl + seq + b"\n+\n" + qual + b"\n")
    return b"".join(out)


def _hard_fastq(case: str) -> bytes:
    rng = np.random.default_rng(list(_HARD).index(case) + 40)
    every = [c for c in range(256) if c != ord("\n")]
    if case == "all_byte_values":
        # each byte value but the newline, in order, then drawn
        ordered = bytes(every)
        head = (b"@ordered\n" + ordered + b"\n+\n" + b"I" * len(ordered)
                + b"\n")
        return head + _records(rng, 80, every)
    if case == "lower_case_and_n":
        return _records(rng, 80, b"ACGTNacgtnRYKMSWryk")
    if case == "quality_below_33":
        return _records(rng, 80, b"ACGT", qual_alphabet=every)
    if case == "crlf_and_empty_names":
        names = [b"", b"\r", b"r1\r", b"r 2", b"\r\r", b"@", b"+\r"]
        return (_records(rng, 40, b"ACGTN", names=names)
                + _records(rng, 40, b"ACGT", names=names, nl=b"\r\n"))
    if case == "one_base_and_mixed":
        lengths = [1, 1, 0, 1, 300, 2, 1] + list(rng.integers(1, 400, 73))
        return _records(rng, 80, b"ACGTN", lengths=lengths)
    raise KeyError(case)


_HARD = ("all_byte_values", "lower_case_and_n", "quality_below_33",
         "crlf_and_empty_names", "one_base_and_mixed")


@pytest.mark.parametrize("max_len", [None, 512])
@pytest.mark.parametrize("case", _HARD)
def test_fastq_hard_inputs_parse_as_before(case, max_len, reference_parse):
    """The table-driven native parse on hard inputs: equal, array for
    array, to the reference C++ parse, and to the port's and the JAX
    package's numpy parses; numpy's only difference is a quality byte
    below 33, whose rank the C++ parses clamp to 0 and numpy wraps."""
    assert native.available()
    data = _hard_fastq(case)
    got = fastq.parse_fastq(data, max_len=max_len)
    want = reference_parse(data, max_len)
    for name in _ARRAYS:
        x = getattr(got, name)
        assert x.dtype == want[name].dtype, name
        np.testing.assert_array_equal(x, want[name], err_msg=name)
    q = got.qual_ascii.astype(np.int16)
    np.testing.assert_array_equal(got.quals, np.where(q >= 33, q - 33, 0))
    col = np.arange(got.codes.shape[1])
    low = (q < 33) & (col[None, :] < got.lengths[:, None])
    for other in (fastq.parse_fastq(data, max_len=max_len, use_native=False),
                  jax_fastq.parse_fastq(data, max_len=max_len,
                                        use_native=False)):
        for name in _ARRAYS:
            x, y = getattr(got, name), getattr(other, name)
            if name == "quals":
                x, y = x[~low], y[~low]
            np.testing.assert_array_equal(x, y, err_msg=name)
        np.testing.assert_array_equal(other.quals[low], (q[low] - 33) % 256)
    assert (case == "quality_below_33") == bool(low.any())


_GOOD = b"@r1\nACGT\n+\nIIII\n@r2\nAC\n+\nII\n"


@pytest.mark.parametrize("data,numpy_checks", [
    (b"Xr1\nACGT\n+\nIIII\n", False),            # no '@'
    (b"@r1\nACGT\n-\nIIII\n", False),            # no '+'
    (b"@r0\nACGT\n+\nIII\n" + _GOOD, True),      # quality short
    (_GOOD + b"@r3\nACGT\n+\nIIIII\n", True),    # quality long
    (_GOOD + b"@r3\nACGT\n+\n", True),           # three lines
    (_GOOD + b"@r3\nACGT\n+\nII", True),         # cut in its quality
    (_GOOD + b"@r3", True),                      # cut in its header
    (_GOOD + b"\n", True),                       # a trailing blank line
], ids=["no_at", "no_plus", "short_quality", "long_quality",
        "three_lines", "cut_quality", "cut_header", "blank_line"])
def test_fastq_malformed_records_raise(data, numpy_checks, reference_parse):
    """Malformed records raise ValueError from the native parse, as from
    the reference C++ parse; numpy's parse checks the line count and the
    quality lengths, not the '@' and '+'."""
    with pytest.raises(ValueError):
        reference_parse(data)
    with pytest.raises(ValueError):
        fastq.parse_fastq(data)
    if numpy_checks:
        with pytest.raises(ValueError):
            fastq.parse_fastq(data, use_native=False)


@pytest.mark.parametrize("seed", range(4))
def test_fastq_native_parse_as_before_on_mutated_input(seed,
                                                       reference_parse):
    """Valid records with a few bytes replaced, inserted, deleted or the
    end cut off: the native parse accepts what the reference C++ parse
    accepts, with the same arrays, and raises ValueError where it
    fails."""
    rng = np.random.default_rng(seed)
    base = bytearray(_records(rng, 12, b"ACGTN", lengths=(1, 9)))
    alphabet = np.frombuffer(b"@+\n\rACI", np.uint8)
    outcomes = set()
    for _ in range(300):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            if not data:
                break
            at = int(rng.integers(0, len(data)))
            op = int(rng.integers(0, 4))
            if op == 0:
                data[at] = int(rng.choice(alphabet))
            elif op == 1:
                data.insert(at, int(rng.choice(alphabet)))
            elif op == 2:
                del data[at]
            else:
                del data[at:]
        data = bytes(data)
        try:
            want = reference_parse(data)
        except ValueError:
            with pytest.raises(ValueError):
                fastq.parse_fastq(data)
            outcomes.add("raised")
            continue
        got = fastq.parse_fastq(data)
        for name in _ARRAYS:
            np.testing.assert_array_equal(getattr(got, name), want[name],
                                          err_msg=name)
        outcomes.add("parsed")
    assert outcomes == {"raised", "parsed"}


def _chunks_as_before(data: bytes, reads_per_batch: int,
                      bytes_per_batch: int, block: int) -> list[bytes]:
    """The reader's cut rule, plainly: after each block of the stream,
    cut while the pending bytes hold reads_per_batch records, or reach
    bytes_per_batch and hold a record (then all their whole records
    make the chunk); the last piece is a chunk unless it is blank."""
    target_nl = 4 * reads_per_batch
    pending, chunks = b"", []
    for i in range(0, len(data), block):
        pending += data[i:i + block]
        while (pending.count(b"\n") >= target_nl
               or (len(pending) >= bytes_per_batch
                   and pending.count(b"\n") >= 4)):
            nl = [j for j, c in enumerate(pending) if c == ord("\n")]
            k = min(reads_per_batch, len(nl) // 4)
            cut = nl[4 * k - 1] + 1
            chunks.append(pending[:cut])
            pending = pending[cut:]
    if pending.strip():
        chunks.append(pending)
    return chunks


_CUT_CASES = {
    "one_read": dict(reads=1),
    "three_reads": dict(reads=3),
    "fifty_reads": dict(reads=50),
    "byte_cap": dict(reads=50, cap=1_400, block=700),
    "split_across_blocks": dict(reads=7, block=97),
    "no_final_newline": dict(reads=50, cut_last=True),
    "empty_file": dict(reads=3, empty=True),
    "trailing_blank_line": dict(reads=3, blank=True),
    "trailing_blank_line_in_chunk": dict(reads=50, blank=True),
}


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("case", list(_CUT_CASES))
def test_reader_chunks_follow_the_cut_rule(case, use_native, tmp_path,
                                           monkeypatch):
    """iter_fastq_batches gives the chunks of the cut rule, read block by
    block (READ_BLOCK set small where a case says), each with the arrays
    of parse_fastq on the chunk's bytes; a chunk that does not parse
    raises ValueError where it comes."""
    c = _CUT_CASES[case]
    data = b"" if c.get("empty") else _fastq_bytes(7, n=180, crlf=True)
    if c.get("cut_last"):
        data = data[:-1]
    if c.get("blank"):
        data += b"\n"
    block = c.get("block", fastq.READ_BLOCK)
    monkeypatch.setattr(fastq, "READ_BLOCK", block)
    cap = c.get("cap", 128 << 20)
    path = tmp_path / "r.fastq"
    path.write_bytes(data)
    want = []
    for chunk in _chunks_as_before(data, c["reads"], cap, block):
        try:
            want.append(fastq.parse_fastq(chunk, use_native=use_native))
        except ValueError:
            want.append(None)
            break
    got = []
    try:
        for b in fastq.iter_fastq_batches(path, reads_per_batch=c["reads"],
                                          use_native=use_native,
                                          bytes_per_batch=cap):
            got.append(b)
    except ValueError:
        got.append(None)
    assert len(got) == len(want)
    failed = bool(want) and want[-1] is None
    assert failed == case.startswith("trailing_blank_line_in")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        for name in _ARRAYS:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                          err_msg=name)
    sizes = [b.num_reads for b in got if b is not None]
    assert sum(sizes) == (0 if c.get("empty") else 180) or failed
    if "cap" in c:
        assert max(sizes) < c["reads"]


@pytest.mark.parametrize("library", [True, False], ids=["native", "numpy"])
def test_reader_counts_native_parses(library, tmp_path, monkeypatch):
    """The reader counts each chunk in MapStats.parse_chunks, and in
    parse_native_chunks those the host library parsed: all of them with
    the library, none where it does not load."""
    from bucketmap_tpu_torch.mapper.pipeline import MapStats
    if not library:
        monkeypatch.setattr(native, "_load", lambda: None)
    path = tmp_path / "r.fastq"
    path.write_bytes(_fastq_bytes(3) * 3)
    stats = MapStats()
    got = list(fastq.iter_fastq_batches(path, reads_per_batch=50,
                                        stats=stats))
    assert [b.num_reads for b in got] == [50, 50, 50, 30]
    assert stats.parse_chunks == 4
    assert stats.parse_native_chunks == (4 if library else 0)


def test_read_batch_from_arrays_and_head():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (8, 30)).astype(np.uint8)
    quals = rng.integers(0, 41, (8, 30)).astype(np.uint8)
    lengths = rng.integers(10, 31, 8).astype(np.int32)
    ids = [f"r{i}" for i in range(8)]
    got = fastq.ReadBatch.from_arrays(ids, codes, quals, lengths).head(5)
    want = jax_fastq.ReadBatch.from_arrays(ids, codes, quals, lengths).head(5)
    for name in ("seq_ascii", "qual_ascii", "lengths", "id_offsets"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.ids == want.ids == ids[:5]


def test_fasta_read_and_write(tmp_path):
    rng = np.random.default_rng(5)
    recs = [(f"chr{i} desc", "".join(rng.choice(list("ACGTN"), 500 + i))
             .encode()) for i in range(3)]
    fasta.write_fasta(tmp_path / "a.fa", recs, width=70)
    jax_fasta.write_fasta(tmp_path / "b.fa", recs, width=70)
    assert (tmp_path / "a.fa").read_bytes() == (tmp_path / "b.fa").read_bytes()
    (tmp_path / "c.fa").write_bytes(
        (tmp_path / "a.fa").read_bytes().replace(b"\n", b"\r\n"))
    for name in ("a.fa", "c.fa"):
        got = fasta.read_fasta(tmp_path / name)
        want = jax_fasta.read_fasta(tmp_path / name)
        assert [r.id for r in got] == [r.id for r in want] == \
            [r[0] for r in recs]
        for g, w in zip(got, want):
            assert g.codes.dtype == w.codes.dtype
            np.testing.assert_array_equal(g.codes, w.codes)


def test_sam_writer_bytes(tmp_path):
    names, lengths = ["chrA desc", "chrB"], [4096, 8192]
    for pkg, out in ((sam, "a.sam"), (jax_sam, "b.sam")):
        with pkg.SamWriter(tmp_path / out, names, lengths) as w:
            w.write("r1", 0, "chrA desc", 0, 60, "ACGT", "IIII")
            w.write("r2", 16, "chrB", 4000, 255, "AC", "##", cigar="2M")
    assert (tmp_path / "a.sam").read_bytes() == (tmp_path / "b.sam").read_bytes()
    assert list(sam.read_sam(tmp_path / "a.sam")) == \
        list(jax_sam.read_sam(tmp_path / "b.sam"))


# ---- host encoding and sampler ------------------------------------------

@pytest.mark.parametrize("k", [5, 8, 12, 16])
def test_host_encoding_matches(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (6, 150)).astype(np.uint8)
    quals = rng.integers(0, 41, (6, 150)).astype(np.uint8)
    lengths = rng.integers(k, 151, 6).astype(np.int32)
    ascii_ = bytes(rng.choice(list(b"ACGTNacgtn"), 300))
    pairs = [
        (host_encoding.encode_ascii(ascii_), jax_enc.encode_ascii(ascii_)),
        (host_encoding._ASCII_TO_CODE, jax_enc._ASCII_TO_CODE),
        (host_encoding.pack_2bit(codes), jax_enc.pack_2bit(codes)),
        (host_encoding.unpack_2bit(jax_enc.pack_2bit(codes), 150),
         jax_enc.unpack_2bit(jax_enc.pack_2bit(codes), 150)),
        (host_encoding.kmer_hashes(codes, k), jax_enc.kmer_hashes(codes, k)),
        (host_encoding.revcomp_codes(codes), jax_enc.revcomp_codes(codes)),
        (host_encoding.window_quality_sums(quals, k),
         jax_enc.window_quality_sums(quals, k)),
        (host_encoding.pack_reads(codes, quals, lengths, k, 25 * k),
         jax_enc.pack_reads(codes, quals, lengths, k, 25 * k)),
        (host_encoding.read_pack_words(150, k), jax_enc.read_pack_words(150, k)),
    ]
    for i, (g, w) in enumerate(pairs):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, i
        np.testing.assert_array_equal(g, w, err_msg=str(i))
    assert host_encoding.decode_to_ascii(codes[0]) == \
        jax_enc.decode_to_ascii(codes[0])
    packed = host_encoding.pack_reads(codes, quals, lengths, k, 25 * k)
    np.testing.assert_array_equal(native.pack_reads(codes, quals, lengths, k,
                                                    25 * k), packed)


@pytest.mark.parametrize("n", [1, 5, 10, 15])
def test_sampler_tables_match(n):
    for ub in (0, 1, 7, 99, 300):
        np.testing.assert_array_equal(sampler.sample_deterministic(n, ub),
                                      jax_sampler.sample_deterministic(n, ub))
    got, want = sampler.sample_table(n, 300), jax_sampler.sample_table(n, 300)
    assert got.dtype == want.dtype and got.shape == (301, n)
    np.testing.assert_array_equal(got, want)


# ---- index builder and artifacts ----------------------------------------

@pytest.fixture(scope="module")
def tiny_indexes():
    """The tiny world's index built by each package's native build, the
    fine index (unpacked tables kept) attached."""
    out = []
    for pkg, bld, cfg_mod in ((simulator, builder, config),
                              (jax_sim, jax_builder, jax_config)):
        index = bld.build_index(_genome(pkg), cfg_mod.MapperConfig(**CFG))
        bld.build_fine_index(index, keep_unpacked=True)
        out.append(index)
    return out


def test_tiny_world_index_field_by_field(tiny_indexes):
    got, want = tiny_indexes
    assert got.fine_packed is not None and got.fine_pos is not None
    assert_same_index(got, want)
    assert got.n_buckets == want.n_buckets and got.n_buckets > 30
    np.testing.assert_array_equal(got.ref_offset_of_bucket(),
                                  want.ref_offset_of_bucket())
    assert got.sam_ref_lengths() == want.sam_ref_lengths()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("fields,keep", [
    (CFG, None), (dict(CFG, query_seed=12, kmer_fraction=0.5), None),
    (dict(CFG, query_seed=15, index_seed=7), None), (CFG, False)])
def test_index_builds_match(use_native, fields, keep, monkeypatch):
    """build_index + build_fine_index, the native host library and the
    numpy path of each package (the port's numpy path with its library
    unavailable, the JAX package's with BMTPU_HOST_BUILD_NATIVE=0)."""
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setenv("BMTPU_HOST_BUILD_NATIVE", "0")
    got = builder.build_index(_genome(simulator, 30_000, 3, False),
                              config.MapperConfig(**fields))
    want = jax_builder.build_index(_genome(jax_sim, 30_000, 3, False),
                                   jax_config.MapperConfig(**fields))
    builder.build_fine_index(got, keep_unpacked=keep)
    jax_builder.build_fine_index(want, keep_unpacked=keep)
    assert_same_index(got, want)
    assert (got.fine_packed is None) == (fields["query_seed"] == 15)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_index_is_read_by_the_other_package(tiny_indexes, writer,
                                                  tmp_path):
    got, want = tiny_indexes
    save, load = ((builder.save_index, jax_builder.load_index)
                  if writer == "port" else
                  (jax_builder.save_index, builder.load_index))
    save(got if writer == "port" else want, tmp_path, "idx")
    with pytest.raises(FileExistsError):
        save(got if writer == "port" else want, tmp_path, "idx")
    assert_same_index(load(tmp_path, "idx"), want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_reference_format_read_by_the_other_package(writer, tmp_path):
    cfg_fields = dict(CFG, index_seed=4)
    jax_index = jax_builder.build_index(_genome(jax_sim),
                                        jax_config.MapperConfig(**cfg_fields))
    recs = [(r.id, jax_enc.decode_to_ascii(r.codes))
            for r in _genome(jax_sim)]
    jax_fasta.write_fasta(tmp_path / "g.fa", recs)
    if writer == "port":
        builder.export_reference_format(port_index(jax_index), tmp_path, "ri")
        back = jax_builder.import_reference_format(
            tmp_path, "ri", jax_config.MapperConfig(**cfg_fields),
            tmp_path / "g.fa")
    else:
        jax_builder.export_reference_format(jax_index, tmp_path, "ri")
        back = builder.import_reference_format(
            tmp_path, "ri", config.MapperConfig(**cfg_fields),
            tmp_path / "g.fa")
    assert_same_index(back, jax_index)


def test_index_from_arrays(tiny_indexes):
    got, want = tiny_indexes
    carried = port_index(want)
    assert type(carried) is builder.BucketIndex
    assert type(carried.config) is config.MapperConfig
    assert_same_index(carried, want)
    assert carried.qgram_words is want.qgram_words       # shared, not copied
    fields = dict(vars(want))
    cfg = dataclasses.asdict(fields.pop("config"))
    for name in ("fine_pos", "fine_ptab", "fine_low", "fine_packed",
                 "fine_search_steps", "fine_low_bits"):
        fields.pop(name)
    bare = builder.index_from_arrays(cfg, fields)
    assert bare.fine_packed is None and bare.fine_search_steps == 0
    with pytest.raises(ValueError, match="missing.*zeros"):
        builder.index_from_arrays(
            cfg, {k: v for k, v in fields.items() if k != "zeros"})
    with pytest.raises(ValueError, match="unknown.*extra"):
        builder.index_from_arrays(cfg, dict(fields, extra=1))


# ---- simulators and shards ----------------------------------------------

@pytest.mark.parametrize("vectorized,errors", [
    (False, True), (True, True), (False, False)])
def test_simulator_files_byte_for_byte(vectorized, errors, tmp_path):
    files = []
    for pkg, cfg_mod in ((simulator, config), (jax_sim, jax_config)):
        sim = pkg.ShortReadSimulator(cfg_mod.MapperConfig(**CFG),
                                     substitution_rate=0.01,
                                     insertion_rate=0.002,
                                     deletion_rate=0.002, seed=9)
        sim.read(_genome(pkg))
        out = tmp_path / pkg.__name__.split(".")[0]
        paths = sim.generate(out, "sim", 400, simulate_error=errors,
                             vectorized=vectorized)
        files.append({k: open(v, "rb").read() for k, v in paths.items()})
    assert files[0] == files[1]
    assert files[0]["fastq"].count(b"\n") == 1600


def test_genomes_and_long_reads_match(tmp_path):
    for repeats in (False, True):
        got, want = (_genome(simulator, 60_000, 2, repeats),
                     _genome(jax_sim, 60_000, 2, repeats))
        assert [r.id for r in got] == [r.id for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)
    files = []
    for pkg in (simulator, jax_sim):
        sim = pkg.LongReadSimulator(_genome(pkg, 60_000, 2), mean_len=2000,
                                    sd_len=500, min_len=800, seed=4)
        paths = sim.generate(tmp_path / pkg.__name__.split(".")[0], "ont", 20)
        files.append({k: open(v, "rb").read() for k, v in paths.items()})
    assert files[0] == files[1]


@pytest.mark.parametrize("num_shards,shard_id", [(1, 0), (3, 0), (3, 2)])
def test_shard_fastq_matches(num_shards, shard_id, tmp_path):
    src = tmp_path / "all.fastq"
    src.write_bytes(_fastq_bytes(8, n=25))
    (tmp_path / "port").mkdir()
    got = distributed.shard_fastq(src, tmp_path / "port", num_shards, shard_id)
    want = jax_dist.shard_fastq(src, tmp_path, num_shards, shard_id)
    assert os.path.basename(got) == os.path.basename(want)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert open(got, "rb").read().count(b"\n") == \
        4 * len(range(shard_id, 25, num_shards))


# ---- the port stands alone ----------------------------------------------

def test_port_imports_nothing_of_the_jax_package():
    code = """
import importlib, pkgutil, sys
import bucketmap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bucketmap_tpu_torch.__path__,
                                                "bucketmap_tpu_torch.")]
for name in names + ["chip_smoke", "bench_torch", "kernel_ab"]:
    importlib.import_module(name)
roots = ("jax", "flax", "optax", "bucketmap_tpu", "research")
bad = sorted(m for m in sys.modules if m.split(".")[0] in roots)
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 33


def test_importing_the_profilers_runs_nothing(tmp_path):
    """Each experiments.profile_* module (and the root scripts) only
    defines at import: no file written in the working directory, nothing
    printed, CUDA not initialised, no kernel launched."""
    code = """
import importlib, os, pkgutil, sys
import torch
import bucketmap_tpu_torch.experiments as ex
names = [m.name for m in pkgutil.iter_modules(ex.__path__)
         if m.name.startswith("profile_")]
for name in names:
    importlib.import_module("bucketmap_tpu_torch.experiments." + name)
import bench_torch, kernel_ab
from bucketmap_tpu_torch import kernels
assert not torch.cuda.is_initialized()
assert not any(kernels.LAUNCHES.values())
assert os.listdir(".") == [], os.listdir(".")
sys.stderr.write(" ".join(names))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == ""
    assert res.stderr.split() == sorted(
        f"profile_{n}" for n in ("align", "coarse", "coarse_sub", "driver",
                                 "finewin", "grch38_warmup", "mesh",
                                 "pipeline", "select", "step"))
