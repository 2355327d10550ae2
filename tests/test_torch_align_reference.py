"""The benchmark's plain reference of aligned records
(`perfbench/references/align.py`) against the port's align mode, record
for record, on the CPU.

A seeded two-record world at the egu1700-align configuration's mapper settings (65,536-base
buckets, 300 bp reads, quality threshold 40): reads cut from it by hand
are mapped by `BucketMapPipeline(align=True)` in two chunks, the first
of 300-base reads (Q = 300) and the second with a 450-base read in it
(Q = 450), and each read's SAM records must equal the reference's for
that chunk's width. The cases: a forward read with an insertion, a
reverse-strand read with a deletion, a read near a packed bucket's end
whose window the wider chunk shifts (its POS differs between the
chunks), a read whose window the wider chunk shifts out of the band
(score under -60: MAPQ wrapped, CIGAR '*'), a read dropped under the
quality threshold, and the whole FASTQ again with the aligner's run
budget cut to nothing, so that every sub-batch takes the packed-ops
re-run, against the reference on that path (whose windows are Q + band
bases, not 16 * ceil(Q / 16) + band: the shifted reads' records move).
One CIGAR op altered in the program's output fails the comparison. The
world is the port's and the benchmark's own: no JAX is needed here."""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index.builder import build_index
from bucketmap_tpu_torch.io.fasta import FastaRecord
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFBENCH = os.path.join(REPO, "perfbench")
if PERFBENCH not in sys.path:
    sys.path.append(PERFBENCH)

from core import genome as G                           # noqa: E402
from core.reference import Params, ReferenceIndex      # noqa: E402

QUALITY = ord("E")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _load(name):
    path = os.path.join(PERFBENCH, "references", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_ref_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


align_ref = _load("align")


@dataclasses.dataclass
class Chunk:
    chunk_width: int


def revcomp(codes):
    return (3 - codes)[::-1].copy()


def make_reads(recs):
    """(name, codes, chunk) of the hand-cut reads: chunk 0 holds reads
    of 300 bases, chunk 1 the same near-end reads beside a 450-base
    one."""
    r0, r1 = recs[0][1], recs[1][1]
    rng = np.random.RandomState(7)
    fwd = r0[20_000:20_299].copy()
    fwd = np.concatenate([fwd[:150], [(fwd[150] + 1) % 4], fwd[150:]])
    fwd[[40, 210]] = (fwd[[40, 210]] + 2) % 4                 # 1I, 2 X
    rev = revcomp(np.delete(r1[40_000:40_301], 120))           # 1D
    near_pos = r0[65_330:65_630].copy()        # shifted 18 at Q = 450
    near_wrap = r0[65_380:65_680].copy()       # shifted 68: out of band
    low = r1[90_000:90_300].copy()
    low[240::2] = (low[240::2] + rng.randint(1, 4, 30)) % 4    # 30 X
    long_read = r0[100_000:100_450].copy()
    first = [("fwd", fwd), ("rev", rev), ("near_pos_a", near_pos),
             ("near_wrap_a", near_wrap), ("low", low)]
    first += [(f"fill{i}", r0[i * 9_000 + 3_000:i * 9_000 + 3_300].copy())
              for i in range(3)]
    second = [("long", long_read), ("near_pos_b", near_pos),
              ("near_wrap_b", near_wrap)]
    return ([(n, c, 0) for n, c in first] + [(n, c, 1) for n, c in second],
            len(first))


def write_fastq(path, reads):
    with open(path, "wb") as f:
        for name, codes, _ in reads:
            f.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), ACGT[codes].tobytes(),
                                            bytes([QUALITY]) * len(codes)))


def sam_by_read(path):
    out = {}
    for line in open(path, "rb").read().split(b"\n"):
        if line and not line.startswith(b"@"):
            out.setdefault(line.split(b"\t")[0], []).append(line)
    return {k: sorted(v) for k, v in out.items()}


def expected(ref, reads, widths, rerun=None):
    if rerun is None:
        return {name.encode(): ref.records(codes, QUALITY, name.encode(),
                                           Chunk(widths[chunk]))
                for name, codes, chunk in reads}
    return {name.encode(): ref.aligned(codes, QUALITY, name.encode(),
                                       widths[chunk], rerun)
            for name, codes, chunk in reads}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with open(os.path.join(PERFBENCH, "configs", "egu1700-align.json")) as f:
        mapper = json.load(f)["mapper"]
    recs = G.repeat_genome(300_000, seed=5, n_refs=2)
    genome = G.Genome([n for n, _ in recs], [len(c) for _, c in recs],
                      [G.pack_2bit(c) for _, c in recs])
    pr = Params(mapper)
    ref = align_ref.Aligned(
        ReferenceIndex(pr, genome, *ReferenceIndex.build_arrays(pr, genome)),
        mapper["quality_threshold"])
    index = build_index([FastaRecord(id=n, codes=c) for n, c in recs],
                        MapperConfig(**mapper))
    reads, per_chunk = make_reads(recs)
    d = tmp_path_factory.mktemp("align_ref")
    fastq = str(d / "reads.fastq")
    write_fastq(fastq, reads)
    widths = {0: 300, 1: 450}

    def run(tag, run_cap_per_pair=None):
        pipe = BucketMapPipeline(index, device="cpu", align=True,
                                 batch_size=32, pair_batch=8)
        if run_cap_per_pair is not None:
            pipe.aligner.run_cap_per_pair = run_cap_per_pair
        stats = pipe.map_fastq(fastq, str(d / f"{tag}.sam"),
                               reads_per_chunk=per_chunk)
        return (sam_by_read(str(d / f"{tag}.sam")), stats,
                dict(pipe.aligner.counts))

    return {"ref": ref, "reads": reads, "want": expected(ref, reads, widths),
            "want_rerun": expected(ref, reads, widths, rerun=True),
            "runs": run("runs"), "rerun": run("rerun", run_cap_per_pair=0)}


def _fields(rec):
    return rec.split(b"\t")


@pytest.mark.parametrize("case", ["forward", "reverse", "chunk_width",
                                  "wrapped", "below_quality", "ops_rerun"])
def test_reference_equals_the_program(world, case):
    got, stats, counts = world["runs"]
    want = world["want"]
    if case == "ops_rerun":
        got, stats, counts = world["rerun"]
        assert counts["ops_reruns"] == counts["sub_batches"] > 0
        assert got == {k: v for k, v in world["want_rerun"].items() if v}
        moved = {k for k in want if want[k] != world["want_rerun"][k]}
        assert moved == {b"near_pos_b", b"near_wrap_b"}
        return
    assert counts["ops_reruns"] == 0
    names = {"forward": [b"fwd"], "reverse": [b"rev"],
             "chunk_width": [b"near_pos_a", b"near_pos_b"],
             "wrapped": [b"near_wrap_a", b"near_wrap_b"],
             "below_quality": [b"low"]}[case]
    for n in names:
        assert got.get(n, []) == want[n], n
    if case == "forward":
        (rec,) = got[b"fwd"]
        assert _fields(rec)[1] == b"0" and b"I" in _fields(rec)[5]
    elif case == "reverse":
        for rec in got[b"rev"]:
            assert _fields(rec)[1] == b"16" and b"D" in _fields(rec)[5]
    elif case == "chunk_width":
        (a,), (b,) = got[b"near_pos_a"], got[b"near_pos_b"]
        assert _fields(a)[3] != _fields(b)[3]
    elif case == "wrapped":
        (a,), (b,) = got[b"near_wrap_a"], got[b"near_wrap_b"]
        assert _fields(a)[5] == b"300M"
        assert _fields(b)[5] == b"*" and int(_fields(b)[4]) > 60
        assert stats.records_wrapped == 1
    else:
        assert b"low" not in got
        assert stats.records_below_quality >= 1


def test_one_altered_cigar_op_fails(world):
    got, _, _ = world["runs"]
    f = _fields(got[b"fwd"][0])
    f[5] = f[5].replace(b"I", b"D", 1)
    assert [b"\t".join(f)] != world["want"][b"fwd"]
    assert got[b"fwd"] == world["want"][b"fwd"]
