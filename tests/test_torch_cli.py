"""The port's command line and analyzers against the JAX package's, on
one world (tests/test_cli_and_analyzers.py's genome and flags): `index`
writes the same files, `simulate` the same reads and truth, `map
--device cpu` on the JAX-written index the JAX CLI's SAM byte for byte,
the analyzers the same reports line for line, and `index` refuses an
existing artifact in both. The JAX package's C++ host library is never
loaded here (its numpy paths give the same bytes): its first use runs
`make` in place, which a parallel worker could load half written."""

import dataclasses
import os
import shutil

import pytest

from bucketmap_tpu import cli as jax_cli
from bucketmap_tpu.bench import sam_analyzer as jax_sam_analyzer
from bucketmap_tpu.io import native as jax_native
from bucketmap_tpu_torch import cli
from bucketmap_tpu_torch.bench import sam_analyzer
from bucketmap_tpu_torch.io.fasta import write_fasta
from bucketmap_tpu_torch.ops.host_encoding import decode_to_ascii
from bucketmap_tpu_torch.sim.simulator import random_genome

ARGS = ["--bucket-len", "4096", "-r", "150", "-k", "8", "-l", "11", "-s", "8"]
REF_FILES = (".qgram", ".bucket_id", ".kmers_index")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(dir, fasta): `index --export-reference-format` and `simulate` run by
    each CLI into dir/jax and dir/port; dir/ref holds the reference-format
    files alone."""
    d = tmp_path_factory.mktemp("torch_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        recs = random_genome(300_000, seed=9, n_refs=2, name_prefix="chr")
        fasta = d / "g.fasta"
        write_fasta(fasta, [(r.id, decode_to_ascii(r.codes)) for r in recs])
        for name, main in (("jax", jax_cli.main), ("port", cli.main)):
            out = d / name
            assert main(["index", "-g", str(fasta), "-i", "t", "--index-dir",
                         str(out), "--export-reference-format"] + ARGS) == 0
            assert main(["simulate", "-g", str(fasta), "-o", str(out),
                         "--name", "rd", "-c", "300", "--seed", "3"]
                        + ARGS) == 0
        (d / "ref").mkdir()
        for ext in REF_FILES:
            shutil.copy(d / "jax" / ("t" + ext), d / "ref" / ("t" + ext))
        yield d, fasta


@pytest.fixture(scope="module")
def sams(world):
    """The JAX CLI's SAMs of the simulated reads: align-free from the
    saved index, align mode from the reference-format files."""
    d, fasta = world
    fq = str(d / "jax" / "rd.fastq")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        assert jax_cli.main(["map", "-i", "t", "-q", fq, "-o",
                             str(d / "jax" / "out.sam"), "--index-dir",
                             str(d / "jax"), "--batch-size", "128"]
                            + ARGS) == 0
        assert jax_cli.main(["map", "-i", "t", "-q", fq, "-o",
                             str(d / "jax" / "out_al.sam"), "--index-dir",
                             str(d / "ref"), "-g", str(fasta), "--align",
                             "--batch-size", "128"] + ARGS) == 0
    return {"free": d / "jax" / "out.sam", "align": d / "jax" / "out_al.sam"}


def _file_bytes(directory):
    return {name: (directory / name).read_bytes()
            for name in sorted(os.listdir(directory))
            if name.startswith("t.")}


def test_index_writes_the_jax_artifacts(world):
    d, _ = world
    port, ref = _file_bytes(d / "port"), _file_bytes(d / "jax")
    assert sorted(port) == sorted(ref)
    assert {"t.bmtpu.json", "t.bmtpu.qgram_words.npy",
            "t.bmtpu.fine_packed.npy"} | {"t" + e for e in REF_FILES} \
        <= set(port)
    for name in ref:
        assert port[name] == ref[name], name


def test_simulate_writes_the_jax_reads_and_truth(world):
    d, _ = world
    for ext in (".fastq", ".bucket_ground_truth", ".position_ground_truth"):
        got = (d / "port" / ("rd" + ext)).read_bytes()
        assert got == (d / "jax" / ("rd" + ext)).read_bytes(), ext
        assert got.count(b"\n") >= 300


@pytest.mark.parametrize("mode", ["saved", "refformat", "refformat_align"])
def test_map_gives_the_jax_sam(mode, world, sams):
    d, fasta = world
    out = d / "port" / f"out_{mode}.sam"
    argv = ["map", "--device", "cpu", "-i", "t", "-q",
            str(d / "jax" / "rd.fastq"), "-o", str(out), "--batch-size",
            "128"] + ARGS
    if mode == "saved":
        argv += ["--index-dir", str(d / "jax")]
    else:
        argv += ["--index-dir", str(d / "ref"), "-g", str(fasta)]
    if mode == "refformat_align":
        argv.append("--align")
    assert cli.main(argv) == 0
    want = sams["align" if mode == "refformat_align" else "free"]
    assert out.read_bytes() == want.read_bytes()
    assert out.read_bytes().count(b"\n") > 250


def _both_outputs(argv, capsys):
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("case", ["ground_truth", "best_alignment",
                                  "tolerance10"])
def test_analyze_sam_prints_the_jax_report(case, world, sams, capsys):
    d, _ = world
    argv = ["analyze-sam", str(sams["free"]), "--fastq",
            str(d / "jax" / "rd.fastq")]
    if case == "best_alignment":
        argv += ["--best-alignment", str(sams["align"])]
    else:
        argv += ["--ground-truth", str(d / "jax" / "rd.position_ground_truth")]
    if case == "tolerance10":
        argv += ["--tolerance", "10"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        got, want = _both_outputs(argv, capsys)
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 8 and "sensitivity" in got


def test_analyze_fastq_prints_the_jax_report(world, capsys):
    d, _ = world
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        got, want = _both_outputs(["analyze-fastq",
                                   str(d / "jax" / "rd.fastq")], capsys)
    assert got.splitlines() == want.splitlines()
    assert "Estimated error rate" in got


def test_index_refuses_an_existing_artifact(world, capsys):
    d, fasta = world
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        before = (d / name / "t.bmtpu.json").stat().st_mtime_ns
        assert main(["index", "-g", str(fasta), "-i", "t", "--index-dir",
                     str(d / name)] + ARGS) == 1
        assert "already exists" in capsys.readouterr().err
        assert (d / name / "t.bmtpu.json").stat().st_mtime_ns == before


def _dwgsim(d):
    (d / "ref.fasta").write_text(
        ">NC_000001.1 synthetic chr A\nACGTACGTACGT\n"
        ">NC_000002.1 synthetic chr B\nTTTTACGTACGT\n")
    reads = ["NC_000001.1_100_300_0_1_0_0_1:0:0_2:0:0_abc/1",
             "NC_000002.1_55_200_1_0_0_0_0:0:0_0:0:0_def/1",
             "NC_000001.1_7_9_0_0_1_1_0:0:0_0:0:0_ghi/2"]
    with open(d / "r.fastq", "w") as f:
        for name in reads:
            f.write(f"@{name}\nACGTACGT\n+\nEEEEEEEE\n")
    with open(d / "out.sam", "w") as f:
        f.write("@SQ\tSN:NC_000001.1\tLN:12\n@SQ\tSN:NC_000002.1\tLN:12\n")
        f.write(f"{reads[0]}\t0\tNC_000001.1\t104\t60\t8M\t*\t0\t0\t"
                "ACGTACGT\tEEEEEEEE\n")
        f.write(f"{reads[1]}\t0\tNC_000002.1\t56\t60\t8M\t*\t0\t0\t"
                "ACGTACGT\tEEEEEEEE\n")
        f.write(f"{reads[2]}\t16\tNC_000001.1\t8\t60\t8M\t*\t0\t0\t"
                "ACGTACGT\tEEEEEEEE\n")
    return ["--fasta", str(d / "ref.fasta"), "--dwgsim"]


def _pbsim3(d):
    with open(d / "r.fastq", "w") as f:
        for name in ("S1_1", "S1_2", "S2_1"):
            f.write(f"@{name}\nACGTACGTACGT\n+\nEEEEEEEEEEEE\n")
    (d / "truth.maf").write_text(
        "a\ns ref1 4000 12 + 4641652 ACGTACGTACGT\n"
        "s S1_1 0 12 + 12 ACGTACGTACGT\n"
        "a\ns ref1 9000 12 + 4641652 ACGTACGTACGT\n"
        "s S1_2 0 12 - 12 ACGTACGTACGT\n"
        "a\ns ref2 77 12 + 999999 ACGTACGTACGT\n"
        "s S2_1 0 12 + 12 ACGTACGTACGT\n")
    with open(d / "out.sam", "w") as f:
        f.write("@SQ\tSN:chr1\tLN:4641652\n@SQ\tSN:chr2\tLN:999999\n")
        f.write("S1_1\t0\tchr1\t4003\t60\t12M\t*\t0\t0\t"
                "ACGTACGTACGT\tEEEEEEEEEEEE\n")
        f.write("S1_2\t16\tchr1\t9001\t60\t12M\t*\t0\t0\t"
                "ACGTACGTACGT\tEEEEEEEEEEEE\n")
        f.write("S2_1\t0\tchr2\t200\t60\t12M\t*\t0\t0\t"
                "ACGTACGTACGT\tEEEEEEEEEEEE\n")
    return ["--ground-truth", str(d / "truth.maf")]


@pytest.mark.parametrize("fixture", [_dwgsim, _pbsim3],
                         ids=["dwgsim", "pbsim3"])
def test_truth_fixtures_score_as_jax(fixture, tmp_path, capsys):
    """The real-format dwgsim read-name and pbsim3 .maf fixtures of
    tests/test_cli_and_analyzers.py: the same truth, BenchmarkResult and
    report."""
    flags = fixture(tmp_path)
    results = []
    for mod in (sam_analyzer, jax_sam_analyzer):
        an = mod.SamAnalyzer(error_tolerance=5)
        if "--fasta" in flags:
            an.read_fasta_file(tmp_path / "ref.fasta")
        an.read_sequence_file(tmp_path / "r.fastq",
                              is_dwgsim="--dwgsim" in flags)
        if "--ground-truth" in flags:
            an.read_ground_truth_file(tmp_path / "truth.maf")
        res = an.benchmark(tmp_path / "out.sam", quiet=True)
        results.append((dataclasses.asdict(res),
                        [[dataclasses.astuple(p) for p in a]
                         for a in an.answer], an.is_random_read))
    assert results[0] == results[1]
    assert results[0][0]["total_reads"] == 3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        got, want = _both_outputs(["analyze-sam", str(tmp_path / "out.sam"),
                                   "--fastq", str(tmp_path / "r.fastq")]
                                  + flags, capsys)
    assert got.splitlines() == want.splitlines()
