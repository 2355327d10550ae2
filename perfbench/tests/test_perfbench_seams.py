"""What a later cell brings as files of its own: a named read draw, a
named check reference, each compared instance's context (its ordinal,
its chunk and the chunk's read lengths), and the aligner's counts among
the traced readers' context. A mix that names neither draw nor
reference makes the inputs and expectations it made before the seams."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from core import feeder
from core import genome as G
from core import reads as R
from core import spec

from conftest import PERFBENCH, TINY, make_root

HERE = os.path.dirname(os.path.abspath(__file__))

# digests of the tiny cell's pool and of the default reference's records
# of its sampled reads, computed on the tree before the seams, by the
# functions below
PARENT = {
    1: ("dce08de615d55b13063ac5ba10d03e2c137216d40c733a308e85fed686460a44",
        "22db45d35a18a03bfa14c5c52aef7d9b0b368f4b8db84b60783382687303a7bf"),
    2_147_483_659: (
        "da8fcb9ee9b62a22e295a170b8c485e8347ffc99490505d50b025898bc2744dc",
        "1216d7aef351d03edd8e04cd4c0c586230c2fdf466bb4358a0c242a4515f426f"),
    4_000_000_007: (
        "933b76ea32b514e8f5ab32ae22f32bbc5cfaad4250470b7fbdf0624c51342928",
        "0beb26e41a6b29e29cb9f4938b9f63a352cf7b2cb387330d9826298b9d905044"),
}


def pool_digest(pool) -> str:
    h = hashlib.sha256()
    for a in (pool.buf, pool.lengths, pool.truth_ref, pool.truth_pos,
              pool.truth_rc, pool.sample, *pool.sample_codes):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(b"%d %d" % (pool.record, pool.quality))
    return h.hexdigest()


def records_digest(recs) -> str:
    h = hashlib.sha256()
    for r in recs:
        h.update(b"\n".join(r) + b"\n\n")
    return h.hexdigest()


def inputs(root, workload, seed):
    cell = spec.cell(root, workload)
    return cell, feeder.make_inputs({
        "root": root, "cache_dir": cell.cache_dir, "config": cell.config,
        "traffic": cell.traffic, "seed": seed})


@pytest.mark.parametrize("seed", sorted(PARENT))
def test_default_inputs_are_the_parents(tiny_root, seed):
    cell, (ref, pool, info) = inputs(tiny_root, TINY, seed)
    assert (info["draw"], info["reference"]) == ("short_reads", "align_free")
    chunks = feeder.Chunks(pool, cell.traffic["run"]["reads_per_chunk"],
                           3 * pool.n)
    recs = [ref.records(c, pool.quality, b"\0", chunks.instance(int(i)))
            for i, c in zip(pool.sample, pool.sample_codes)]
    assert (pool_digest(pool), records_digest(recs)) == PARENT[seed]


def test_chunks_are_the_programs(tiny_root, tmp_path):
    """The program's reader cuts a stream of pool records into the
    chunks that feeder.Chunks gives, the last one cut where the stream
    ends; a pool whose chunk of records passes the program's byte cap is
    refused."""
    from bucketmap_tpu_torch.io.fastq import iter_fastq_batches

    cell, (_, pool, _) = inputs(tiny_root, TINY, 7)
    per, written = 1000, 2 * pool.n + 1234
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for _ in range(3):
            f.write(pool.buf.tobytes())
    with open(fq, "r+b") as f:
        f.truncate(written * pool.record)
    chunks = feeder.Chunks(pool, per, written)
    got = [b.lengths for b in iter_fastq_batches(str(fq),
                                                 reads_per_batch=per)]
    assert len(got) == -(-written // per)
    for c, lengths in enumerate(got):
        inst = chunks.instance(c * per)
        assert inst.chunk == c
        assert np.array_equal(lengths, inst.chunk_lengths)
        assert inst.chunk_width == lengths.max()
    big = json.loads(json.dumps(cell.traffic))
    big["run"]["reads_per_chunk"] = feeder.CHUNK_BYTES // pool.record + 1
    with pytest.raises(ValueError, match="chunk"):
        feeder.make_inputs({"root": tiny_root, "cache_dir": cell.cache_dir,
                            "config": cell.config, "traffic": big,
                            "seed": 7})


class ChunkTagged:
    """A reference whose one record of a read carries the instance's
    chunk as its MAPQ."""
    depends = ("chunk",)

    def __init__(self, names):
        self.names = names
        self.calls = []

    def records(self, codes, quality, name, instance):
        self.calls.append(instance.ordinal)
        return [record(name, self.names[0], instance.chunk)]


def record(name: bytes, ref: str, tag: int) -> bytes:
    return b"\t".join([name, b"0", ref.encode(), b"1001", b"%d" % tag,
                       b"*", b"*", b"0", b"0", b"ACGT", b"EEEE"])


def test_each_instance_is_held_to_its_chunk():
    recs = G.repeat_genome(400_000, seed=3, n_refs=1)
    g = G.Genome([n for n, _ in recs], [len(c) for _, c in recs],
                 [G.pack_2bit(c) for _, c in recs])
    traffic = {"pool": 50, "read_len": 300, "substitution_rate": 0.002,
               "insertion_rate": 0.00025, "deletion_rate": 0.00025,
               "revcomp_share": 0.5, "quality": "E"}
    pool = R.draw(g, g.buckets(65536, 300), 65536, traffic, 11, 20)
    per, written = 40, 130          # chunks of 40, 40, 40 and 10
    names = [n for n, _ in recs]

    def sam(fault_in=None):
        lines = []
        for inst in range(written):
            tag = inst // per
            if tag == fault_in:
                tag += 7
            lines.append(record(pool.name(inst % pool.n, inst), names[0],
                                tag))
        return b"\n".join(lines) + b"\n"

    def run_check(ref, data):
        s = feeder.Stream(pool, names)
        s.score(data)
        return feeder.check(ref, pool, s, written, per)

    ref = ChunkTagged(names)
    out = run_check(ref, sam())
    insts = [i for s in pool.sample.tolist() for i in range(s, written, 50)]
    # reads whose instances fall in two or three chunks among them
    assert len({(i % 50, i // per) for i in insts}) > len(pool.sample)
    assert out["compared"] == len(insts) and out["differing"] == 0
    assert out["expectations"] == len({(i % 50, i // per) for i in insts})
    assert sorted(ref.calls) == sorted(
        min(i for i in insts if (i % 50, i // per) == k)
        for k in {(i % 50, i // per) for i in insts})
    last = feeder.Chunks(pool, per, written).instance(125)
    assert last.chunk == 3 and len(last.chunk_lengths) == 10
    # a fault in one chunk only: exactly that chunk's instances differ
    for c in range(4):
        out = run_check(ChunkTagged(names), sam(fault_in=c))
        assert out["differing"] == sum(i // per == c for i in insts)
    # a reference that declares no dependence on the chunk is held to
    # the first instance's chunk everywhere, and fails
    blind = ChunkTagged(names)
    blind.depends = ()
    assert run_check(blind, sam())["differing"] > 0


# -- a cell that brings its own draw and reference, in a CPU rehearsal --

DRAW = '''"""The mix's reads drawn with no errors."""

from core.reads import draw as _draw


def draw(genome, layout, bucket_len, reads, seed, sample_reads):
    return _draw(genome, layout, bucket_len,
                 dict(reads, substitution_rate=0.0, insertion_rate=0.0,
                      deletion_rate=0.0), seed, sample_reads)
'''

REFERENCE = '''"""core/reference.py's records, held chunk by chunk{what}."""

import os

from core.reference import Params, ReferenceIndex


class Ref:
    depends = ("chunk",)

    def __init__(self, index):
        self.index = index
        self.names = index.names
        self.layout = index.layout

    def records(self, codes, quality, name, instance):
        out = []
        for r in self.index.records(codes, quality, name):
            f = r.split(b"\\t")
            {change}
            out.append(b"\\t".join(f))
        return sorted(out)


def ensure(cache_dir, state_dir, config, genome):
    os.makedirs(state_dir, exist_ok=True)
    index, built = ReferenceIndex.ensure(cache_dir, Params(config["mapper"]),
                                         genome)
    return Ref(index), built
'''

REFERENCES = {
    "via_seam": ("", "pass"),
    "mapq_off": (", every MAPQ one higher",
                 'f[4] = b"%d" % (int(f[4]) + 1)'),
    "odd_chunks_shifted": (
        ", POS one on in the odd chunks",
        'f[3] = b"%d" % (int(f[3]) + instance.chunk % 2)'),
}

COUNTERS = '''"""Writes the traced readers' program counters beside the root's
BENCHMARK.json; the aligner's pairs, or nothing."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read(ctx):
    counters = ctx["program_counters"]
    with open(os.path.join(ROOT, "program_counters.json"), "w") as f:
        json.dump(counters, f)
    return None if counters is None else float(counters["pairs"])
'''

CELLS = {  # traffic: (reference, align)
    "seam": ("via_seam", False),
    "seam-mapq": ("mapq_off", False),
    "seam-shift": ("odd_chunks_shifted", False),
    "seam-align": ("via_seam", True),
}


def _digest(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def seam_root(tiny_root, tmp_path_factory):
    """The tiny root with the harness's draws, references and metrics
    copied, then a draw, references, a metric, mixes and cells added as
    new files and appended entries; the tiny cell's caches shared."""
    root = make_root(str(tmp_path_factory.mktemp("seam")))
    pb = os.path.join(root, "perfbench")
    for d in ("draws", "references", "metrics"):
        os.unlink(os.path.join(pb, d))
        shutil.copytree(os.path.join(PERFBENCH, d), os.path.join(pb, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    cache = os.path.join(tiny_root, "perfbench", ".cache", "tiny")
    os.makedirs(cache, exist_ok=True)
    os.makedirs(os.path.join(pb, ".cache"))
    os.symlink(cache, os.path.join(pb, ".cache", "tiny"))
    bench_path = os.path.join(root, "BENCHMARK.json")
    before = _digest(pb)
    with open(bench_path) as f:
        bench_before = json.load(f)

    def write(rel, text):
        path = os.path.join(pb, rel)
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write(text)

    write("draws/exact_reads.py", DRAW)
    for name, (what, change) in REFERENCES.items():
        write(f"references/{name}.py",
              REFERENCE.format(what=what, change=change))
    write("metrics/test.program_counters.py", COUNTERS)
    with open(os.path.join(pb, "traffic", "sr300.json")) as f:
        tiny = json.load(f)
    bench = json.loads(json.dumps(bench_before))
    for traffic, (reference, align) in CELLS.items():
        mix = json.loads(json.dumps(tiny))
        mix["name"] = traffic
        mix["reads"]["draw"] = "exact_reads"
        mix["check"]["reference"] = reference
        mix["run"]["align"] = align
        write(f"traffic/{traffic}.json", json.dumps(mix))
        bench["workloads"].append({"name": f"tiny.{traffic}",
                                   "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "a seam's test"})
    bench["per_layer"].append({
        "name": "test.program_counters", "unit": "pairs",
        "better": "higher", "source": "program_counter", "layer": "align",
        "moves": "reads_per_s",
        "workloads": ["tiny.seam", "tiny.seam-align"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    # nothing there before was edited: the harness's files, and every
    # entry of BENCHMARK.json, each list only appended to
    after = _digest(pb)
    assert {k: after[k] for k in before} == before
    for key, value in bench_before.items():
        if isinstance(value, list):
            assert bench[key][:len(value)] == value
        else:
            assert bench[key] == value
    return root


def rehearse(root, workload, *args, probe="-", env=None, seconds="0.05"):
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "rehearse.py"), root, probe,
         "--workload", workload, "--seconds", seconds, *args],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, **(env or {})})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    return lines[0]["inputs"], lines[-1]


def test_own_draw_and_default_reference_through_the_seam(seam_root):
    """The traced run of a cell with its own draw and a reference that
    is the default's records, held chunk by chunk: correct; an
    align-free pipeline has no program counters."""
    inputs_, res = rehearse(seam_root, "tiny.seam", "--seed", "12",
                            "--trace", "1")
    assert (inputs_["draw"], inputs_["reference"]) == ("exact_reads",
                                                       "via_seam")
    assert res["correct"] is True
    assert res["checks"]["reads_compared"]["value"] >= 64
    assert "test.program_counters" not in res["metrics"]
    with open(os.path.join(seam_root, "program_counters.json")) as f:
        assert json.load(f) is None


def test_reference_with_every_record_altered_fails(seam_root):
    _, res = rehearse(seam_root, "tiny.seam-mapq", "--seed", "12",
                      "--trace", "0", seconds="0.001")
    checks = res["checks"]
    assert res["correct"] is False
    assert checks["reads_compared"]["value"] >= 64
    assert checks["reads_differing"]["value"] == \
        checks["reads_compared"]["value"]


def test_output_that_depends_on_its_chunk(seam_root):
    """The program made to write its odd chunks' records one base on:
    the reference that expects that, chunk by chunk, finds it correct;
    the plain program, held to that reference, is not."""
    _, res = rehearse(seam_root, "tiny.seam-shift", "--seed", "13",
                      "--trace", "0", probe="chunk_shifted", seconds="0.001")
    assert res["correct"] is True, res["checks"]
    _, res = rehearse(seam_root, "tiny.seam-shift", "--seed", "13",
                      "--trace", "0", seconds="0.001")
    checks = res["checks"]
    assert res["correct"] is False
    assert 0 < checks["reads_differing"]["value"] < \
        checks["reads_compared"]["value"]


def test_program_counters_are_the_aligners(seam_root, tmp_path):
    counts = tmp_path / "counts.json"
    _, res = rehearse(seam_root, "tiny.seam-align", "--seed", "14",
                      "--trace", "1", probe="aligner_window_counts",
                      seconds="0.001",
                      env={"PERFBENCH_TEST_COUNTS": str(counts)})
    with open(os.path.join(seam_root, "program_counters.json")) as f:
        got = json.load(f)
    want = json.loads(counts.read_text())
    assert got == want
    assert set(got) >= {"sub_batches", "pairs", "ops_reruns"}
    assert got["pairs"] > 0
    assert res["metrics"]["test.program_counters"]["value"] == got["pairs"]
