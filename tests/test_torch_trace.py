"""The port's stage hook in its three host threads, and the benchmark's
readers of its spans.

A recording hook on `BucketMapPipeline.stage` sees each span on its
thread (the caller's, the FASTQ reader's and the SAM writer's), once per
batch or dispatch chunk and never per read; the caller's spans only
nest; the SAM is byte for byte the same with and without the hook; the
dispatch stage's CPU seconds lie within its wall time; the caller's
wait for a slowed reader or writer falls inside its spans; a failed
write is raised on the caller in both output modes. Each of the
benchmark's readers of these spans (`perfbench/metrics/pipeline.*`),
fed a made context, gives the value worked out by hand, and nothing
where the program left no span for it. The world is the port's own
(config, index build, simulator): no JAX is needed here."""

import collections
import contextlib
import importlib.util
import inspect
import os
import sys
import threading
import time

import pytest

from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.index.builder import build_index
from bucketmap_tpu_torch.io.fastq import iter_fastq_batches, read_fastq
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from bucketmap_tpu_torch.sim.simulator import ShortReadSimulator, repeat_genome
from bucketmap_tpu_torch.utils.debug import no_stage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = MapperConfig(bucket_len=4096, read_len=150, index_seed=6, query_seed=9,
                   mapper_samples=8)
READS, PER_CHUNK, BATCH = 600, 250, 128

READER, WRITER = "bmtorch-fastq-reader", "bmtorch-sam-writer"
MAIN_SPANS = ("wait_reads", "segment", "dispatch", "download", "decode",
              "extract", "handoff", "drain")
THREAD_OF = {**{n: "main" for n in MAIN_SPANS}, "parse": READER,
             "merge": WRITER, "sam_write": WRITER}


class Recorder:
    """A stage hook that records (thread, name, start ns, end ns), the
    calling thread named "main"."""

    def __init__(self):
        self.main = threading.get_ident()
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            th = threading.current_thread()
            self.spans.append(("main" if th.ident == self.main else th.name,
                               name, t0, time.perf_counter_ns()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trace")
    genome = repeat_genome(120_000, seed=21, n_refs=2)
    index = build_index(genome, CFG)
    sim = ShortReadSimulator(CFG, substitution_rate=0.01,
                             insertion_rate=0.001, deletion_rate=0.001,
                             seed=32)
    sim.read(genome)
    return d, index, sim.generate(d, "reads", READS)["fastq"]


@pytest.fixture(scope="module", params=[4, 1], ids=["ppr4", "ppr1"])
def traced(world, request):
    """map_fastq with the recording hook and without one; with one pair
    a read the lane budget overflows, so the steps grow past it (one
    device takes no split retry)."""
    d, index, fastq = world
    ppr = request.param
    pipe = BucketMapPipeline(index, device="cpu", batch_size=BATCH,
                             pair_batch=64, pairs_per_read=ppr)
    plain = pipe.map_fastq(fastq, d / f"plain{ppr}.sam",
                           reads_per_chunk=PER_CHUNK)
    rec = Recorder()
    pipe.stage = rec
    stats = pipe.map_fastq(fastq, d / f"traced{ppr}.sam",
                           reads_per_chunk=PER_CHUNK)
    pipe.stage = no_stage
    return {"ppr": ppr, "spans": rec.spans, "stats": stats, "plain": plain,
            "sam": (d / f"traced{ppr}.sam").read_bytes(),
            "plain_sam": (d / f"plain{ppr}.sam").read_bytes()}


def test_each_span_on_its_thread(traced):
    seen = collections.defaultdict(set)
    for thread, name, _, _ in traced["spans"]:
        seen[name].add(thread)
    assert dict(seen) == {n: {t} for n, t in THREAD_OF.items()}


def test_spans_once_a_batch_or_a_chunk(traced):
    """segment, drain and parse once a ReadBatch, wait_reads once more
    (the stream's end); handoff, merge and sam_write once a location
    chunk (one an extract); dispatch, download and decode once a step.
    So no span is entered per read."""
    n = collections.Counter(name for _, name, _, _ in traced["spans"])
    batches = -(-READS // PER_CHUNK)
    assert n["segment"] == n["drain"] == n["parse"] == batches
    assert n["wait_reads"] == batches + 1
    chunks = n["extract"]
    assert chunks >= batches
    assert n["handoff"] == n["merge"] == n["sam_write"] == chunks
    assert n["dispatch"] == n["download"] == n["decode"]
    # one step a chunk: an overflowing chunk's step grows past its lane
    # budget, where the split retry re-ran it inside its extract
    assert n["dispatch"] == chunks == traced["stats"].steps
    assert (traced["stats"].grown_steps > 0) == (traced["ppr"] == 1)
    assert traced["stats"].split_steps == 0
    assert sum(n.values()) < READS / 5


def test_reader_counts_its_chunks(traced):
    """map_fastq's reader counts each chunk it parsed, all of them by the
    host library, which builds here."""
    stats = traced["stats"]
    assert stats.parse_chunks == -(-READS // PER_CHUNK)
    assert stats.parse_native_chunks == stats.parse_chunks
    assert traced["plain"].parse_chunks == stats.parse_chunks


def test_main_thread_spans_only_nest(traced):
    main = sorted(((t0, -t1, name) for th, name, t0, t1 in traced["spans"]
                   if th == "main"))
    stack = []
    nested = 0
    for t0, neg_t1, name in main:
        t1 = -neg_t1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        if stack:
            assert t1 <= stack[-1][1], (name, "overlaps", stack[-1][2])
            nested += 1
        stack.append((t0, t1, name))
    # no span sits inside another: only the split retry's dispatch
    # cycles did, and one device no longer takes it
    assert nested == 0


def test_sam_equal_with_and_without_the_hook(traced):
    assert traced["sam"] == traced["plain_sam"]
    assert traced["stats"].num_reads == traced["plain"].num_reads == READS
    assert traced["stats"].mapped_locations == \
        traced["plain"].mapped_locations > READS // 2


def test_dispatch_cpu_within_its_wall_time(traced):
    wall = sum(t1 - t0 for _, name, t0, t1 in traced["spans"]
               if name == "dispatch") / 1e9
    cpu = traced["stats"].dispatch_cpu_seconds
    assert 0 < cpu <= wall * 1.01 + 2e-3
    assert 0 < traced["plain"].dispatch_cpu_seconds
    st = traced["stats"]
    assert st.segment_seconds > 0 and st.cycle_seconds > 0


def _uncovered_s(spans, t0, t1):
    """Seconds of [t0, t1) (ns) that the calling thread's spans leave
    uncovered."""
    covered, end = 0, t0
    for a, b in sorted((a, b) for th, _, a, b in spans if th == "main"):
        if b > end:
            covered += b - max(a, end)
            end = b
    return (t1 - t0 - covered) / 1e9


@pytest.mark.parametrize("slow", ["reader", "writer"])
def test_a_slow_thread_shows_in_the_callers_spans(world, monkeypatch, slow):
    """Where the FASTQ reader's parse or the SAM writer's emit is slowed,
    the time the calling thread waits for it lies inside its spans
    (wait_reads; handoff and drain), not between them."""
    from bucketmap_tpu_torch.io import fastq as fastq_mod

    d, index, fastq = world
    pipe = BucketMapPipeline(index, device="cpu", batch_size=BATCH,
                             pair_batch=64)
    delay, n = (0.3, -(-READS // PER_CHUNK)) if slow == "reader" else \
        (0.15, READS // BATCH + 1)
    if slow == "reader":
        parse = fastq_mod.parse_fastq
        monkeypatch.setattr(fastq_mod, "parse_fastq", lambda *a, **k: (
            time.sleep(delay), parse(*a, **k))[1])
    else:
        emit = pipe._merge_emit
        monkeypatch.setattr(pipe, "_merge_emit", lambda *a: (
            time.sleep(delay), emit(*a))[1])
    rec = Recorder()
    pipe.stage = rec
    t0 = time.perf_counter_ns()
    pipe.map_fastq(fastq, d / f"slow_{slow}.sam", reads_per_chunk=PER_CHUNK)
    t1 = time.perf_counter_ns()
    waits = sum(b - a for _, name, a, b in rec.spans
                if name in ("wait_reads", "handoff", "drain")) / 1e9
    assert waits > delay
    assert _uncovered_s(rec.spans, t0, t1) < 0.25 * delay * n


@pytest.mark.parametrize("align", [False, True], ids=["align-free", "align"])
def test_a_failed_write_raises_and_never_blocks(world, monkeypatch, align):
    """A write that fails on the SAM writer (align-free) or the align-emit
    thread, while the caller still has chunks or sub-batches to hand over
    (8 dispatch chunks of 32 reads), is raised by map_reads; nothing waits
    on a queue that nobody takes from."""
    d, index, fastq = world
    pipe = BucketMapPipeline(index, device="cpu", align=align, batch_size=32,
                             pair_batch=64)

    def failing_write(*a):
        time.sleep(0.5)
        raise OSError("the SAM's disk is full")
    monkeypatch.setattr(pipe, "_emit_records", failing_write)
    batch = read_fastq(fastq).head(250)
    raised = []

    def run():
        try:
            pipe.map_reads(batch, d / f"failed_{align}.sam")
        except Exception as e:
            raised.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(20)
    assert not th.is_alive(), "map_reads blocked after a failed write"
    assert len(raised) == 1 and isinstance(raised[0], OSError), raised


def test_default_hook_is_a_null_context(world):
    """With no hook set, every span is one contextlib.nullcontext."""
    _, index, _ = world
    pipe = BucketMapPipeline(index, device="cpu", batch_size=BATCH,
                             pair_batch=64)
    assert pipe.stage is no_stage
    assert inspect.signature(iter_fastq_batches).parameters["stage"] \
        .default is no_stage
    assert isinstance(no_stage("parse"), contextlib.nullcontext)


# ---------------------------------------------------------------------
# the benchmark's readers, fed a made context

def _load(path, name):
    """The module at `path`, as the benchmark's own files import it."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


PERFBENCH = os.path.join(REPO, "perfbench")
trace_mod = _load(os.path.join(PERFBENCH, "core", "trace.py"),
                  "perfbench_core_trace")
spec_mod = _load(os.path.join(PERFBENCH, "core", "spec.py"),
                 "perfbench_core_spec")

S = 1_000_000_000   # ns a second
# (thread, layer, stage, start s, end s): the main thread's spans cover
# [0, 2.6] and [4, 5.5] s of a 10 s window (extract holds a split
# retry's dispatch; the step's spans and the other threads' do not
# count); 2,000,000 reads
SPANS = [("main", "pipeline", "wait_reads", 0.0, 1.0),
         ("main", "pipeline", "segment", 1.0, 1.2),
         ("main", "pipeline", "dispatch", 1.2, 1.6),
         ("main", "step", "coarse", 1.3, 1.5),
         ("main", "pipeline", "handoff", 1.6, 1.7),
         ("main", "pipeline", "extract", 1.7, 2.6),
         ("main", "pipeline", "dispatch", 2.0, 2.4),
         ("main", "step", "pack", 3.0, 3.5),
         ("main", "pipeline", "drain", 4.0, 5.0),
         ("main", "pipeline", "wait_reads", 5.0, 5.5),
         ("reader", "pipeline", "parse", 0.0, 0.6),
         ("writer", "pipeline", "merge", 0.0, 3.0),
         ("writer", "pipeline", "sam_write", 3.0, 3.4)]


def _ctx(drop=(), stats_drop=()):
    main = threading.main_thread().ident
    tid = {"main": main, "reader": main + 1, "writer": main + 2}
    clock = trace_mod.StageClock()
    clock.spans.extend((tid[th], layer, name, int(a * S), int(b * S))
                       for th, layer, name, a, b in SPANS
                       if name not in drop)
    stats = {"num_reads": 2_000_000, "output_seconds": 4.0,
             "dispatch_cpu_seconds": 0.2, "parse_chunks": 16,
             "parse_native_chunks": 12}
    for k in stats_drop:
        del stats[k]
    return {"clock": clock, "stats": stats, "reads": 2_000_000,
            "window_s": 10.0}


@pytest.mark.parametrize("metric, want, drop, stats_drop", [
    ("pipeline.read_wait_s_per_mread", 0.75, ("wait_reads",), ()),
    ("pipeline.segment_s_per_mread", 0.1, ("segment",), ()),
    ("pipeline.writer_wait_s_per_mread", 0.55, ("handoff", "drain"), ()),
    ("pipeline.parse_s_per_mread", 0.3, ("parse",), ()),
    ("pipeline.merge_s_per_mread", 1.5, ("merge",), ()),
    ("pipeline.sam_write_s_per_mread", 0.2, ("sam_write",), ()),
    ("pipeline.unstaged_pct", 59.0, MAIN_SPANS, ()),
    # 0.2 CPU s of 0.8 s of dispatch; the parent's MapStats has no such
    # counter
    ("pipeline.dispatch_cpu_pct", 25.0, (), ("dispatch_cpu_seconds",)),
    # 12 of 16 chunks parsed by the host library; the parent's MapStats
    # has neither counter
    ("pipeline.parse_native_pct", 75.0, (),
     ("parse_chunks", "parse_native_chunks")),
])
def test_reader_of_the_spans(metric, want, drop, stats_drop):
    read = spec_mod.reader(REPO, metric)
    assert read(_ctx()) == pytest.approx(want, rel=1e-9)
    assert read(_ctx(drop, stats_drop)) is None
