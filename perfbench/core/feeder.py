"""The run's second process: it makes the inputs, feeds the FASTQ
stream, reads the SAM stream back and checks it against the plain
reference. The genome, the read pool and the reference's state live
here, so that none of it counts in the memory of the process that runs
the program; this process imports nothing of the program.

Driven over its standard input and output, one JSON object a line:
  started with {"root", "cache_dir", "config", "traffic", "seed",
    "seconds", "fifos", "cores"} as its argument, it makes the inputs
    (the pool by the mix's draw, the state of the mix's reference: both
    found by name under `root`'s perfbench/, core/spec.py), keeps its
    threads on `cores` from then on, sets aside the memory the window's
    SAM stream will fill, and says {"event": "ready", ...};
  {"cmd": "warm"}: writes the first warm_reads reads of the pool into
    the warm-up FIFO and reads the SAM back ({"event": "warmed"});
  {"cmd": "window"}: writes the pool, pass after pass, into the window's
    FIFO for `seconds` from its first byte, closes it, reads every SAM
    record and scores it against the truth ({"event": "streamed"});
  {"cmd": "check"}: compares the sampled reads' records with the
    reference's ({"event": "checked"}) and exits.
"""

from __future__ import annotations

import collections
import dataclasses
import fcntl
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from core import genome as genome_mod  # noqa: E402
from core import reads as reads_mod  # noqa: E402
from core import spec as spec_mod  # noqa: E402

_SLICE = 1 << 20
_BLOCK = 4 << 20
# the window's SAM stream is read into memory set aside and touched in
# set-up: six times the pool's FASTQ bytes, at most 4 GiB (some 5
# million records); what comes past it, into chunks
SAM_BUFFER_BYTES = 4 << 30
# widest QNAME, FLAG, RNAME and POS a record may have
_FIELD_WIDTHS = (32, 4, 64, 12)
TOLERANCE = 10
MAX_INSTANCES = 1 << 26
DEFAULT_DRAW = "short_reads"
DEFAULT_REFERENCE = "align_free"
# the program's cap on a chunk's FASTQ bytes (iter_fastq_batches'
# bytes_per_batch, which map_fastq leaves at its default)
CHUNK_BYTES = 128 << 20
CONTEXT = ("ordinal", "chunk", "chunk_lengths", "chunk_width")


def say(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def write_all(fd: int, view) -> None:
    while len(view):
        n = os.write(fd, view)
        view = view[n:]


def _field(a, lo, hi, maxw: int, lead: int | None = None):
    """(ok, value) of the fields [lo, hi): ok where a field is 1 to maxw
    decimal digits, of which all but the last `lead` (default: all kept)
    are zeros; value, the integer of its last digits."""
    lead = maxw if lead is None else lead
    idx = hi[:, None] - 1 - np.arange(maxw)[None, :]
    use = idx >= lo[:, None]
    d = a[np.maximum(idx, 0)] - np.uint8(48)          # wraps below '0'
    ok = ((hi - lo >= 1) & (hi - lo <= maxw)
          & ((d <= 9) | ~use).all(axis=1)
          & ((d[:, lead:] == 0) | ~use[:, lead:]).all(axis=1))
    # a float64 product is exact below 2**53, which 15 digits stay under
    d = np.where(use[:, :lead], d[:, :lead], 0).astype(np.float64)
    return ok, (d @ (10.0 ** np.arange(lead))).astype(np.int64)


class Stream:
    """The SAM stream read back: every record scored against the truth,
    the sampled reads' records kept; parsed with NumPy a block of lines
    at a time."""

    def __init__(self, pool: reads_mod.Pool, ref_names: list[str]):
        self.pool = pool
        self.refs = [n.encode() for n in ref_names]
        self.in_sample = np.zeros(pool.n, bool)
        self.in_sample[pool.sample] = True
        self.mapped = np.zeros(MAX_INSTANCES, bool)
        self.correct = np.zeros(MAX_INSTANCES, bool)
        self.kept: dict[int, list[bytes]] = {}
        self.records = 0
        self.unknown = 0
        self.score_s = 0.0

    def consume(self, path: str, buf: bytearray | None = None) -> None:
        """Drain the stream to its end, keeping its bytes (in `buf` as
        far as it holds them), then score them: while the program
        writes, this process only copies, so it takes as little of the
        host as it can from the program."""
        mv = memoryview(buf if buf is not None else bytearray())
        used = 0
        chunks = []
        fd = os.open(path, os.O_RDONLY)
        try:
            _widen_pipe(fd)
            while True:
                if used < len(mv):
                    n = os.readv(fd, [mv[used:used + _SLICE]])
                    if not n:
                        break
                    used += n
                    continue
                chunk = os.read(fd, _SLICE)
                if not chunk:
                    break
                chunks.append(chunk)
        finally:
            os.close(fd)
        t0 = time.perf_counter()
        pending = collections.deque(
            [mv[i:min(i + _SLICE, used)] for i in range(0, used, _SLICE)]
            + chunks)
        del chunks
        tail = b""
        while pending:
            parts, size = [tail], len(tail)
            while pending and size < _BLOCK:
                parts.append(pending.popleft())
                size += len(parts[-1])
            block = b"".join(parts)
            cut = block.rfind(b"\n") + 1
            self.score(block[:cut])
            tail = block[cut:]
        if tail:
            self.score(tail + b"\n")
        self.score_s += time.perf_counter() - t0

    def score(self, data: bytes) -> None:
        """Score a block of whole lines. Only the newlines are searched
        for in the whole block; each line's first four fields are found
        in its first bytes."""
        a = np.frombuffer(data, np.uint8)
        nl = np.flatnonzero(a == 10)
        if not len(nl):
            return
        starts = np.concatenate([[0], nl[:-1] + 1])
        body = (nl > starts) & (a[starts] != ord("@"))
        s, e = starts[body], nl[body]
        t = np.empty((len(s), 4), np.int64)
        at, ok = s, np.ones(len(s), bool)
        for i, w in enumerate(_FIELD_WIDTHS):
            idx = at[:, None] + np.arange(w + 1)[None, :]
            tab = a[np.minimum(idx, len(a) - 1)] == 9
            ok &= tab.any(axis=1)
            t[:, i] = at + tab.argmax(axis=1)
            at = t[:, i] + 1
        ok &= t[:, 3] < e
        ok_q, inst = _field(a, s, t[:, 0], _FIELD_WIDTHS[0], 15)
        ok_f, flag = _field(a, t[:, 0] + 1, t[:, 1], _FIELD_WIDTHS[1])
        ok_p, pos = _field(a, t[:, 2] + 1, t[:, 3], _FIELD_WIDTHS[3])
        ok &= ok_q & ok_f & ok_p
        self.unknown += int((~ok).sum())
        s, e, t = s[ok], e[ok], t[ok]
        inst, flag, pos = inst[ok], flag[ok], pos[ok]
        if not len(s):
            return
        rid = np.full(len(s), -1, np.int64)
        rw = t[:, 2] - t[:, 1] - 1
        for i, nm in enumerate(self.refs):
            m = np.flatnonzero(rw == len(nm))
            if len(m):
                got = a[(t[m, 1] + 1)[:, None] + np.arange(len(nm))]
                rid[m[(got == np.frombuffer(nm, np.uint8)).all(axis=1)]] = i
        bad = inst >= MAX_INSTANCES
        self.unknown += int(bad.sum())
        inst, flag, pos, rid = inst[~bad], flag[~bad], pos[~bad], rid[~bad]
        s, e = s[~bad], e[~bad]
        self.records += len(inst)
        j = inst % self.pool.n
        for r in np.flatnonzero(self.in_sample[j]):
            self.kept.setdefault(int(inst[r]), []).append(data[s[r]:e[r]])
        hit = ((rid == self.pool.truth_ref[j])
               & (((flag & 16) == 16) == self.pool.truth_rc[j])
               & (np.abs(pos - self.pool.truth_pos[j]) <= TOLERANCE))
        self.mapped[inst] = True
        self.correct[inst[hit]] = True


def _widen_pipe(fd: int) -> None:
    """A FIFO's buffer at 1 MiB (64 KiB by default), where the system
    allows it: fewer round trips between the two ends."""
    try:
        fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, 1 << 20)
    except (OSError, AttributeError):
        pass


def run_stream(pool: reads_mod.Pool, fq: str, sam: str, ref_names,
               seconds: float | None, reads: int | None,
               sam_buf: bytearray | None = None):
    """Feed `fq` (for `seconds` from the first byte, or the first `reads`
    reads) while reading `sam` back (into `sam_buf` as far as it holds
    it); (instances written, Stream, seconds the feed lasted). From the
    second pass over the pool on, each slice's names are rewritten just
    before it is written, so that no pass stalls the stream."""
    stream = Stream(pool, ref_names)
    err: list[BaseException] = []

    def consume():
        try:
            stream.consume(sam, sam_buf)
        except BaseException as e:  # reported by the main thread
            err.append(e)

    thr = threading.Thread(target=consume, name="perfbench-sam-reader")
    thr.start()
    written = 0
    t0 = None
    fd = os.open(fq, os.O_WRONLY)
    try:
        _widen_pipe(fd)
        mv = memoryview(pool.buf)
        per_slice = max(_SLICE // pool.record, 1)
        cuts = list(range(per_slice, pool.n, per_slice)) + [pool.n]
        k = 0
        done = False
        while not done:
            prev = 0
            for c in cuts:
                if reads is not None and k * pool.n + c >= reads:
                    c = reads - k * pool.n
                    done = True
                if c > prev:
                    if k:
                        pool.set_names(k, prev, c)
                    write_all(fd, mv[pool.offset(prev):pool.offset(c)])
                    if t0 is None:
                        t0 = time.perf_counter()
                    written = k * pool.n + c
                    prev = c
                if done or (seconds is not None
                            and time.perf_counter() - t0 >= seconds):
                    done = True
                    break
            k += 1
    finally:
        os.close(fd)
    feed_s = time.perf_counter() - (t0 or time.perf_counter())
    thr.join()
    if err:
        raise err[0]
    return written, stream, feed_s


@dataclasses.dataclass(eq=False)
class Instance:
    """What the program's records of one written instance of a pool read
    may depend on besides the read: its ordinal in the window's stream,
    its chunk, and the lengths of the chunk's reads.

    The program maps the stream in chunks of `run.reads_per_chunk` reads
    (map_fastq's reader, iter_fastq_batches), cut by count: instance i is
    in chunk i // reads_per_chunk, and the last chunk ends at the last
    instance written. A chunk is also cut where its FASTQ bytes reach
    CHUNK_BYTES; every record of a pool has one size, so that cap never
    binds where reads_per_chunk records take CHUNK_BYTES or less, which
    make_inputs holds every pool to."""

    ordinal: int
    chunk: int
    chunk_lengths: np.ndarray     # the chunk's read lengths, in order

    @property
    def chunk_width(self) -> int:
        """The chunk's longest read: the width of its ReadBatch."""
        return int(self.chunk_lengths.max())


class Chunks:
    """The window's instances in their chunks."""

    def __init__(self, pool: reads_mod.Pool, reads_per_chunk: int,
                 written: int):
        self.pool = pool
        self.per = int(reads_per_chunk)
        self.written = written
        self._lengths: dict[int, np.ndarray] = {}

    def instance(self, ordinal: int) -> Instance:
        c = ordinal // self.per
        lengths = self._lengths.get(c)
        if lengths is None:
            lo, hi = c * self.per, min((c + 1) * self.per, self.written)
            lengths = self.pool.lengths[np.arange(lo, hi) % self.pool.n]
            self._lengths[c] = lengths
        return Instance(ordinal, c, lengths)


def context_key(inst: Instance, depends) -> tuple:
    """The values of `depends` for an instance: instances with one key
    share an expectation."""
    out = []
    for f in depends:
        v = getattr(inst, f)
        out.append(v.tobytes() if isinstance(v, np.ndarray) else v)
    return tuple(out)


def check(ref, pool: reads_mod.Pool, stream: Stream, written: int,
          reads_per_chunk: int) -> dict:
    """Every written instance of a sampled read against the reference's
    records: one expectation per sampled read and distinct value of the
    context the reference depends on, each instance held to its own."""
    n = pool.n
    chunks = Chunks(pool, reads_per_chunk, written)
    compared = differing = expectations = 0
    shown: list[str] = []
    t0 = time.perf_counter()
    for j, i in enumerate(pool.sample.tolist()):
        want: dict[tuple, list] = {}
        for inst in range(i, written, n):
            ctx = chunks.instance(inst)
            key = context_key(ctx, ref.depends)
            if key not in want:
                want[key] = ref.records(pool.sample_codes[j], pool.quality,
                                        b"\0", ctx)
                expectations += 1
            name = pool.name(i, inst)
            exp = sorted(w.replace(b"\0", name, 1) for w in want[key])
            got = sorted(stream.kept.get(inst, []))
            compared += 1
            if exp != got:
                differing += 1
                if len(shown) < 3:
                    shown.append(f"read {inst}: expected {exp[:2]!r}, "
                                 f"got {got[:2]!r}"[:600])
    return {"compared": compared, "differing": differing, "shown": shown,
            "expectations": expectations,
            "seconds": time.perf_counter() - t0}


def make_inputs(args: dict):
    """(reference, pool, what it took): the configuration's genome, the
    state of the mix's reference, and the pool of the mix's draw."""
    t0 = time.perf_counter()
    cfg, traffic = args["config"], args["traffic"]
    genome, made_s = genome_mod.ensure(args["cache_dir"], cfg["genome"])
    ref_name = traffic["check"].get("reference", DEFAULT_REFERENCE)
    reference = spec_mod.module(args["root"], "references", ref_name)
    ref, built_s = reference.ensure(
        args["cache_dir"],
        os.path.join(args["cache_dir"], "references", ref_name), cfg, genome)
    bad = set(ref.depends) - set(CONTEXT)
    if bad:
        raise ValueError(f"reference {ref_name!r} depends on {sorted(bad)}; "
                         f"an instance has only {CONTEXT}")
    t1 = time.perf_counter()
    draw_name = traffic["reads"].get("draw", DEFAULT_DRAW)
    pool = spec_mod.module(args["root"], "draws", draw_name).draw(
        genome, ref.layout, int(cfg["mapper"]["bucket_len"]),
        traffic["reads"], args["seed"], traffic["check"]["sample_reads"])
    per_chunk = int(traffic["run"]["reads_per_chunk"])
    if per_chunk * pool.record > CHUNK_BYTES:
        raise ValueError(
            f"{per_chunk} reads of {pool.record} FASTQ bytes pass the "
            f"program's {CHUNK_BYTES}-byte chunk: its chunks would not be "
            f"cut by count; take fewer reads_per_chunk")
    return ref, pool, {"draw": draw_name, "reference": ref_name,
                       "genome_made_s": made_s, "reference_built_s": built_s,
                       "world_s": t1 - t0,
                       "pool_s": time.perf_counter() - t1,
                       "pool_reads": pool.n}


def main() -> int:
    # the threads that write the FASTQ and drain the SAM need the
    # interpreter only between system calls: hand it to them soon
    sys.setswitchinterval(2e-4)
    args = json.loads(sys.argv[1])
    ref, pool, info = make_inputs(args)
    os.sched_setaffinity(0, args["cores"])
    t0 = time.perf_counter()
    # zero-filled, so every page is touched here and not in the window
    sam_buf = bytearray(min(SAM_BUFFER_BYTES, 6 * pool.buf.nbytes))
    info["sam_buffer_s"] = time.perf_counter() - t0
    say({"event": "ready", **info})
    fifos = args["fifos"]
    written, stream = 0, None
    for line in sys.stdin:
        cmd = json.loads(line)["cmd"]
        if cmd == "warm":
            n, s, _ = run_stream(pool, fifos["warm_fastq"], fifos["warm_sam"],
                                 ref.names, None,
                                 int(args["traffic"]["run"]["warm_reads"]))
            say({"event": "warmed", "reads": n, "records": s.records})
        elif cmd == "window":
            written, stream, feed_s = run_stream(
                pool, fifos["fastq"], fifos["sam"], ref.names,
                float(args["seconds"]), None, sam_buf)
            sam_buf = None
            say({"event": "streamed", "written": written,
                 "records": stream.records,
                 "unknown": stream.unknown + int(stream.mapped[written:].sum()),
                 "mapped": int(stream.mapped[:written].sum()),
                 "correct": int(stream.correct[:written].sum()),
                 "feed_s": feed_s, "score_s": stream.score_s})
        elif cmd == "check":
            out = check(ref, pool, stream, written,
                        int(args["traffic"]["run"]["reads_per_chunk"]))
            out["event"] = "checked"
            say(out)
            break
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & {"jax", "jaxlib", "flax", "bucketmap_tpu",
                      "bucketmap_tpu_torch"})
    if found:
        print(f"[feeder] loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
