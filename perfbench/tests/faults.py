"""Faults planted under a CPU rehearsal of a run, each of which the
check has to catch, and probes that make or record what a test of the
harness needs: each is given the program's pipeline as it is built
(rehearse.py)."""

import json
import os


def _wrap_decode(pipe, change):
    decode = pipe.device.decode_out

    def decode_out(vec):
        return change(decode(vec))
    pipe.device.decode_out = decode_out


def half_batch_left_out(pipe):
    """The step's answers for the second half of every batch dropped."""
    half = pipe.batch_size // 2

    def change(out):
        keep = out["lane_read"] < half
        for k in ("lane_read", "lane_rc", "lane_bucket", "offset", "votes"):
            out[k] = out[k][keep]
        return out
    _wrap_decode(pipe, change)


def answer_altered(pipe):
    """Every voted offset one base off where the step produces it."""
    def change(out):
        out["offset"] = out["offset"] + 1
        return out
    _wrap_decode(pipe, change)


FAULTS = {"half_batch_left_out": half_batch_left_out,
          "answer_altered": answer_altered}


def chunk_shifted(pipe):
    """The program's records made to depend on their chunk: in each
    map_fastq call, every voted offset of the odd chunks one base on."""
    state = {"chunk": 0}
    map_batch, map_fastq = pipe._map_batch, pipe.map_fastq

    def _map_batch(*args, **kw):
        try:
            return map_batch(*args, **kw)
        finally:
            state["chunk"] += 1

    def _map_fastq(*args, **kw):
        state["chunk"] = 0
        return map_fastq(*args, **kw)

    def change(out):
        out["offset"] = out["offset"] + state["chunk"] % 2
        return out
    pipe._map_batch = _map_batch
    pipe.map_fastq = _map_fastq
    _wrap_decode(pipe, change)


def aligner_window_counts(pipe):
    """After each map_fastq call, the aligner's counts over the call
    written as JSON to the file that PERFBENCH_TEST_COUNTS names: the
    last call's, the window's, stay."""
    map_fastq = pipe.map_fastq

    def _map_fastq(*args, **kw):
        before = dict(pipe.aligner.counts)
        try:
            return map_fastq(*args, **kw)
        finally:
            with open(os.environ["PERFBENCH_TEST_COUNTS"], "w") as f:
                json.dump({k: v - before[k]
                           for k, v in pipe.aligner.counts.items()}, f)
    pipe.map_fastq = _map_fastq


PROBES = {"chunk_shifted": chunk_shifted,
          "aligner_window_counts": aligner_window_counts}
