"""The reader of `step.budget_grown_pct` fed a made context: the share of
the window's steps that grew past the lane budget, and nothing where the
program has no such counters."""

import pytest

from core import spec

from conftest import REPO

METRIC = "step.budget_grown_pct"


def _ctx(**counters):
    stats = {"num_reads": 2_000_000, "candidate_pairs": 8_000_000}
    stats.update(counters)
    return {"stats": stats}


def test_reader_of_the_grown_share():
    read = spec.reader(REPO, METRIC)
    assert read(_ctx(steps=125, grown_steps=120, split_steps=0)) == \
        pytest.approx(96.0)
    assert read(_ctx(steps=375, grown_steps=0, split_steps=250)) == 0.0
    # nothing without the counters (a program before them), or without
    # a step in the window
    assert read(_ctx()) is None
    assert read(_ctx(steps=125)) is None
    assert read(_ctx(steps=0, grown_steps=0, split_steps=0)) is None
