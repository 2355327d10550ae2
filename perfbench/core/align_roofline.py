"""The yardstick of the fused DP kernel `dp_runs` (the align stage's
runs path): the bytes and operations of its launches, from the shapes
that the pipeline aligner counts (`BandedAligner.counts`, summed over
its runs-path sub-batches).

Frozen from the port's chip_smoke.py `runs_bound`: per launch of P
padded pairs, a text width W, a query width Q and MR kept runs a row,
the inputs once (P * W text and P * Q query bytes, 8 bytes of length
and width a pair), the five head words and the MR runs of every pair
out; DP_OPS_PER_CELL int operations per cell of the rows the traceback
can reach (min(qlen, Q) a pair) across the band. The peaks are
`core/roofline.py`'s.
"""

from __future__ import annotations

DP_OPS_PER_CELL = 15


def dp_runs(counts: dict) -> tuple[float, float]:
    """(bytes, int ops) of the dp_runs launches that `counts` sums."""
    rows = counts["dp_launched_rows"]
    nbytes = (counts["dp_row_text"] + counts["dp_row_query"] + 8 * rows
              + 5 * 4 * rows + 4 * counts["dp_row_runs"])
    return float(nbytes), float(counts["dp_row_band"] * DP_OPS_PER_CELL)
