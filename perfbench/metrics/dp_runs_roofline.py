"""dp_runs' share of its roofline: the least time of the window's
runs-path DP sub-batches (their shapes from the aligner's counts over
the window, `program_counters`; bytes and operations from
`core/align_roofline.py`, the peaks from `core/roofline.py`) over the
profiler's time of `dp_runs_kernel`. Nothing where the aligner counts
no such shapes or the trace holds no launch."""

from core import align_roofline, roofline
from core.trace import kernel_total


def read(ctx):
    counts = ctx["program_counters"]
    if not counts or not counts.get("dp_launched_rows"):
        return None
    secs, calls = kernel_total(ctx["trace"], "dp_runs_kernel")
    if not calls or secs <= 0:
        return None
    nbytes, nops = align_roofline.dp_runs(counts)
    return 100.0 * roofline.least_seconds(nbytes, nops) / secs
