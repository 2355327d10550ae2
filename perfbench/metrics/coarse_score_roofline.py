"""coarse_score's share of its roofline: the least time of the window's
launches (roofline.coarse_score_call per launch, at the run's batch and
the index's occupancy table) over the profiler's time of the kernel."""

from core import roofline
from core.trace import kernel_total


def read(ctx):
    secs, calls = kernel_total(ctx["trace"], "coarse_score_kernel")
    if not calls or secs <= 0:
        return None
    m = ctx["mapper"]
    rows, words = ctx["occupancy_shape"]
    nbytes, nops = roofline.coarse_score_call(
        ctx["run"]["batch_size"], m["mapper_samples"], words, rows,
        m["query_seed"] - m["index_seed"] + 1)
    return 100.0 * roofline.least_seconds(calls * nbytes, calls * nops) / secs
