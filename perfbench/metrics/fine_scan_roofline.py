"""fine_scan's share of its roofline: the least time of the window's
voted pairs (`MapStats.candidate_pairs`) over the profiler's time of the
kernel.

Each pair reads its bucket's packed row once, Wb words of 16 bases
(Wb = ceil((bucket_len + read_len) / 16), as build_index lays rows out), and
writes its two p * MAX_OCC int32 proposal rows; it looks at each of the
row's 16 * Wb - k + 1 k-mer positions at least once, one int32
operation a position. No count of target tests: a kernel that filters
may test fewer targets a position, never fewer positions."""

from core import roofline
from core.trace import kernel_total

MAX_OCC = 8


def read(ctx):
    secs, calls = kernel_total(ctx["trace"], "fine_scan_kernel")
    pairs = ctx["stats"]["candidate_pairs"]
    if not calls or secs <= 0 or not pairs:
        return None
    m = ctx["mapper"]
    wb = -(-(m["bucket_len"] + m["read_len"]) // 16)
    nbytes = pairs * (4 * wb + 2 * 4 * m["locator_samples"] * MAX_OCC)
    nops = pairs * (16 * wb - m["query_seed"] + 1)
    return 100.0 * roofline.least_seconds(nbytes, nops) / secs
