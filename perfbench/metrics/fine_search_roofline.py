"""fine_search's share of its roofline: the least time of the window's
voted pairs (`MapStats.candidate_pairs`, of `reads_with_candidates`
reads; roofline.fine_search_pairs) over the profiler's time of the
kernel."""

from core import roofline
from core.trace import kernel_total


def read(ctx):
    secs, calls = kernel_total(ctx["trace"], "fine_search_kernel")
    st = ctx["stats"]
    if not calls or secs <= 0 or not st["candidate_pairs"]:
        return None
    nbytes, nops = roofline.fine_search_pairs(
        st["candidate_pairs"], st["reads_with_candidates"],
        ctx["mapper"]["locator_samples"])
    return 100.0 * roofline.least_seconds(nbytes, nops) / secs
