"""Host milliseconds of the aligner's "consume" stage a DP sub-batch
(`BandedAligner.stage`: the runs to CIGAR bytes, MAPQ and the quality
threshold, the handoff to the align-emit thread), the mean over every
runs-path sub-batch of the window."""


def read(ctx):
    d = ctx["clock"].durations_ms("align", "consume")
    return sum(d) / len(d) if d else None
