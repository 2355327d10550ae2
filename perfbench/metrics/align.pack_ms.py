"""Host milliseconds of the aligner's "pack" stage a DP sub-batch
(`BandedAligner.stage`: the query codes 2-bit packed by NumPy and
uploaded), the mean over every runs-path sub-batch of the window."""


def read(ctx):
    d = ctx["clock"].durations_ms("align", "pack")
    return sum(d) / len(d) if d else None
