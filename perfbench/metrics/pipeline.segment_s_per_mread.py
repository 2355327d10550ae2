"""Seconds per million reads of the window that the main thread spends
segmenting its batches (segments, their sort and the dispatch bounds):
the sum of the "segment" stage of `BucketMapPipeline.stage`."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "segment")
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
