"""Seconds per million reads of the window that the SAM writer thread
spends merging each read's locations into sorted record arrays: the sum
of the "merge" stage of `BucketMapPipeline.stage`."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "merge")
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
