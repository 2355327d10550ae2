"""Seconds per million reads of the window that the SAM writer thread
spends writing formatted records to the SAM: the sum of the "sam_write"
stage of `BucketMapPipeline.stage`."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "sam_write")
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
