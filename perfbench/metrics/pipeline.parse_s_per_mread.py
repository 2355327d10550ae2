"""Seconds per million reads of the window that the FASTQ reader thread
spends parsing its chunks (`parse_fastq`): the sum of the "parse" stage
of `BucketMapPipeline.stage`."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "parse")
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
