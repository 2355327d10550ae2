"""Seconds per million reads of the window that the main thread waits
for the FASTQ reader's next ReadBatch, or for the stream's end: the sum
of the "wait_reads" stage of `BucketMapPipeline.stage`."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "wait_reads")
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
