"""The main thread's seconds per million reads in align mode's aligned
emit: the pipeline's "align" spans (`BucketMapPipeline.stage`, once a
batch, around the DP sub-batches and the wait for the align-emit
thread), summed over the window, over the reads `map_fastq` mapped."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "align")
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
