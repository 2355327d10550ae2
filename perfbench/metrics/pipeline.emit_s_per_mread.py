"""The SAM writer's seconds per million reads of the window: the
program's own `MapStats.output_seconds` (the writer thread's merge,
format and write) over the reads that `map_fastq` mapped."""


def read(ctx):
    reads = ctx["reads"]
    return ctx["stats"]["output_seconds"] / (reads / 1e6) if reads else None
