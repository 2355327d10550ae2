"""Seconds per million reads of the window that the main thread waits
for the SAM writer thread: the sum of the "handoff" stage (a location
chunk put on the writer's queue) and the "drain" stage (the wait for the
writer to finish a batch) of `BucketMapPipeline.stage`."""


def read(ctx):
    clock = ctx["clock"]
    d = (clock.durations_ms("pipeline", "handoff")
         + clock.durations_ms("pipeline", "drain"))
    reads = ctx["reads"]
    return sum(d) / 1e3 / (reads / 1e6) if d and reads else None
