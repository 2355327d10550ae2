"""Host milliseconds of one dispatch cycle's "dispatch" stage (pack,
upload and the step's launches; `BucketMapPipeline.stage`), the mean
over every cycle of the window."""


def read(ctx):
    d = ctx["clock"].durations_ms("pipeline", "dispatch")
    return sum(d) / len(d) if d else None
