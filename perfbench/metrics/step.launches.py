"""Kernel launches per batch step: every kernel the profiler saw in the
window, torch's own and the program's, over the window's steps."""


def read(ctx):
    steps = len(ctx["clock"].durations_ms("step", "pack"))
    launches = sum(ctx["trace"]["launches"].values())
    return launches / steps if steps and launches else None
