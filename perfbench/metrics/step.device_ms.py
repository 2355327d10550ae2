"""Device milliseconds of kernels per batch step: the profiler's kernel
time over the window, over the window's steps (each step ends in one
`DeviceMapper.stage("pack")`)."""


def read(ctx):
    steps = len(ctx["clock"].durations_ms("step", "pack"))
    kernel_s = sum(ctx["trace"]["kernel_s"].values())
    return 1e3 * kernel_s / steps if steps and kernel_s else None
