"""The main thread's CPU time inside the "dispatch" stage
(`MapStats.dispatch_cpu_seconds`) as a share of that stage's wall time
(the sum of its `BucketMapPipeline.stage` spans). A CUDA call that spins
while it waits for the device counts as CPU; the rest of the stage is
spent off the CPU, waiting for the interpreter lock or blocked in a
CUDA call."""


def read(ctx):
    cpu = ctx["stats"].get("dispatch_cpu_seconds")
    wall_ms = sum(ctx["clock"].durations_ms("pipeline", "dispatch"))
    if cpu is None or wall_ms <= 0:
        return None
    return 100.0 * cpu / (wall_ms / 1e3)
