"""Share of the window's batch steps that grew past the step's fixed lane
budget: `MapStats.grown_steps` (single-device steps whose valid lanes
exceeded `DeviceMapper.lane_budget`, so that they voted past it) over
`MapStats.steps` (every step dispatched, split retries included). A
program without these counters reports nothing."""


def read(ctx):
    steps = ctx["stats"].get("steps")
    grown = ctx["stats"].get("grown_steps")
    if not steps or grown is None:
        return None
    return 100.0 * grown / steps
