"""Device reads per step (StepStats.syncs, counted by the port where each
read happens) over the traced episode."""

UNIT = "reads/step"


def read(ctx):
    w = ctx.window
    if not w.traced_steps:
        return None
    return w.traced_stats["syncs"] / w.traced_steps
