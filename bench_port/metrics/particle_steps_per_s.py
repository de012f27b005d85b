"""Live particles x steps completed, over the whole window's wall time,
resets included (host clock)."""

UNIT = "particle-steps/s"


def read(ctx):
    w = ctx.window
    return ctx.units * w.steps / w.seconds
