"""Kernels the profiler saw on the device in the traced episode, per step
(the reset's copies are not kernels)."""

UNIT = "kernels/step"


def read(ctx):
    w = ctx.window
    if w.trace is None or not w.traced_steps:
        return None
    return len(w.trace.kernels()) / w.traced_steps
