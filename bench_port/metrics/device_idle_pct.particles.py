"""100 x (1 - the union of the device's intervals / the wall time) over
the traced episode (torch.profiler, CUDA activity)."""

UNIT = "%"


def read(ctx):
    w = ctx.window
    if w.trace is None or not w.traced_s:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.traced_s)
