"""100 x the least time of K3's work (harness.roofline) / the device time
of the K3 window kernels, over the traced episode. The work is counted per
step from the state in the episode before it (the same episodes from the
same spawn): the live particles and their ordered neighbour pairs within
one diameter at the step's start, for each particle iteration."""

import re

from harness import roofline

UNIT = "%"
KERNELS = re.compile(r"\bwindow_kernel\b|\bwindow_small_kernel\b")


def count(driver, before, after):
    p = before.particles
    diameter = 2.0 * float(p.params.radius.reshape(-1)[0])
    return roofline.particle_neighbours(p.pos, p.alive, diameter)


def read(ctx):
    w = ctx.window
    counts = w.counts.get("k3_roofline_pct")
    if w.trace is None or counts is None:
        return None
    secs = sum(s for n, s in w.trace.kernels() if KERNELS.search(n))
    if secs <= 0:
        return None
    worlds = 1 if ctx.kind == "world" else ctx.cell["traffic_data"]["worlds"]
    iters = ctx.cell["config_data"]["iterations"]
    least = sum(roofline.k3_least_s(int(live), int(nb), worlds, iters)
                for live, nb in counts.tolist())
    return 100.0 * least / secs
