"""From the process's start to the first timed step (host clock):
imports, the scene, the seed's worlds and the warm episode, with the
kernel builds in a checkout's first run."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
