"""box2d_tpu_torch — the PyTorch / CUDA port of box2d_tpu.

A second package beside the JAX reference `box2d_tpu`, written for one
NVIDIA H100: plain tensor code is PyTorch, and each Pallas TPU kernel of
the reference becomes a kernel written by hand for Hopper (csrc/). The
port imports torch and numpy, never jax. It steps rigid worlds of
circles, capsules, segments, chains and polygons with joints, continuous
collision and sensors, and LiquidFun particle systems (every particle
flag, spring, elastic and barrier groups, solid and rigid groups), on the
card unless the caller asks for the CPU; `api.World` carries the reference's
host API (runtime create and destroy, setters, hooks, events) and
`queries` its scene queries. See ROADMAP.md for what is still to port.
"""

__version__ = "0.1.0"

from . import constants, geometry, math2d  # noqa: F401
