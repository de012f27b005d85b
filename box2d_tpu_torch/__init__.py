"""box2d_tpu_torch — the PyTorch / CUDA port of box2d_tpu.

A second package beside the JAX reference `box2d_tpu`, written for one
NVIDIA H100: plain tensor code is PyTorch, and each Pallas TPU kernel of
the reference becomes a kernel written by hand for Hopper (csrc/). The
port imports torch and numpy, never jax. It steps rigid worlds of
circles, capsules and polygons with joints (the pyramid and joint_farm
main paths), on the card unless the caller asks for the CPU; see
ROADMAP.md for what is still to port.
"""

__version__ = "0.1.0"

from . import constants, geometry, math2d  # noqa: F401
