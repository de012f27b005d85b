"""High-level World API (subset).

Port of the part of box2d_tpu/api.py's World that the main paths use:
`create_body`, `create_polygon_shape`, `create_circle_shape`,
`create_capsule_shape`, `create_joint`, `compile`, `step`, `run`, `body_position`, `body_linear_velocity` and `state`. The
device is chosen once, at construction: the card (`"cuda"`) unless the
caller names another, as the CPU tests do with `World(device="cpu")`.
Without a CUDA device the default raises when the world is compiled; there
is no quiet move to the CPU. Every tensor of the world lives on that
device. `run` is a plain Python loop over steps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as g
from . import math2d as m
from . import types as t
from .builder import WorldBuilder
from .joints import joint_types_present
from .narrowphase import classes_for_shape_types
from .state import Capacity, WorldState
from .world import Step, StepStats, make_step


class World:
    """A scene wrapper around the functional step."""

    def __init__(self, def_: t.WorldDef | None = None, substeps: int = 4,
                 device="cuda"):
        self.builder = WorldBuilder(def_)
        self.substeps = substeps
        self.device = torch.device(device)
        self.state: WorldState | None = None
        self.capacity: Capacity | None = None
        self._step: Step | None = None

    def create_body(self, def_: t.BodyDef | None = None, **kw) -> int:
        self._building()
        return self.builder.create_body(def_, **kw)

    def create_polygon_shape(self, body: int, def_: t.ShapeDef,
                             geom: g.ShapeGeom) -> int:
        self._building()
        return self.builder.create_shape(body, def_, geom)

    def create_circle_shape(self, body, def_, center, radius) -> int:
        return self.create_polygon_shape(body, def_, g.circle(center, radius))

    def create_capsule_shape(self, body, def_, p1, p2, radius) -> int:
        return self.create_polygon_shape(body, def_,
                                         g.capsule(p1, p2, radius))

    def create_joint(self, def_) -> int:
        self._building()
        return self.builder.create_joint(def_)

    def _building(self):
        if self.state is not None:
            raise NotImplementedError(
                "creating entities after compile(): ROADMAP.md queue 11 "
                "(host API)")

    def compile(self, capacity: Capacity | None = None):
        if any(s["is_sensor"] for s in self.builder._shapes):
            raise NotImplementedError("sensors: ROADMAP.md queue 10")
        self.state, self.capacity = self.builder.build(capacity, self.device)
        classes = classes_for_shape_types(
            s["geom"].type for s in self.builder._shapes)
        jtypes = joint_types_present(j["_type"] for j in self.builder._joints)
        self._step = make_step(self.capacity, classes, self.substeps,
                               continuous=self.builder.def_.enable_continuous,
                               joint_types=jtypes)
        return self

    def step(self, dt: float = 1.0 / 60.0) -> WorldState:
        if self._step is None:
            self.compile()
        self.state = self._step(self.state, dt)
        return self.state

    def run(self, steps: int, dt: float = 1.0 / 60.0) -> WorldState:
        """Advance `steps` frames. All but the last skip event compaction
        (their events are overwritten unread); the last frame is a full step,
        so the returned events are what step() would give."""
        if self._step is None:
            self.compile()
        for i in range(steps):
            self.state = self._step(self.state, dt,
                                    light_events=i < steps - 1)
        return self.state

    @property
    def stats(self) -> StepStats:
        """Counters of the compiled step: steps, idle steps, CCD gate
        openings and device reads (host/device round trips)."""
        return self._step.stats

    def reset_stats(self) -> None:
        self._step.stats = StepStats()

    def body_position(self, body: int) -> np.ndarray:
        """Body origin position (ref: BodyAPI.GetPosition)."""
        b = self.state.bodies
        origin = b.center[body] - m.rot_vec(b.rot[body], b.local_center[body])
        return origin.cpu().numpy()

    def body_linear_velocity(self, body: int) -> np.ndarray:
        return self.state.bodies.v[body].cpu().numpy()
