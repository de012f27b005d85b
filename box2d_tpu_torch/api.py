"""High-level World API (subset).

Port of the part of box2d_tpu/api.py's World that the main paths use:
`create_body`, `create_polygon_shape`, `create_circle_shape`,
`create_capsule_shape`, `create_joint`, `create_particle_system`,
`compile`, `step`, `run`, `body_position`, `body_linear_velocity` and
`state`. The device is chosen once, at construction: the card (`"cuda"`)
unless the caller names another, as the CPU tests do with
`World(device="cpu")`.
Without a CUDA device the default raises when the world is compiled; there
is no quiet move to the CPU. Every tensor of the world lives on that
device. `run` is a plain Python loop over steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry as g
from . import math2d as m
from . import types as t
from .builder import WorldBuilder
from .joints import joint_types_present
from .narrowphase import classes_for_shape_types
from .particles import (G_RIGID, G_SOLID, P_BARRIER, P_COLOR_MIXING,
                        P_ELASTIC, P_POWDER, P_REPULSIVE, P_SPRING,
                        P_STATIC_PRESSURE, P_TENSILE, P_VISCOUS, P_WALL,
                        ParticleConfig, unported)
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

    def create_particle_system(self, radius: float, density: float = 1.0):
        self._building()
        return self.builder.create_particle_system(radius, density)

    def _building(self):
        if self.state is not None:
            raise NotImplementedError(
                "creating entities after compile(): ROADMAP.md queue 11 "
                "(host API)")

    def compile(self, capacity: Capacity | None = None):
        if any(s["is_sensor"] for s in self.builder._shapes):
            raise NotImplementedError("sensors: ROADMAP.md queue 10")
        pcfg = self._particle_config()
        if pcfg is not None:
            n_shapes = (capacity or self.builder.default_capacity()).max_shapes
            why = unported(pcfg, n_shapes)
            if why is not None:
                raise NotImplementedError(why)
        self.state, self.capacity = self.builder.build(capacity, self.device)
        classes = classes_for_shape_types(
            s["geom"].type for s in self.builder._shapes)
        jtypes = joint_types_present(j["_type"] for j in self.builder._joints)
        self._step = make_step(self.capacity, classes, self.substeps,
                               continuous=self.builder.def_.enable_continuous,
                               joint_types=jtypes, particle_cfg=pcfg)
        return self

    def _particle_config(self) -> ParticleConfig | None:
        """The particle step's static config, sized as box2d_tpu/api.py
        :168-244 sizes it (mbs, k_cull, depth_iterations, geom_types). The
        window kernel is always on (the JAX package turns it on only on an
        accelerator with >= 2048 particles), and the rank repair is on from
        2048 particles whatever the device, so that a CPU world and a CUDA
        world take the same branches."""
        pb = self.builder._particle_builder
        if pb is None:
            return None
        allf = 0
        for f in pb.flags:
            allf |= int(f)
        allg = 0
        for f in pb.group_flags:
            allg |= int(f)
        shapes = self.builder._shapes
        n_near = 0
        if pb.pos:
            ppos = np.asarray(pb.pos, np.float32)
            lo = ppos.min(0)
            hi = ppos.max(0)
            margin = 0.5 * float(np.max(hi - lo)) + 2.0
            for s in shapes:
                geom = s["geom"]
                v = geom.verts[:max(int(geom.count), 1)]
                p0 = np.asarray(self.builder._bodies[s["body"]]["position"],
                                np.float32)
                slo = p0 + v.min(0) - geom.radius
                shi = p0 + v.max(0) + geom.radius
                if (shi >= lo - margin).all() and (slo <= hi + margin).all():
                    n_near += 1
        mbs = int(min(max(16, 2 * n_near), 2048, max(len(shapes), 1)))
        n_part = max(len(pb.flags), 1)
        k_cull = int(min(mbs, max(8, 3 * n_near * 256 // (2 * n_part) + 4)))
        k_cull = (k_cull + 3) // 4 * 4
        return ParticleConfig(
            has_barrier=bool(allf & P_BARRIER),
            has_viscous=bool(allf & P_VISCOUS),
            has_repulsive=bool(allf & P_REPULSIVE),
            has_powder=bool(allf & P_POWDER),
            has_tensile=bool(allf & P_TENSILE),
            has_colormix=bool(allf & P_COLOR_MIXING),
            has_static_pressure=bool(allf & P_STATIC_PRESSURE),
            has_elastic=bool(allf & P_ELASTIC),
            has_spring=bool(allf & P_SPRING),
            has_wall=bool(allf & P_WALL),
            has_solid=bool(allg & G_SOLID),
            has_rigid=bool(allg & G_RIGID),
            depth_iterations=max(16, int(math.isqrt(n_part)) + 1),
            use_window_kernel=True,
            rank_repair=len(pb.flags) >= 2048,
            max_body_shapes=mbs,
            block_shape_slots=k_cull,
            geom_types=frozenset(int(s["geom"].type) for s in shapes),
        )

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
