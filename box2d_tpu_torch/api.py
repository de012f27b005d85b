"""High-level World API mirroring the reference's facade
(ref: api/World.cs, api/Body.cs, api/Shape.cs, api/Joint.cs, api/Chain.cs).

Port of box2d_tpu/api.py's World: build a scene eagerly, `compile()`
freezes it to a WorldState and a step, `step()` / `run()` advance it, and
the accessors, setters, runtime creates and destroys, queries and hooks
read and write the state's tensors. The device is chosen once, at
construction: the card (`"cuda"`) unless the caller names another, as the
CPU tests do with `World(device="cpu")`. Without a CUDA device the default
raises when the world is compiled; there is no quiet move to the CPU.

A state that `step()` or `run()` returned is never changed afterwards:
every setter writes new tensors (a clone, then the lane), as the JAX
package's `.at[].set` does. A getter or a host-side decision reads the
device (one synchronisation each); a setter that walks the touching
contacts reads them once and loops on the host. Remaking the step (a new
geometry class, a sensor, the filter tier, a new joint type, a hook) only
builds a new `world.Step`; the state and the step's StepStats carry over.
The particle methods (destroy, force, join, split, stuck) edit the
particle tree the same way.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from . import geometry as g
from . import math2d as m
from . import queries
from . import types as t
from .builder import WorldBuilder
from .contact_solver import kernel_mode
from .joints import joint_types_present
from .narrowphase import build_static_table, classes_for_shape_types
from .particles import (G_RIGID, G_SOLID, P_BARRIER, P_COLOR_MIXING,
                        P_ELASTIC, P_POWDER, P_REPULSIVE, P_SPRING,
                        P_STATIC_PRESSURE, P_TENSILE, P_VISCOUS, P_WALL,
                        ParticleConfig, _point_shape_distance_batched)
from .sensors import sensor_shape_ids
from .state import (ALLOW_FAST_ROTATION, DYNAMIC, ENABLE_SLEEP, IS_BULLET,
                    LOCK_ANGULAR_Z, LOCK_LINEAR_X, LOCK_LINEAR_Y, Capacity,
                    WorldState)
from .world import Step, StepStats, _step_work, make_step


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _put(arr, lane, val):
    """A copy of arr with arr[lane] = val (the state is never written in
    place)."""
    out = arr.clone()
    if isinstance(val, (tuple, list, np.ndarray)):
        val = torch.as_tensor(np.asarray(val), dtype=arr.dtype,
                              device=arr.device)
    out[lane] = val
    return out


def _add(arr, lane, val):
    """A copy of arr with val added at arr[lane]."""
    out = arr.clone()
    out[lane] += val
    return out


def _leaves(obj):
    """Every tensor of a state tree (dataclasses, NamedTuples, tuples)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _leaves(x)


class World:
    """A mutable scene wrapper around the functional step."""

    def __init__(self, def_: t.WorldDef | None = None, substeps: int = 4,
                 device="cuda"):
        self.builder = WorldBuilder(def_)
        self.substeps = substeps
        self.device = torch.device(device)
        self.state: WorldState | None = None
        self.capacity: Capacity | None = None
        self._step: Step | None = None
        self._custom_filter = None
        self._pre_solve = None
        self._body_gen = self._shape_gen = self._joint_gen = None
        self._joint_user: dict = {}

    # -- handles (ref: include/ID.cs:4-50 generation-checked ids) ----------
    # A handle packs (lane, generation): lane in the low 20 bits, the lane's
    # generation above, the JAX package's layout, so the same integers are
    # valid in both. Builder-time handles carry generation 0 and equal the
    # raw lane index; once a lane is destroyed and reused, its generation
    # bumps and any old handle raises on use.

    _GEN_SHIFT = 20
    _LANE_MASK = (1 << 20) - 1

    def _decode(self, handle: int, gens, kind: str) -> int:
        lane = handle & self._LANE_MASK
        gen = handle >> self._GEN_SHIFT
        if gens is not None:
            if lane >= len(gens) or gens[lane] != gen:
                raise ValueError(
                    f"stale or invalid {kind} handle {handle} "
                    f"(lane {lane} is at generation "
                    f"{gens[lane] if lane < len(gens) else '?'}, "
                    f"handle carries {gen})")
        return lane

    def _bid(self, handle: int) -> int:
        return self._decode(int(handle), self._body_gen, "body")

    def _sid(self, handle: int) -> int:
        return self._decode(int(handle), self._shape_gen, "shape")

    def _jid(self, handle: int) -> int:
        return self._decode(int(handle), self._joint_gen, "joint")

    def _handle(self, lane: int, gens) -> int:
        if gens is None:
            return int(lane)
        return int(lane) | (int(gens[lane]) << self._GEN_SHIFT)

    # -- construction ------------------------------------------------------
    # Before compile(), entities append to the host-side builder. After
    # compile(), creates claim free capacity lanes (spare padding + lanes
    # recycled by destroys) and write the state's tensors.

    def create_body(self, def_: t.BodyDef | None = None, **kw) -> int:
        if self.state is None:
            return self.builder.create_body(def_, **kw)
        return self._spawn_body(def_, **kw)

    def create_shape(self, body: int, def_: t.ShapeDef,
                     geom: g.ShapeGeom) -> int:
        if self.state is None:
            return self.builder.create_shape(body, def_, geom)
        return self._spawn_shape(body, def_, geom)

    def create_polygon_shape(self, body: int, def_: t.ShapeDef,
                             geom: g.ShapeGeom) -> int:
        return self.create_shape(body, def_, geom)

    def create_circle_shape(self, body, def_, center, radius) -> int:
        return self.create_shape(body, def_, g.circle(center, radius))

    def create_capsule_shape(self, body, def_, p1, p2, radius) -> int:
        return self.create_shape(body, def_, g.capsule(p1, p2, radius))

    def create_segment_shape(self, body, def_, p1, p2) -> int:
        return self.create_shape(body, def_, g.segment(p1, p2))

    def create_chain(self, body: int, def_: t.ChainDef) -> list[int]:
        if self.state is None:
            return self.builder.create_chain(body, def_)
        # runtime: the builder's per-edge ChainSegment shapes through the
        # lane-spawning path (ref: api/Chain.cs:12-134)
        pts = [np.asarray(p, np.float32) for p in def_.points]
        n = len(pts)
        if n < 4:
            raise ValueError("chain needs at least 4 points")
        mats = list(def_.materials)
        ids = []

        def add(g1, p1, p2, g2, mat):
            sd = t.ShapeDef(material=mat, density=1.0, filter=def_.filter,
                            enable_sensor_events=def_.enable_sensor_events)
            sd.update_body_mass = False
            ids.append(self._spawn_shape(body, sd,
                                         g.chain_segment(p1, p2, g1, g2)))

        def mat(i):
            return mats[i % len(mats)] if len(mats) > 1 else mats[0]

        if def_.is_loop:
            for i in range(n):
                add(pts[(i - 1) % n], pts[i], pts[(i + 1) % n],
                    pts[(i + 2) % n], mat(i))
        else:
            for i in range(n - 3):
                add(pts[i], pts[i + 1], pts[i + 2], pts[i + 3], mat(i))
        return ids

    def create_joint(self, def_) -> int:
        if self.state is None:
            return self.builder.create_joint(def_)
        return self._spawn_joint(def_)

    def create_particle_system(self, radius: float, density: float = 1.0):
        return self.builder.create_particle_system(radius, density)

    # -- compile + step -----------------------------------------------------

    def compile(self, capacity: Capacity | None = None):
        pcfg = self._particle_config()
        self.state, self.capacity = self.builder.build(capacity, self.device)
        self._classes = classes_for_shape_types(
            s["geom"].type for s in self.builder._shapes)
        self._jtypes = joint_types_present(
            j["_type"] for j in self.builder._joints)
        self._sensors = sensor_shape_ids(self.builder._shapes)
        self._pcfg = pcfg
        # the solver path of the compile-time joint types, kept through
        # every remake (box2d_tpu/api.py:250-285, :1527-1529)
        self._mode = kernel_mode(self.capacity, self._jtypes)
        self._step = None
        self._remake_step()
        # --- entity lifecycle bookkeeping (ref: include/ID.cs generation
        # handles + src/IDPool.cs free lists) -----------------------------
        cap = self.capacity
        self._body_gen = np.zeros(cap.max_bodies, np.int64)
        self._shape_gen = np.zeros(cap.max_shapes, np.int64)
        self._joint_gen = np.zeros(cap.max_joints, np.int64)
        self._free_bodies = list(range(cap.max_bodies - 1,
                                       len(self.builder._bodies) - 1, -1))
        self._free_shapes = list(range(cap.max_shapes - 1,
                                       len(self.builder._shapes) - 1, -1))
        self._free_joints = list(range(cap.max_joints - 1,
                                       len(self.builder._joints) - 1, -1))
        # per-lane shape records (geometry + density + owner) for runtime
        # mass recomputes
        self._shape_recs = {
            i: {"geom": s["geom"], "density": s["density"],
                "body": s["body"]}
            for i, s in enumerate(self.builder._shapes)}
        return self

    def _remake_step(self):
        """A new Step for the current static configuration; its StepStats
        carry over."""
        old = self._step
        self._step = make_step(
            self.capacity, self._classes, self.substeps,
            continuous=self.builder.def_.enable_continuous,
            joint_types=self._jtypes, particle_cfg=self._pcfg,
            sensor_ids=self._sensors, mode=self._mode,
            custom_filter=self._custom_filter, pre_solve=self._pre_solve)
        if old is not None:
            self._step.stats = old.stats

    def _particle_config(self) -> ParticleConfig | None:
        """The particle step's static config, sized as box2d_tpu/api.py
        :168-244 sizes it (mbs, k_cull, depth_iterations, geom_types, one
        gate a particle flag and group type present). The window kernel is
        asked for always (the JAX package asks only on an accelerator with
        >= 2048 particles; particle_step takes it only where no gated pass
        needs the flat pair view or the pair / triad remap), and the rank
        repair from 2048 particles whatever the device, so that a CPU
        world and a CUDA world take the same branches."""
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

    # -- user hooks (ref: api/World.cs SetCustomFilterCallback /
    # SetPreSolveCallback; include/Types.cs:813,:827) -----------------------

    def set_custom_filter(self, fn) -> None:
        """Install a pair filter `fn(state, shape_a_ids, shape_b_ids) ->
        keep mask` (torch tensors), judged where candidate pairs are built
        (world.Hooks). Pass None to remove."""
        self._custom_filter = fn
        if self.state is not None:
            self._remake_step()
            self._mark_broadphase_dirty()

    def set_pre_solve(self, fn) -> None:
        """Install a pre-solve hook `fn(state, shape_a_ids, shape_b_ids,
        manifold) -> keep mask`, judged on the fresh manifolds every step:
        the one-way-platform hook (world.Hooks). Pass None to remove."""
        self._pre_solve = fn
        if self.state is not None:
            self._remake_step()

    def step(self, dt: float = 1.0 / 60.0) -> WorldState:
        if self._step is None:
            self.compile()
        self.state = self._step(self.state, dt)
        return self.state

    def run(self, steps: int, dt: float = 1.0 / 60.0,
            collect_events: bool = False):
        """Advance `steps` frames.

        collect_events=False: all but the last frame skip event compaction
        (their events are overwritten unread); the last frame is a full
        step, so the returned events are what step() would give. Returns
        the new state.
        collect_events=True: every frame is a full step, and its Events are
        returned stacked on a leading (steps,) axis, as the JAX package's
        scan returns them. Returns (state, events)."""
        if self._step is None:
            self.compile()
        if not collect_events:
            for i in range(steps):
                self.state = self._step(self.state, dt,
                                        light_events=i < steps - 1)
            return self.state
        frames = []
        for _ in range(steps):
            self.state = self._step(self.state, dt)
            frames.append(self.state.events)
        ev = frames[0]
        stacked = type(ev)(**{
            f.name: torch.stack([getattr(e, f.name) for e in frames])
            for f in dataclasses.fields(ev)})
        return self.state, stacked

    @property
    def stats(self) -> StepStats:
        """Counters of the compiled step (world.StepStats): steps, idle
        steps, CCD gate openings and TOI pairs, device reads (host/device
        round trips)."""
        return self._step.stats

    def reset_stats(self) -> None:
        self._step.stats = StepStats()

    # -- accessors (ref: api/Body.cs getters) -------------------------------

    def _origin(self, lane: int):
        b = self.state.bodies
        return b.center[lane] - m.rot_vec(b.rot[lane], b.local_center[lane])

    def _vec(self, v):
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def body_position(self, body: int) -> np.ndarray:
        """Body origin position (ref: BodyAPI.GetPosition)."""
        return _np(self._origin(self._bid(body)))

    def body_angle(self, body: int) -> float:
        lane = self._bid(body)
        r = self.state.bodies.rot[lane]
        return float(torch.atan2(r[1], r[0]))

    def body_linear_velocity(self, body: int) -> np.ndarray:
        return _np(self.state.bodies.v[self._bid(body)])

    def body_angular_velocity(self, body: int) -> float:
        return float(self.state.bodies.w[self._bid(body)])

    def body_transform(self, body: int):
        """(position, angle) of the body origin (ref: BodyAPI.GetTransform)."""
        return self.body_position(body), self.body_angle(body)

    def body_mass(self, body: int) -> float:
        return float(self.state.bodies.mass[self._bid(body)])

    def body_rotational_inertia(self, body: int) -> float:
        return float(self.state.bodies.inertia[self._bid(body)])

    def body_local_center(self, body: int) -> np.ndarray:
        return _np(self.state.bodies.local_center[self._bid(body)])

    def body_world_center(self, body: int) -> np.ndarray:
        return _np(self.state.bodies.center[self._bid(body)])

    def body_is_awake(self, body: int) -> bool:
        return bool(self.state.bodies.awake[self._bid(body)])

    def local_point(self, body: int, world_point):
        lane = self._bid(body)
        q = self.state.bodies.rot[lane]
        return _np(m.inv_rot_vec(q, self._vec(world_point)
                                 - self._origin(lane)))

    def world_point(self, body: int, local_point):
        lane = self._bid(body)
        return _np(m.transform_point(self._origin(lane),
                                     self.state.bodies.rot[lane],
                                     self._vec(local_point)))

    def local_vector(self, body: int, world_vector):
        lane = self._bid(body)
        return _np(m.inv_rot_vec(self.state.bodies.rot[lane],
                                 self._vec(world_vector)))

    def world_vector(self, body: int, local_vector):
        lane = self._bid(body)
        return _np(m.rot_vec(self.state.bodies.rot[lane],
                             self._vec(local_vector)))

    def world_point_velocity(self, body: int, world_point):
        """Velocity of a body-attached world point (ref:
        BodyAPI.GetWorldPointVelocity)."""
        lane = self._bid(body)
        bd = self.state.bodies
        r = self._vec(world_point) - bd.center[lane]
        return _np(bd.v[lane] + m.cross_sv(bd.w[lane], r))

    def local_point_velocity(self, body: int, local_point):
        """ref: BodyAPI.GetLocalPointVelocity."""
        return self.world_point_velocity(
            body, self.world_point(body, local_point))

    def body_mass_data(self, body: int) -> tuple:
        """(mass, local center, rotational inertia) (ref: GetMassData)."""
        lane = self._bid(body)
        bd = self.state.bodies
        return (float(bd.mass[lane]), _np(bd.local_center[lane]),
                float(bd.inertia[lane]))

    def body_motion_locks(self, body: int) -> tuple:
        fl = int(self.state.bodies.flags[self._bid(body)])
        return (bool(fl & LOCK_LINEAR_X), bool(fl & LOCK_LINEAR_Y),
                bool(fl & LOCK_ANGULAR_Z))

    def is_bullet(self, body: int) -> bool:
        return bool(int(self.state.bodies.flags[self._bid(body)])
                    & IS_BULLET)

    def body_user_data(self, body: int) -> int:
        return int(self.state.bodies.user_data[self._bid(body)])

    def body_shapes(self, body: int) -> list:
        """Shape handles attached to a body (ref: BodyAPI.GetShapes)."""
        lane = self._bid(body)
        sh = self.state.shapes
        on = _np((sh.body == lane) & sh.enabled)
        return [self._handle(i, self._shape_gen) for i in np.nonzero(on)[0]]

    def body_joints(self, body: int) -> list:
        """Joint handles attached to a body (ref: BodyAPI.GetJoints)."""
        lane = self._bid(body)
        jn = self.state.joints
        on = _np(((jn.body_a == lane) | (jn.body_b == lane))
                 & jn.enabled & (jn.type >= 0))
        return [self._handle(i, self._joint_gen) for i in np.nonzero(on)[0]]

    def body_contact_data(self, body: int) -> list:
        """Touching contacts involving the body (ref:
        BodyAPI.GetContactData): [(shape_a, shape_b, normal, points), ...]
        from contact_data's rows, shape ids as lanes. (The JAX package's
        version iterates contact_data's dict keys and raises; ROADMAP.md
        §3.)"""
        mine = {self._sid(h) for h in self.body_shapes(body)}
        d = self.contact_data()
        return [(int(sa), int(sb), d["normal"][i], d["point"][i])
                for i, (sa, sb) in enumerate(zip(d["shape_a"], d["shape_b"]))
                if int(sa) in mine or int(sb) in mine]

    def body_compute_aabb(self, body: int) -> np.ndarray:
        """Union AABB over the body's shapes (ref: BodyAPI.ComputeAABB)."""
        aabbs = [self.shape_aabb(s) for s in self.body_shapes(body)]
        if not aabbs:
            p = self.body_position(body)
            return np.concatenate([p, p])
        a = np.stack(aabbs)
        return np.concatenate([a[:, :2].min(0), a[:, 2:].max(0)])

    # -- mutators (post-compile, ref: api/Body.cs setters) -------------------

    def _replace(self, group: str, **cols):
        """A new state whose `group` (bodies, shapes, joints, ...) has
        these columns replaced."""
        self.state = dataclasses.replace(self.state, **{
            group: dataclasses.replace(getattr(self.state, group), **cols)})

    def _update_bodies(self, **cols):
        self._replace("bodies", **cols)

    def _wake_lane(self, lane: int):
        """Wake a body lane AND its island (ref: src/Body.cs:245-254
        WakeBody wakes the whole sleeping solver set). Internal callers
        pass the lane; the JAX package passes lanes to its handle-decoding
        wake_body and raises on recycled lanes (ROADMAP.md §3)."""
        bd = self.state.bodies
        label = bd.island_label[lane]
        mates = (bd.island_label == label) & (bd.type == DYNAMIC) & bd.enabled
        wake = mates.clone()
        wake[lane] = True
        self._update_bodies(awake=bd.awake | wake,
                            sleep_time=torch.where(wake, 0.0, bd.sleep_time))

    def wake_body(self, body: int):
        """Wake a body and its island (ref: src/Body.cs:245-254)."""
        self._wake_lane(self._bid(body))

    def set_linear_velocity(self, body: int, v):
        lane = self._bid(body)
        self._update_bodies(v=_put(self.state.bodies.v, lane, v))
        # ref: api/Body.cs:363 — a nonzero velocity wakes the body
        if float(np.hypot(*np.asarray(v, np.float32))) > 0:
            self._wake_lane(lane)

    def set_angular_velocity(self, body: int, w: float):
        lane = self._bid(body)
        if w != 0.0:
            self._wake_lane(lane)  # ref: api/Body.cs:374
        self._update_bodies(w=_put(self.state.bodies.w, lane, float(w)))

    def apply_force_to_center(self, body: int, force, wake=True):
        lane = self._bid(body)
        if wake:
            self._wake_lane(lane)
        self._update_bodies(force=_add(self.state.bodies.force, lane,
                                       self._vec(force)))

    def apply_linear_impulse_to_center(self, body: int, impulse, wake=True):
        lane = self._bid(body)
        if wake:
            self._wake_lane(lane)
        bd = self.state.bodies
        self._update_bodies(v=_add(bd.v, lane,
                                   self._vec(impulse) * bd.inv_mass[lane]))

    def apply_torque(self, body: int, torque: float, wake=True):
        lane = self._bid(body)
        if wake:
            self._wake_lane(lane)
        self._update_bodies(torque=_add(self.state.bodies.torque, lane,
                                        float(np.float32(torque))))

    def apply_force(self, body: int, force, point, wake=True):
        """Force at a world point: force + induced torque
        (ref: BodyAPI.ApplyForce)."""
        lane = self._bid(body)
        if wake:
            self._wake_lane(lane)
        bd = self.state.bodies
        f = self._vec(force)
        lever = self._vec(point) - bd.center[lane]
        self._update_bodies(force=_add(bd.force, lane, f),
                            torque=_add(bd.torque, lane, m.cross(lever, f)))

    def clear_forces(self, body: int):
        """ref: BodyAPI.ClearForces."""
        lane = self._bid(body)
        bd = self.state.bodies
        self._update_bodies(force=_put(bd.force, lane, 0.0),
                            torque=_put(bd.torque, lane, 0.0))

    def apply_angular_impulse(self, body: int, impulse: float, wake=True):
        lane = self._bid(body)
        bd = self.state.bodies
        self._update_bodies(
            w=_add(bd.w, lane, float(np.float32(impulse))
                   * bd.inv_inertia[lane]),
            awake=_put(bd.awake, lane, True))

    def apply_linear_impulse(self, body: int, impulse, point, wake=True):
        lane = self._bid(body)
        bd = self.state.bodies
        imp = self._vec(impulse)
        lever = self._vec(point) - bd.center[lane]
        self._update_bodies(
            v=_add(bd.v, lane, imp * bd.inv_mass[lane]),
            w=_add(bd.w, lane, bd.inv_inertia[lane] * m.cross(lever, imp)),
            awake=_put(bd.awake, lane, True))

    def set_mass_data(self, body: int, mass: float, center, inertia: float):
        """Override mass properties (ref: BodyAPI.SetMassData); the center
        of mass moves with the new local center."""
        lane = self._bid(body)
        bd = self.state.bodies
        lc = self._vec(center)
        new_center = self._origin(lane) + m.rot_vec(bd.rot[lane], lc)
        inv_m = 1.0 / mass if mass > 0 else 0.0
        inv_i = 1.0 / inertia if inertia > 0 else 0.0
        self._update_bodies(
            mass=_put(bd.mass, lane, float(mass)),
            inv_mass=_put(bd.inv_mass, lane, inv_m),
            inertia=_put(bd.inertia, lane, float(inertia)),
            inv_inertia=_put(bd.inv_inertia, lane, inv_i),
            local_center=_put(bd.local_center, lane, lc),
            center=_put(bd.center, lane, new_center))

    def apply_mass_from_shapes(self, body: int):
        """Recompute mass from attached shapes (ref: ApplyMassFromShapes)."""
        self._recompute_mass(self._bid(body))

    def _set_flag_bits(self, lane: int, clear: int, set_: int):
        bd = self.state.bodies
        fl = (int(bd.flags[lane]) & ~clear) | set_
        self._update_bodies(flags=_put(bd.flags, lane, fl))

    def set_body_motion_locks(self, body: int, lock_x=False, lock_y=False,
                              lock_rotation=False):
        """ref: BodyAPI.SetMotionLocks."""
        self._set_flag_bits(
            self._bid(body), LOCK_LINEAR_X | LOCK_LINEAR_Y | LOCK_ANGULAR_Z,
            (LOCK_LINEAR_X if lock_x else 0)
            | (LOCK_LINEAR_Y if lock_y else 0)
            | (LOCK_ANGULAR_Z if lock_rotation else 0))

    def set_bullet(self, body: int, flag: bool):
        """ref: BodyAPI.SetBullet."""
        self._set_flag_bits(self._bid(body), IS_BULLET,
                            IS_BULLET if flag else 0)

    def set_body_user_data(self, body: int, tag: int):
        lane = self._bid(body)
        self._update_bodies(user_data=_put(self.state.bodies.user_data, lane,
                                           int(tag)))

    def _set_body_col(self, body: int, name: str, v: float):
        bd = self.state.bodies
        self._update_bodies(**{name: _put(getattr(bd, name), self._bid(body),
                                          float(v))})

    def set_sleep_threshold(self, body: int, v: float):
        self._set_body_col(body, "sleep_threshold", v)

    def set_linear_damping(self, body: int, v: float):
        self._set_body_col(body, "linear_damping", v)

    def set_angular_damping(self, body: int, v: float):
        self._set_body_col(body, "angular_damping", v)

    def set_gravity_scale(self, body: int, v: float):
        self._set_body_col(body, "gravity_scale", v)

    def wake_touching(self, body: int):
        """Wake bodies touching this one (ref: BodyAPI.WakeTouching): the
        touching contacts are read once."""
        lane = self._bid(body)
        cs = self.state.contacts
        ka, kb, touch, owner = (_np(x) for x in (
            cs.key_a, cs.key_b, cs.touching, self.state.shapes.body))
        for k in np.nonzero(touch & (ka >= 0))[0]:
            ba = int(owner[ka[k]])
            bb = int(owner[kb[k]])
            if lane in (ba, bb):
                self._wake_lane(bb if ba == lane else ba)

    def set_target_transform(self, body: int, position, angle: float,
                             dt: float):
        """Kinematic drive: velocities that reach the target pose in dt
        (ref: BodyAPI.SetTargetTransform)."""
        lane = self._bid(body)
        origin = _np(self._origin(lane))
        r = _np(self.state.bodies.rot[lane])
        cur_a = float(np.arctan2(r[1], r[0]))
        dpos = (np.asarray(position, np.float32) - origin) / dt
        da = float(angle) - cur_a
        da = (da + np.pi) % (2 * np.pi) - np.pi
        self.set_linear_velocity(body, dpos)
        self.set_angular_velocity(body, da / dt)

    def set_transform(self, body: int, position, angle: float):
        """Teleport a body (ref: BodyAPI.SetTransform); the dirty flag
        forces a pair rebuild even when the whole world sleeps."""
        lane = self._bid(body)
        bd = self.state.bodies
        q = torch.tensor([math.cos(angle), math.sin(angle)],
                         dtype=torch.float32, device=self.device)
        center = self._vec(position) + m.rot_vec(q, bd.local_center[lane])
        self._update_bodies(center=_put(bd.center, lane, center),
                            rot=_put(bd.rot, lane, q))
        self._mark_broadphase_dirty()

    def set_body_enabled(self, body: int, enabled: bool):
        lane = self._bid(body)
        self._update_bodies(enabled=_put(self.state.bodies.enabled, lane,
                                         bool(enabled)))
        # enabling/disabling removes or restores the body's constraint
        # edges without a touch event: islands must re-partition
        self._mark_islands_dirty()

    # -- world tuning setters (ref: api/World.cs:628-807) --------------------

    def _update_tuning(self, **cols):
        def tensor(v):
            dt = torch.bool if isinstance(v, bool) else torch.float32
            return torch.as_tensor(np.asarray(v), dtype=dt,
                                   device=self.device)

        self._replace("tuning", **{k: tensor(v) for k, v in cols.items()})

    def set_gravity(self, gravity):
        self._update_tuning(gravity=gravity)

    def set_contact_tuning(self, hertz, damping_ratio, push_speed):
        self._update_tuning(contact_hertz=hertz,
                            contact_damping_ratio=damping_ratio,
                            contact_speed=push_speed)

    def set_restitution_threshold(self, v):
        self._update_tuning(restitution_threshold=v)

    def set_hit_event_threshold(self, v):
        self._update_tuning(hit_event_threshold=v)

    def set_maximum_linear_speed(self, v):
        self._update_tuning(max_linear_speed=v)

    def enable_sleep(self, flag: bool):
        self._update_tuning(enable_sleep=bool(flag))

    def enable_warm_starting(self, flag: bool):
        self._update_tuning(enable_warm_starting=bool(flag))

    def set_contact_softening(self, enabled: bool):
        """Toggle mass-ratio contact softening (ref: WorldDef
        enableContactSoftening, include/Types.cs:106)."""
        self._update_tuning(enable_contact_softening=bool(enabled))

    # -- joint accessors ------------------------------------------------------
    # Runtime typed get/setters (ref: api/Joint.cs:182-812) on the shared
    # parameter columns of state.Joints: lane writes, no remake, so an RL
    # loop can retarget motors every step.

    def _set_joint(self, joint: int, wake: bool = True, **fields):
        lane = self._jid(joint)
        jn = self.state.joints
        upd = {name: _put(getattr(jn, name), lane, val)
               for name, val in fields.items()}
        self._replace("joints", **upd)
        if wake:
            ends = torch.stack([jn.body_a[lane], jn.body_b[lane]])
            for bl in _np(ends).tolist():
                if bl >= 0:
                    self._wake_lane(bl)

    def joint_param(self, joint: int, field: str):
        """Read any joint parameter column (ref: the Joint_Get* surface)."""
        return _np(getattr(self.state.joints, field)[self._jid(joint)])

    def enable_joint_motor(self, joint: int, flag: bool):
        """ref: *Joint_EnableMotor."""
        self._set_joint(joint, enable_motor=bool(flag))

    def set_joint_motor_speed(self, joint: int, speed: float):
        """ref: *Joint_SetMotorSpeed (rad/s or m/s by type)."""
        self._set_joint(joint, motor_speed=float(speed))

    def set_joint_max_motor_force(self, joint: int, force: float):
        """ref: *Joint_SetMaxMotorForce / SetMaxMotorTorque."""
        self._set_joint(joint, max_motor_force=float(force))

    def enable_joint_limit(self, joint: int, flag: bool):
        """ref: *Joint_EnableLimit."""
        self._set_joint(joint, enable_limit=bool(flag))

    def set_joint_limits(self, joint: int, lower: float, upper: float):
        """ref: *Joint_SetLimits (angle/translation/length by type)."""
        self._set_joint(joint, lower=float(lower), upper=float(upper))

    def enable_joint_spring(self, joint: int, flag: bool):
        """ref: *Joint_EnableSpring."""
        self._set_joint(joint, enable_spring=bool(flag))

    def set_joint_spring_hertz(self, joint: int, hertz: float):
        """ref: *Joint_SetSpringHertz."""
        self._set_joint(joint, hertz=float(hertz))

    def set_joint_spring_damping_ratio(self, joint: int, zeta: float):
        """ref: *Joint_SetSpringDampingRatio."""
        self._set_joint(joint, damping_ratio=float(zeta))

    def set_joint_spring_target(self, joint: int, target: float):
        """ref: RevoluteJoint_SetTargetAngle / PrismaticJoint target."""
        self._set_joint(joint, spring_target=float(target))

    def set_joint_angular_spring(self, joint: int, hertz: float,
                                 zeta: float):
        """ref: WeldJoint_SetAngularHertz/DampingRatio, MotorJoint
        angular spring."""
        self._set_joint(joint, angular_hertz=float(hertz),
                        angular_damping_ratio=float(zeta))

    def set_distance_joint_length(self, joint: int, length: float):
        """ref: DistanceJoint_SetLength."""
        self._set_joint(joint, length=float(length))

    def set_distance_joint_spring_forces(self, joint: int, lower: float,
                                         upper: float):
        """ref: DistanceJoint_SetSpringForceRange."""
        self._set_joint(joint, lower_spring_force=float(lower),
                        upper_spring_force=float(upper))

    def set_motor_joint_velocity(self, joint: int, linear, angular: float):
        """ref: MotorJoint_SetLinearVelocity / SetAngularVelocity."""
        self._set_joint(joint, linear_velocity=tuple(linear),
                        angular_velocity=float(angular))

    def set_motor_joint_max_force(self, joint: int, force: float,
                                  torque: float):
        """ref: MotorJoint_SetMaxVelocityForce / Torque."""
        self._set_joint(joint, max_velocity_force=float(force),
                        max_velocity_torque=float(torque))

    def set_joint_thresholds(self, joint: int, force: float, torque: float):
        """ref: Joint_SetForceThreshold / SetTorqueThreshold (events)."""
        self._set_joint(joint, force_threshold=float(force),
                        torque_threshold=float(torque), wake=False)

    def set_joint_enabled(self, joint: int, flag: bool):
        """ref: Joint_SetEnabled (wakes both bodies either way). The
        stored graph color is cleared on every flip, as the JAX package
        clears it (box2d_tpu/api.py:972-983)."""
        self._set_joint(joint, enabled=bool(flag), color=-1)
        self._mark_islands_dirty()

    def set_mouse_target(self, joint: int, target):
        """Move a mouse joint's world target (ref: MouseJoint SetTarget)."""
        lane = self._jid(joint)
        jn = self.state.joints
        self._replace("joints",
                      frame_a_p=_put(jn.frame_a_p, lane, self._vec(target)))
        self._wake_lane(int(jn.body_b[lane]))

    def joint_constraint_force(self, joint: int, dt=1.0 / 60.0) -> float:
        """Approximate reaction force magnitude (ref: JointAPI
        GetConstraintForce), from the last step's stored impulse."""
        imp = _np(self.state.joints.impulse[self._jid(joint)])
        return float(np.hypot(*imp) / dt)

    def joint_bodies(self, joint: int) -> tuple:
        lane = self._jid(joint)
        jn = self.state.joints
        a, b = _np(torch.stack([jn.body_a[lane], jn.body_b[lane]])).tolist()
        return self._handle(a, self._body_gen), self._handle(b, self._body_gen)

    def _joint_frames_world(self, lane: int):
        jn = self.state.joints
        bd = self.state.bodies
        origin = bd.origin
        a = jn.body_a[lane].long()
        b = jn.body_b[lane].long()
        pa = m.transform_point(origin[a], bd.rot[a], jn.frame_a_p[lane])
        pb = m.transform_point(origin[b], bd.rot[b], jn.frame_b_p[lane])
        qa = m.rot_mul(bd.rot[a], jn.frame_a_q[lane])
        qb = m.rot_mul(bd.rot[b], jn.frame_b_q[lane])
        return pa, qa, pb, qb

    def distance_joint_current_length(self, joint: int) -> float:
        """ref: DistanceJoint_GetCurrentLength."""
        pa, _, pb, _ = self._joint_frames_world(self._jid(joint))
        return float(m.length(pb - pa))

    def revolute_joint_angle(self, joint: int) -> float:
        """ref: RevoluteJoint_GetAngle."""
        _, qa, _, qb = self._joint_frames_world(self._jid(joint))
        rel = m.rot_inv_mul(qa, qb)
        return float(torch.atan2(rel[1], rel[0]))

    def prismatic_joint_translation(self, joint: int) -> float:
        """ref: PrismaticJoint_GetTranslation (the wheel joint projects on
        the same axis, WheelJoint.cs:184)."""
        pa, qa, pb, _ = self._joint_frames_world(self._jid(joint))
        axis = m.rot_vec(qa, torch.tensor([1.0, 0.0], device=self.device))
        return float(m.dot(pb - pa, axis))

    wheel_joint_translation = prismatic_joint_translation

    def joint_linear_separation(self, joint: int) -> float:
        """Positional constraint error (ref: JointAPI.GetLinearSeparation
        for the point-to-point types)."""
        pa, _, pb, _ = self._joint_frames_world(self._jid(joint))
        return float(m.length(pb - pa))

    def joint_angular_separation(self, joint: int) -> float:
        """ref: JointAPI.GetAngularSeparation."""
        return self.revolute_joint_angle(joint)

    def joint_local_frames(self, joint: int) -> tuple:
        lane = self._jid(joint)
        jn = self.state.joints
        return (_np(jn.frame_a_p[lane]), _np(jn.frame_a_q[lane]),
                _np(jn.frame_b_p[lane]), _np(jn.frame_b_q[lane]))

    def set_joint_local_frames(self, joint: int, frame_a_p=None,
                               frame_b_p=None):
        """ref: JointAPI.SetLocalFrameA/B (anchor positions)."""
        fields = {}
        if frame_a_p is not None:
            fields["frame_a_p"] = tuple(frame_a_p)
        if frame_b_p is not None:
            fields["frame_b_p"] = tuple(frame_b_p)
        if fields:
            self._set_joint(joint, **fields)

    def joint_user_data(self, joint: int) -> int:
        # joints carry no user-data column; a host-side map
        return self._joint_user.get(self._jid(joint), 0)

    def set_joint_user_data(self, joint: int, tag: int):
        self._joint_user[self._jid(joint)] = int(tag)

    # -- shapes (ref: api/Shape.cs) -------------------------------------------

    def apply_wind_force(self, shape: int, wind, drag: float, lift: float,
                         air_density: float = 1.225, wake: bool = True):
        """Aerodynamic wind force on one shape (ref: api/Shape.cs:455-476
        ApplyWindForce; circle Collision.cs:172, capsule :353, polygon
        :608), computed on the host as box2d_tpu/api.py:1189-1269: only
        circle, segment and polygon shapes on dynamic bodies receive force;
        polygon edges are rotated to world before the wind crosses them."""
        lane = self._sid(shape)
        sh = self.state.shapes
        stype = int(sh.type[lane])
        if stype not in (g.CIRCLE, g.SEGMENT, g.POLYGON):
            return
        bi = int(sh.body[lane])
        b = self.state.bodies
        if int(b.type[bi]) != DYNAMIC:
            return
        if not bool(b.awake[bi]):
            if not wake:
                return
            self._wake_lane(bi)
            b = self.state.bodies
        c, s = (float(v) for v in _np(b.rot[bi]))
        R = np.array([[c, -s], [s, c]], np.float64)
        lc = _np(b.local_center[bi]).astype(np.float64)
        lever = R @ (_np(sh.centroid[lane]).astype(np.float64) - lc)
        w = float(b.w[bi])
        shape_vel = (_np(b.v[bi]).astype(np.float64)
                     + w * np.array([-lever[1], lever[0]]))
        rel = float(drag) * np.asarray(wind, np.float64) - shape_vel
        speed = float(np.hypot(*rel))
        if speed == 0.0:
            return
        direction = rel / speed

        def cr(a, b_):
            return a[0] * b_[1] - a[1] * b_[0]

        def csv(sc, v):
            return sc * np.array([-v[1], v[0]])

        mag0 = 0.5 * float(air_density) * speed * speed
        verts = _np(sh.verts[lane]).astype(np.float64)
        radius = float(sh.radius[lane])
        if stype == g.CIRCLE:
            force = mag0 * (2.0 * radius) * direction
            torque = cr(lever, force)
        elif stype == g.SEGMENT:
            d = R @ (verts[1] - verts[0])
            area = 2.0 * radius + abs(cr(d, direction))
            dl = np.hypot(*d)
            n = (np.array([-d[1], d[0]]) / dl) if dl > 0 else np.zeros(2)
            if np.dot(n, direction) > 0:
                n = -n
            lift_dir = csv(cr(n, direction), direction)
            force = mag0 * area * (direction + float(lift) * lift_dir)
            torque = cr(lever + radius * n, force)
        else:  # polygon: per windward edge (ref Collision.cs:604-617)
            count = int(sh.count[lane])
            force = np.zeros(2)
            torque = 0.0
            for i in range(count):
                v1 = verts[i - 1]
                v2 = verts[i]
                d = R @ (v2 - v1)
                area = cr(d, direction)
                if area <= 0:
                    continue
                dl = np.hypot(*d)
                n = np.array([d[1], -d[0]]) / dl  # right perp
                lift_dir = csv(cr(n, direction), direction)
                f = mag0 * area * (direction + float(lift) * lift_dir)
                edge_lever = R @ (0.5 * (v1 + v2) - lc)
                force = force + f
                torque += cr(edge_lever, f)
        self._update_bodies(
            force=_add(b.force, bi, self._vec(force)),
            torque=_add(b.torque, bi, float(np.float32(torque))))

    def test_point(self, shape: int, point) -> bool:
        """Point-in-shape test (ref: api/Shape.cs TestPoint)."""
        lane = self._sid(shape)
        return bool(queries.overlap_point(
            self.state, point, mask_bits=0xFFFFFFFF,
            category_bits=0xFFFFFFFF)[lane])

    def shape_aabb(self, shape: int) -> np.ndarray:
        """Current world AABB of a shape as (lo_x, lo_y, hi_x, hi_y)
        (ref: api/Shape.cs GetAABB)."""
        from .broadphase import compute_shape_aabbs

        return _np(compute_shape_aabbs(self.state)[self._sid(shape)])

    def _update_shapes(self, lane: int, **cols):
        sh = self.state.shapes
        upd = {k: _put(getattr(sh, k), lane, v) for k, v in cols.items()}
        sh = dataclasses.replace(sh, **upd)
        self._replace("shapes", **upd,
                      table=build_static_table(sh, self.capacity.max_verts))

    def shape_body(self, shape: int) -> int:
        lane = int(self.state.shapes.body[self._sid(shape)])
        return self._handle(lane, self._body_gen)

    def shape_friction(self, shape: int) -> float:
        return float(self.state.shapes.friction[self._sid(shape)])

    def set_friction(self, shape: int, v: float):
        """ref: ShapeAPI.SetFriction."""
        self._update_shapes(self._sid(shape), friction=float(v))

    def shape_restitution(self, shape: int) -> float:
        return float(self.state.shapes.restitution[self._sid(shape)])

    def set_restitution(self, shape: int, v: float):
        """ref: ShapeAPI.SetRestitution."""
        self._update_shapes(self._sid(shape), restitution=float(v))

    def shape_density(self, shape: int) -> float:
        return float(self.state.shapes.density[self._sid(shape)])

    def set_density(self, shape: int, v: float, update_mass: bool = True):
        """ref: ShapeAPI.SetDensity."""
        lane = self._sid(shape)
        self._update_shapes(lane, density=float(v))
        self._shape_recs[lane]["density"] = float(v)
        if update_mass:
            self._recompute_mass(self._shape_recs[lane]["body"])

    def set_surface_material(self, shape: int, friction=None,
                             restitution=None, rolling_resistance=None,
                             tangent_speed=None, user_material=None):
        """ref: ShapeAPI.SetSurfaceMaterial / SetUserMaterial."""
        lane = self._sid(shape)
        cols = {k: float(v) for k, v in (
            ("friction", friction), ("restitution", restitution),
            ("rolling_resistance", rolling_resistance),
            ("tangent_speed", tangent_speed)) if v is not None}
        if user_material is not None:
            cols["user_material"] = int(user_material)
        if cols:
            self._update_shapes(lane, **cols)

    def shape_surface_material(self, shape: int) -> dict:
        lane = self._sid(shape)
        sh = self.state.shapes
        keys = ("friction", "restitution", "rolling_resistance",
                "tangent_speed")
        vals = _np(torch.stack([getattr(sh, k)[lane] for k in keys]))
        out = {k: float(v) for k, v in zip(keys, vals)}
        out["user_material"] = int(sh.user_material[lane])
        return out

    def enable_shape_contact_events(self, shape: int, flag: bool):
        """ref: ShapeAPI.EnableContactEvents (post-compile)."""
        self._update_shapes(self._sid(shape),
                            enable_contact_events=bool(flag))

    def enable_shape_hit_events(self, shape: int, flag: bool):
        self._update_shapes(self._sid(shape), enable_hit_events=bool(flag))

    def enable_shape_sensor_events(self, shape: int, flag: bool):
        self._update_shapes(self._sid(shape),
                            enable_sensor_events=bool(flag))

    def shape_filter(self, shape: int) -> t.Filter:
        lane = self._sid(shape)
        sh = self.state.shapes
        return t.Filter(category_bits=int(sh.filter_category[lane]),
                        mask_bits=int(sh.filter_mask[lane]),
                        group_index=int(sh.filter_group[lane]))

    def shape_geometry(self, shape: int):
        """The host-side ShapeGeom record (ref: ShapeAPI.GetPolygon /
        GetCircle / GetCapsule / GetSegment / GetType)."""
        return self._shape_recs[self._sid(shape)]["geom"]

    def _shape_frame(self, lane: int):
        """The origin and rotation of a shape's body, each (1, 2)."""
        sh = self.state.shapes
        bi = sh.body[lane].long()
        return self.state.bodies.origin[bi][None], \
            self.state.bodies.rot[bi][None]

    def shape_ray_cast(self, shape: int, origin, translation):
        """Ray vs ONE shape in world space (ref: ShapeAPI.RayCast).
        Returns (hit, fraction, point, normal)."""
        lane = self._sid(shape)
        sh = self.state.shapes
        sp, sq = self._shape_frame(lane)
        lo = m.inv_rot_vec(sq, self._vec(origin)[None] - sp)
        ld = m.inv_rot_vec(sq, self._vec(translation)[None])
        sl = slice(lane, lane + 1)
        hit, frac, pt, nrm = queries.ray_shape_analytic(
            lo, ld, 1.0, sh.type[sl], sh.verts[sl], sh.normals[sl],
            sh.count[sl], sh.radius[sl])
        return (bool(hit[0]), float(frac[0]),
                _np(m.transform_point(sp, sq, pt))[0],
                _np(m.rot_vec(sq, nrm))[0])

    def shape_closest_point(self, shape: int, point) -> np.ndarray:
        """Closest point on the shape surface (ref: GetClosestPoint)."""
        lane = self._sid(shape)
        sh = self.state.shapes
        sp, sq = self._shape_frame(lane)
        sl = slice(lane, lane + 1)
        pos = self._vec(point)[None]
        dist, wn = _point_shape_distance_batched(
            pos, sp, sq, sh.verts[sl], sh.normals[sl], sh.count[sl],
            sh.radius[sl])
        return _np(pos[0] - torch.clamp(dist[0, 0], min=0.0) * wn[0, 0])

    # -- particles (host-side queries) ---------------------------------------

    def overlap_particles(self, lo, hi) -> np.ndarray:
        """Indices of alive particles inside an AABB (the callback-free
        analog of ref ParticleSystem.QueryAABB, particle/World.cs:64-76)."""
        pt = self.state.particles
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        pos = _np(pt.pos)
        inside = _np(pt.alive) & np.all((pos >= lo) & (pos <= hi), axis=1)
        return np.where(inside)[0]

    def cast_ray_particles(self, origin, translation):
        """Closest particle hit by a ray segment (callback-free analog of
        ref ParticleSystem.RayCast, particle/World.cs:78-98). Returns
        (index, fraction, point, normal); index -1 if no hit."""
        pt = self.state.particles
        o = np.asarray(origin, np.float64)
        d = np.asarray(translation, np.float64)
        r = float(pt.params.radius)
        pos = _np(pt.pos).astype(np.float64)
        alive = _np(pt.alive)
        # |o + t d - p|^2 = r^2
        q = o[None, :] - pos
        a = float(d @ d)
        b2_ = q @ d
        c_ = np.sum(q * q, axis=1) - r * r
        disc = b2_ * b2_ - a * c_
        ok = alive & (disc >= 0) & (a > 0)
        sq = np.sqrt(np.maximum(disc, 0.0))
        tt = np.where(ok, (-b2_ - sq) / max(a, 1e-12), np.inf)
        tt = np.where((tt >= 0) & (tt <= 1), tt, np.inf)
        i = int(np.argmin(tt))
        if not np.isfinite(tt[i]):
            return -1, 1.0, None, None
        point = o + tt[i] * d
        n = point - pos[i]
        nl = np.hypot(*n)
        n = n / nl if nl > 0 else np.array([0.0, 1.0])
        return i, float(tt[i]), point.astype(np.float32), n.astype(np.float32)

    # -- particles (post-compile edits; out of place) ------------------------

    def _update_particles(self, **cols):
        self.state = dataclasses.replace(
            self.state,
            particles=dataclasses.replace(self.state.particles, **cols))

    def destroy_particle(self, index: int):
        """Kill one particle (ref: ParticleSystem.DestroyParticle; the
        zombie flag and compaction become an alive-mask clear, as in
        box2d_tpu/api.py:999-1006)."""
        self._update_particles(
            alive=_put(self.state.particles.alive, index, False))

    def destroy_particles_in_aabb(self, lo, hi):
        """Kill every particle inside an AABB (box2d_tpu/api.py:1008-1016)."""
        pt = self.state.particles
        lo = torch.as_tensor(np.asarray(lo, np.float32), device=self.device)
        hi = torch.as_tensor(np.asarray(hi, np.float32), device=self.device)
        inside = ((pt.pos >= lo) & (pt.pos <= hi)).all(dim=1)
        self._update_particles(alive=pt.alive & ~inside)

    def apply_particle_force(self, index: int, force):
        """Add a user force to one particle for the next step
        (box2d_tpu/api.py:1018-1024)."""
        self._update_particles(force=_add(
            self.state.particles.force, index,
            torch.as_tensor(np.asarray(force, np.float32),
                            device=self.device)))

    def join_particle_groups(self, group_a: int, group_b: int) -> int:
        """Merge group_b into group_a, with spring pairs and elastic triads
        across the seam from the current positions (ref:
        ParticleSystem.JoinParticleGroups and the join filter of
        UpdatePairsAndTriads; box2d_tpu/api.py:1026-1125): the native
        builders run over both groups' live particles and only the pairs
        and triads that join a particle of each group are kept. The pair
        and triad columns grow; a solid result re-derives its depth."""
        from . import native
        from .particles import G_NEEDS_DEPTH, PARTICLE_STRIDE

        pt = self.state.particles
        group = _np(pt.group).copy()
        alive = _np(pt.alive)
        pos = _np(pt.pos)
        pflags = _np(pt.flags)
        in_a = (group == group_a) & alive
        in_b = (group == group_b) & alive
        group[in_b] = group_a
        gflags = _np(pt.group_flags).copy()
        gflags[group_a] |= gflags[group_b]
        if gflags[group_a] & G_SOLID:
            gflags[group_a] |= G_NEEDS_DEPTH
        gstrength = _np(pt.group_strength)
        strength = float(min(gstrength[group_a], gstrength[group_b]))

        idx = np.where(in_a | in_b)[0]
        d = 2.0 * float(pt.params.radius)
        new_pairs, new_triads = [], []
        if len(idx) >= 2:
            pts = pos[idx].astype(np.float32)
            from_b = in_b[idx]
            union_flags = int(np.bitwise_or.reduce(pflags[idx]))
            if union_flags & P_SPRING:
                la, lb, dist = native.build_pairs(pts, d * 1.2)
                for k in range(len(la)):
                    a, b_ = int(la[k]), int(lb[k])
                    if from_b[a] == from_b[b_]:
                        continue      # only seam-crossing connections
                    fl = int(pflags[idx[a]] | pflags[idx[b_]])
                    if fl & P_SPRING:
                        new_pairs.append((int(idx[a]), int(idx[b_]), fl,
                                          strength, float(dist[k])))
            if union_flags & P_ELASTIC:
                tri, rest = native.build_triads(pts, PARTICLE_STRIDE * d)
                for k in range(len(tri)):
                    ta, tb, tc = (int(v) for v in tri[k])
                    if from_b[ta] == from_b[tb] == from_b[tc]:
                        continue
                    fl = int(pflags[idx[ta]] | pflags[idx[tb]]
                             | pflags[idx[tc]])
                    if fl & P_ELASTIC:
                        new_triads.append((int(idx[ta]), int(idx[tb]),
                                           int(idx[tc]), fl, strength,
                                           rest[k, 0], rest[k, 1],
                                           rest[k, 2]))

        dev = self.device
        cols = {"group": torch.as_tensor(group, device=dev),
                "group_flags": torch.as_tensor(gflags, device=dev)}

        def grow(name, rows, dtype):
            new = torch.as_tensor(np.asarray(rows, dtype), device=dev)
            cols[name] = torch.cat([getattr(pt, name), new])

        if new_pairs:
            for j, (name, dtype) in enumerate((
                    ("pair_a", np.int32), ("pair_b", np.int32),
                    ("pair_flags", np.int32), ("pair_strength", np.float32),
                    ("pair_distance", np.float32))):
                grow(name, [p_[j] for p_ in new_pairs], dtype)
        if new_triads:
            for j, (name, dtype) in enumerate((
                    ("triad_a", np.int32), ("triad_b", np.int32),
                    ("triad_c", np.int32), ("triad_flags", np.int32),
                    ("triad_strength", np.float32))):
                grow(name, [t_[j] for t_ in new_triads], dtype)
            for j, name in ((5, "triad_pa"), (6, "triad_pb"),
                            (7, "triad_pc")):
                grow(name, np.stack([t_[j] for t_ in new_triads]),
                     np.float32)
        self._update_particles(**cols)
        return group_a

    def split_particle_group(self, group: int) -> list[int]:
        """Split a group into its connected components over current
        proximity (closer than a diameter), like ref SplitParticleGroup's
        contact-graph labelling (box2d_tpu/api.py:1127-1187): the largest
        component keeps `group`, each other one gets a new group id with
        the group's flags and strength. Returns every resulting id."""
        pt = self.state.particles
        garr = _np(pt.group).copy()
        alive = _np(pt.alive)
        pos = _np(pt.pos)
        members = np.where((garr == group) & alive)[0]
        if len(members) == 0:
            return [group]
        d = 2.0 * float(pt.params.radius)

        # union-find over a cell hash (cells of one diameter, 3 x 3 window)
        parent = {int(i): int(i) for i in members}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        cells: dict = {}
        for i in members:
            cells.setdefault((int(pos[i, 0] // d), int(pos[i, 1] // d)),
                             []).append(int(i))
        for (cx, cy), occupants in cells.items():
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    other = cells.get((cx + dx, cy + dy))
                    if other is None:
                        continue
                    for i in occupants:
                        for j in other:
                            if j > i and np.hypot(*(pos[i] - pos[j])) < d:
                                ri, rj = find(i), find(j)
                                if ri != rj:
                                    parent[ri] = rj
        comps: dict = {}
        for i in members:
            comps.setdefault(find(int(i)), []).append(int(i))
        ordered = sorted(comps.values(), key=len, reverse=True)
        gflags = _np(pt.group_flags)
        gstrength = _np(pt.group_strength)
        gids = [group]
        for comp in ordered[1:]:
            gid = len(gflags)
            gflags = np.append(gflags, gflags[group])
            gstrength = np.append(gstrength, gstrength[group])
            garr[comp] = gid
            gids.append(gid)
        dev = self.device
        self._update_particles(
            group=torch.as_tensor(garr, device=dev),
            group_flags=torch.as_tensor(gflags, device=dev),
            group_strength=torch.as_tensor(gstrength.astype(np.float32),
                                           device=dev))
        return gids

    def stuck_particles(self, threshold: int = 5) -> np.ndarray:
        """Indices of particles wedged against bodies: two or more body
        contacts for more than `threshold` steps in a row (ref:
        ParticleSystem.DetectStuckParticle and GetStuckCandidates;
        box2d_tpu/api.py:1326-1333)."""
        pt = self.state.particles
        return np.where(_np(pt.alive)
                        & (_np(pt.consecutive_contact_steps) > threshold))[0]

    def byte_count(self) -> int:
        """Device bytes held by the world state (ref: WorldAPI
        GetByteCount, api/World.cs:835-842)."""
        return sum(x.numel() * x.element_size() for x in _leaves(self.state))

    # -- dirty flags -------------------------------------------------------

    def _mark_islands_dirty(self):
        """Schedule an island label re-propagation: needed after host
        mutations that change the constraint-edge set without a begin/end
        touch event (joint enable/disable, body type flips, destroys)."""
        bd = self.state.bodies
        self._update_bodies(
            island_dirty=torch.ones((), dtype=torch.bool, device=self.device),
            island_fresh=torch.arange(bd.type.shape[0], dtype=torch.int32,
                                      device=self.device))

    def _mark_broadphase_dirty(self):
        """Force a pair-set rebuild next step: needed after mutations that
        change pair admissibility (filters, body type) rather than
        position."""
        if self.state.broadphase is not None:
            self._replace("broadphase", dirty=torch.ones(
                (), dtype=torch.bool, device=self.device))
        self._mark_islands_dirty()

    # -- runtime entity lifecycle (post-compile) ---------------------------

    def _spawn_body(self, def_: t.BodyDef | None = None, **kw) -> int:
        """Claim a free body lane and write its state (runtime analog of
        ref api/Body.cs:16-105 CreateBody)."""
        d = dataclasses.replace(def_ or t.BodyDef(), **kw)
        if not self._free_bodies:
            raise RuntimeError(
                "body capacity exhausted: no free lanes "
                f"(Capacity.max_bodies={self.capacity.max_bodies}); "
                "compile() with a larger capacity")
        lane = self._free_bodies.pop()
        flags = ((LOCK_LINEAR_X if d.lock_linear_x else 0)
                 | (LOCK_LINEAR_Y if d.lock_linear_y else 0)
                 | (LOCK_ANGULAR_Z if d.lock_angular_z else 0)
                 | (IS_BULLET if d.is_bullet else 0)
                 | (ALLOW_FAST_ROTATION if d.allow_fast_rotation else 0)
                 | (ENABLE_SLEEP if d.enable_sleep else 0))
        rot = np.array([math.cos(d.angle), math.sin(d.angle)], np.float32)
        b = self.state.bodies
        # shapeless dynamic body: unit mass (ref: src/Body.cs:262-270);
        # _recompute_mass refines once shapes attach
        dyn = 1.0 if d.type == t.DYNAMIC else 0.0
        cols = dict(
            center=np.asarray(d.position, np.float32), rot=rot,
            v=np.asarray(d.linear_velocity, np.float32),
            w=float(np.float32(d.angular_velocity)), force=0.0, torque=0.0,
            local_center=0.0, mass=dyn, inv_mass=dyn, inertia=0.0,
            inv_inertia=0.0, linear_damping=float(d.linear_damping),
            angular_damping=float(d.angular_damping),
            gravity_scale=float(d.gravity_scale), type=int(d.type),
            flags=flags, sleep_time=0.0,
            sleep_threshold=float(d.sleep_threshold), min_extent=1e8,
            max_extent=0.0, awake=bool(d.is_awake),
            enabled=bool(d.is_enabled), user_data=int(d.user_data))
        self._update_bodies(**{k: _put(getattr(b, k), lane, v)
                               for k, v in cols.items()})
        self._mark_broadphase_dirty()
        return self._handle(lane, self._body_gen)

    def _spawn_shape(self, body: int, def_: t.ShapeDef,
                     geom: g.ShapeGeom) -> int:
        """Claim a free shape lane, write geometry + materials and its
        packed static table row, and recompute the owner's mass (runtime
        analog of ref api/Shape.cs:8-24 + src/Body.cs:255-353)."""
        blane = self._bid(body)
        if not self._free_shapes:
            raise RuntimeError(
                "shape capacity exhausted: no free lanes "
                f"(Capacity.max_shapes={self.capacity.max_shapes})")
        V = max(2, min(self.capacity.max_verts, 8))
        if geom.count > V:
            raise ValueError(
                f"runtime shape has {geom.count} verts > compiled "
                f"Capacity.max_verts={self.capacity.max_verts}")
        lane = self._free_shapes.pop()
        d = def_
        mat = d.material
        verts8 = np.zeros((8, 2), np.float32)
        norms8 = np.zeros((8, 2), np.float32)
        verts8[:geom.count] = geom.verts[:geom.count]
        norms8[:geom.count] = geom.normals[:geom.count]
        g1 = np.zeros(2, np.float32) if geom.ghost1 is None else geom.ghost1
        g2 = np.zeros(2, np.float32) if geom.ghost2 is None else geom.ghost2
        # packed static table row (layout: narrowphase.build_static_table)
        row = np.concatenate([
            verts8[:V].reshape(-1), norms8[:V].reshape(-1),
            [geom.radius, geom.count, geom.type], g1, g2,
            [mat.friction, mat.restitution, mat.rolling_resistance,
             mat.tangent_speed, float(d.enable_contact_events),
             float(d.enable_hit_events), blane]]).astype(np.float32)
        sh = self.state.shapes
        cols = dict(
            body=blane, type=int(geom.type), verts=verts8, normals=norms8,
            count=int(geom.count), radius=float(np.float32(geom.radius)),
            centroid=np.asarray(geom.centroid, np.float32),
            ghost1=np.asarray(g1, np.float32),
            ghost2=np.asarray(g2, np.float32),
            friction=float(np.float32(mat.friction)),
            restitution=float(np.float32(mat.restitution)),
            rolling_resistance=float(np.float32(mat.rolling_resistance)),
            tangent_speed=float(np.float32(mat.tangent_speed)),
            user_material=int(mat.user_material_id),
            density=float(np.float32(d.density)),
            filter_category=int(d.filter.category_bits),
            filter_mask=int(d.filter.mask_bits),
            filter_group=int(d.filter.group_index),
            is_sensor=bool(d.is_sensor),
            enable_contact_events=bool(d.enable_contact_events),
            enable_hit_events=bool(d.enable_hit_events),
            enable_sensor_events=bool(d.enable_sensor_events),
            enabled=True, table=row)
        self._replace("shapes", **{k: _put(getattr(sh, k), lane, v)
                                   for k, v in cols.items()})
        self._shape_recs[lane] = {"geom": geom, "density": d.density,
                                  "body": blane}
        if d.update_body_mass:
            self._recompute_mass(blane)
        self._refresh_extents(blane)
        # a geometry class the step was not made for (or a new sensor)
        # needs a new step
        new_classes = classes_for_shape_types(
            [r["geom"].type for r in self._shape_recs.values()])
        remake = new_classes != self._classes
        self._classes = new_classes
        if d.is_sensor and d.enable_sensor_events:
            self._sensors = tuple(sorted(set(self._sensors) | {lane}))
            remake = True
        if remake:
            self._remake_step()
        self._mark_broadphase_dirty()
        self._wake_lane(blane)
        return self._handle(lane, self._shape_gen)

    def _spawn_joint(self, def_) -> int:
        """Claim a free joint lane (runtime analog of ref
        src/Joint.cs:181-296 CreateJoint)."""
        if not self._free_joints:
            raise RuntimeError(
                "joint capacity exhausted: no free lanes "
                f"(Capacity.max_joints={self.capacity.max_joints})")
        rec = dataclasses.asdict(def_) | {"_type": def_._type}
        rec["body_a"] = self._bid(rec["body_a"])
        rec["body_b"] = self._bid(rec["body_b"])
        lane = self._free_joints.pop()
        # the builder's def -> frames conversion on a 1-row builder
        tb = WorldBuilder(self.builder.def_)
        tb._joints = [rec]
        one = tb._build_joints(1, lambda a: torch.from_numpy(
            np.array(a)).to(self.device))
        jn = self.state.joints
        self._replace("joints", **{
            f.name: _put(getattr(jn, f.name), lane, getattr(one, f.name)[0])
            for f in dataclasses.fields(jn)})
        if def_._type not in self._jtypes:
            self._jtypes = frozenset(self._jtypes | {def_._type})
            self._remake_step()
        self._mark_islands_dirty()
        self._wake_lane(rec["body_a"])
        self._wake_lane(rec["body_b"])
        return self._handle(lane, self._joint_gen)

    def _mass_from_records(self, blane: int, flags: int):
        """(mass, local center, inertia about it, inv mass, inv inertia)
        of a dynamic body from its shape records (ref: src/Body.cs:255-353
        UpdateBodyMassData), in float64 as the JAX package sums them."""
        mass = 0.0
        mc = np.zeros(2)
        io = 0.0
        for rec in self._shape_recs.values():
            if rec["body"] != blane:
                continue
            md = g.compute_mass(rec["geom"], rec["density"])
            mass += md.mass
            mc = mc + md.mass * md.center
            io += md.rotational_inertia + md.mass * float(
                md.center @ md.center)
        lc = np.zeros(2)
        ic = inv_m = inv_i = 0.0
        if mass > 0:
            lc = mc / mass
            ic = io - mass * float(lc @ lc)
            inv_m = 1.0 / mass
            if ic <= 0 or flags & LOCK_ANGULAR_Z:
                ic = 0.0
            inv_i = 1.0 / ic if ic > 0 else 0.0
        else:
            mass, inv_m = 1.0, 1.0  # shapeless dynamic body: unit mass
        return mass, lc, ic, inv_m, inv_i

    def _write_mass(self, blane, mass, lc, ic, inv_m, inv_i, **extra):
        """Write mass data; the center moves with the local center, about
        the body's origin."""
        b = self.state.bodies
        o_rot = _np(torch.cat([self._origin(blane), b.rot[blane]]))
        origin = o_rot[:2].astype(np.float64)
        c, s = float(o_rot[2]), float(o_rot[3])
        new_center = origin + np.array([c * lc[0] - s * lc[1],
                                        s * lc[0] + c * lc[1]])
        self._update_bodies(
            mass=_put(b.mass, blane, float(np.float32(mass))),
            inertia=_put(b.inertia, blane, float(np.float32(ic))),
            inv_mass=_put(b.inv_mass, blane, float(np.float32(inv_m))),
            inv_inertia=_put(b.inv_inertia, blane, float(np.float32(inv_i))),
            local_center=_put(b.local_center, blane,
                              np.asarray(lc, np.float32)),
            center=_put(b.center, blane, np.asarray(new_center, np.float32)),
            **{k: _put(getattr(b, k), blane, v) for k, v in extra.items()})

    def _recompute_mass(self, blane: int):
        """ref: src/Body.cs:255-353 UpdateBodyMassData over the body's
        current shapes (lane records, not builder history)."""
        b = self.state.bodies
        ty, fl = _np(torch.stack([b.type[blane], b.flags[blane]])).tolist()
        if ty != DYNAMIC:
            return
        self._write_mass(blane, *self._mass_from_records(blane, fl))

    def _refresh_extents(self, blane: int):
        """Recompute min/max shape extents about the center of mass (used
        by sleep and continuous-collision gates, ref:
        src/Solver.cs:425-449)."""
        b = self.state.bodies
        lc = _np(b.local_center[blane])
        min_e, max_e = 1e8, 0.0
        for rec in self._shape_recs.values():
            if rec["body"] != blane:
                continue
            geom = rec["geom"]
            vs = geom.verts[:geom.count]
            max_e = max(max_e,
                        float(np.max(np.hypot(*(vs - lc).T))) + geom.radius)
            if geom.count >= 3:
                offs = [float((vs[i] - geom.centroid) @ geom.normals[i])
                        for i in range(geom.count)]
                min_e = min(min_e, min(offs) + geom.radius)
            else:
                min_e = min(min_e, geom.radius)
        self._update_bodies(
            min_extent=_put(b.min_extent, blane, float(np.float32(min_e))),
            max_extent=_put(b.max_extent, blane, float(np.float32(max_e))))

    def destroy_shape(self, shape: int, update_body_mass: bool = True):
        """Disable a shape and recycle its lane (ref: api/Shape.cs
        DestroyShape)."""
        lane = self._sid(shape)
        sh = self.state.shapes
        blane = int(sh.body[lane])
        self._replace("shapes", enabled=_put(sh.enabled, lane, False))
        self._shape_recs.pop(lane, None)
        if lane in self._sensors:
            self._sensors = tuple(i for i in self._sensors if i != lane)
            self._remake_step()
        self._shape_gen[lane] += 1
        self._free_shapes.append(lane)
        if update_body_mass:
            self._recompute_mass(blane)
            self._refresh_extents(blane)
        self._mark_broadphase_dirty()
        self._wake_lane(blane)

    def destroy_joint(self, joint: int):
        """Disable a joint and recycle its lane (ref: src/Joint.cs
        DestroyJointInternal, which wakes both bodies)."""
        lane = self._jid(joint)
        jn = self.state.joints
        ba, bb = _np(torch.stack([jn.body_a[lane], jn.body_b[lane]])).tolist()
        self._replace(
            "joints", enabled=_put(jn.enabled, lane, False),
            type=_put(jn.type, lane, -1), body_a=_put(jn.body_a, lane, -1),
            body_b=_put(jn.body_b, lane, -1), color=_put(jn.color, lane, -1))
        self._joint_gen[lane] += 1
        self._free_joints.append(lane)
        self._mark_islands_dirty()
        for bl in (ba, bb):
            if 0 <= bl < len(self._body_gen):
                self._wake_lane(bl)

    def destroy_body(self, body: int):
        """Destroy a body: its shapes and joints are destroyed with it and
        every lane is recycled with a bumped generation, so stale handles
        raise (ref: api/Body.cs:109-164 DestroyBody + include/ID.cs)."""
        lane = self._bid(body)
        jn = self.state.joints
        ja, jb, jen = (_np(x) for x in (jn.body_a, jn.body_b, jn.enabled))
        for jl in np.nonzero(jen & ((ja == lane) | (jb == lane)))[0]:
            self.destroy_joint(self._handle(int(jl), self._joint_gen))
        # destroy attached shapes (skip the per-shape mass recompute)
        for sl in [k for k, r in self._shape_recs.items()
                   if r["body"] == lane]:
            self.destroy_shape(self._handle(sl, self._shape_gen),
                               update_body_mass=False)
        bd = self.state.bodies
        self._update_bodies(
            enabled=_put(bd.enabled, lane, False),
            awake=_put(bd.awake, lane, False),
            v=_put(bd.v, lane, 0.0), w=_put(bd.w, lane, 0.0))
        self._body_gen[lane] += 1
        self._free_bodies.append(lane)
        self._mark_broadphase_dirty()

    def set_body_type(self, body: int, type_: int):
        """Change a body's type at runtime (ref: api/Body.cs:185-267
        SetType): mass data, velocities of a body made static, and every
        stored graph color released, as box2d_tpu/api.py:1673-1742 does.
        The body's origin is kept."""
        lane = self._bid(body)
        type_ = int(type_)
        if type_ == DYNAMIC:
            fl = int(self.state.bodies.flags[lane])
            mass_data = self._mass_from_records(lane, fl)
        else:
            mass_data = (0.0, np.zeros(2), 0.0, 0.0, 0.0)
        extra = {"type": type_}
        if type_ == 0:  # static bodies lose their velocity
            extra.update(v=0.0, w=0.0)
        self._write_mass(lane, *mass_data, **extra)
        # a type flip can invalidate persisted graph colors; release all
        st = self.state
        self.state = dataclasses.replace(
            st,
            contacts=dataclasses.replace(
                st.contacts, color=torch.full_like(st.contacts.color, -1)),
            joints=dataclasses.replace(
                st.joints, color=torch.full_like(st.joints.color, -1)))
        self._mark_broadphase_dirty()
        self._wake_lane(lane)

    def set_filter(self, shape: int, filter_: t.Filter):
        """Update a shape's collision filter at runtime (ref:
        api/Shape.cs:157-169 SetFilter: the next step re-pairs)."""
        lane = self._sid(shape)
        if not self.capacity.has_filters:
            # the step was made without filter checks (no shape had a
            # non-default filter at compile): turn them on, a new step
            self.capacity = dataclasses.replace(self.capacity,
                                                has_filters=True)
            self._remake_step()
        sh = self.state.shapes
        self._replace(
            "shapes",
            filter_category=_put(sh.filter_category, lane,
                                 int(filter_.category_bits)),
            filter_mask=_put(sh.filter_mask, lane, int(filter_.mask_bits)),
            filter_group=_put(sh.filter_group, lane,
                              int(filter_.group_index)))
        self._mark_broadphase_dirty()
        owner = _np(sh.body)
        self._wake_lane(int(owner[lane]))
        # wake the current touching partners, read once: a disappearing
        # contact does not take the wake-on-new-touch path
        cs = self.state.contacts
        sa, sb, touching = (_np(x) for x in (cs.key_a, cs.key_b,
                                             cs.touching))
        for k in np.where((sa >= 0) & touching
                          & ((sa == lane) | (sb == lane)))[0]:
            other = int(sb[k] if sa[k] == lane else sa[k])
            self._wake_lane(int(owner[other]))

    # -- queries (thin wrappers over box2d_tpu_torch.queries) -----------------

    def cast_ray_closest(self, origin, translation, **kw):
        return queries.cast_ray_closest(self.state, origin, translation, **kw)

    def cast_mover(self, p1, p2, radius, translation, **kw) -> float:
        """ref: api/World.cs:568 CastMover."""
        return float(queries.cast_mover(self.state, p1, p2, radius,
                                        translation, **kw))

    def collide_mover(self, p1, p2, radius, **kw):
        """ref: api/World.cs:617 CollideMover: collision planes for
        solve_planes."""
        return queries.collide_mover(self.state, p1, p2, radius, **kw)

    def overlap_aabb(self, aabb, **kw):
        return _np(queries.overlap_aabb(self.state, aabb, **kw))

    def cast_ray_all(self, origin, translation, max_hits: int = 16, **kw):
        """All hits along a ray, fraction-ascending (ref: api/World.cs:
        442-465). Returns a dict of arrays trimmed to the hit count."""
        r = queries.cast_ray_all(self.state, origin, translation, max_hits,
                                 **kw)
        n = int(r.count)
        return {"shape": _np(r.shape)[:n], "point": _np(r.point)[:n],
                "normal": _np(r.normal)[:n], "fraction": _np(r.fraction)[:n]}

    def overlap_point(self, point, **kw) -> np.ndarray:
        """Boolean mask of shapes containing a world point."""
        return _np(queries.overlap_point(self.state, point, **kw))

    def explode(self, position, radius, impulse_per_length, falloff=0.0):
        self.state = queries.explode(self.state, position, radius,
                                     impulse_per_length, falloff)

    # -- output: contacts, counters, events, profile ----------------------

    def _narrow(self, state):
        """The narrow phase of `state` at its current poses: the step's
        prefix, with a throwaway StepStats."""
        return _step_work(state, 1.0 / 60.0, self.capacity, self._classes,
                          self.substeps, self.builder.def_.enable_continuous,
                          StepStats(), until="narrow")

    def contact_data(self) -> dict:
        """Manifolds of all touching contacts (ref: api/Contact.cs:20-33
        GetData + api/Shape.cs GetContactData): the broadphase and narrow
        phase re-run on the CURRENT poses, as a dict of arrays over the
        touching pairs."""
        d = self._narrow(self.state)
        pc = _np(d.manifold.point_count)
        idx = np.nonzero(pc > 0)[0]
        return {
            "shape_a": _np(d.shape_a)[idx],
            "shape_b": _np(d.shape_b)[idx],
            "normal": _np(d.manifold.normal)[idx],
            "point": _np(d.manifold.point)[idx],
            "separation": _np(d.manifold.separation)[idx],
            "point_count": pc[idx],
            "normal_impulse": _np(d.normal_impulse)[idx],
            "tangent_impulse": _np(d.tangent_impulse)[idx],
        }

    def counters(self) -> dict:
        """ref: api/World.cs:817-834 GetCounters, read in one transfer."""
        st = self.state
        b = st.bodies
        i = lambda x: x.to(torch.int64).reshape(())  # noqa: E731
        vals = {
            "body_count": i(b.enabled.sum()),
            "shape_count": i(st.shapes.enabled.sum()),
            "joint_count": i((st.joints.enabled
                              & (st.joints.type >= 0)).sum()),
            "contact_count": i(st.contacts.touching.sum()),
            "pair_count": i(st.profile.pair_count),
            "color_count": i(st.profile.color_count),
            "events_dropped": i(st.profile.events_dropped),
            "awake_body_count": i((b.awake & b.enabled
                                   & (b.type == DYNAMIC)).sum()),
            "particle_count": (i(st.particles.alive.sum())
                               if st.particles is not None
                               else torch.zeros((), dtype=torch.int64,
                                                device=self.device)),
            "body_move_count": i(st.events.body_move_count),
            "fell_asleep_count": i(st.events.body_fell_asleep_count),
        }
        host = _np(torch.stack(list(vals.values()))).tolist()
        return dict(zip(vals, host))

    def validate(self, raise_on_error: bool = True) -> list:
        """State-invariant validation (the B2_VALIDATE analog; see
        validate.py). Returns the violation list; raises AssertionError when
        it is not empty unless raise_on_error=False."""
        from .validate import validate_world

        out = validate_world(self)
        if out and raise_on_error:
            raise AssertionError("state validation failed:\n  "
                                 + "\n  ".join(out))
        return out

    def profile_phases(self, n: int = 20) -> dict:
        """Per-phase step times in milliseconds (ref: include/Types.cs:
        378-403 Profile), by timing the prefixes of the step
        (world._step_work's `until=`) and differencing: phase_ms[k] =
        t(prefix k) - t(prefix k-1); "total" is the whole work step. On the
        card the times are CUDA-event device times, each the mean of n
        calls; on the CPU host times. The keys are the JAX package's where
        the same prefix exists, plus the port's "layout" (the color-bucket
        scatter and packing) and "kernel" (the solver kernel). Every call
        uses a throwaway StepStats; the world's state is not changed."""
        phases = ["aabbs", "pairs", "narrow", "colors", "prepare", "layout",
                  "kernel", "store", "events", "continuous", "finalize",
                  "sleep", ""]
        cuda = self.device.type == "cuda"
        s = self.state
        out = {}
        prev = 0.0
        for ph in phases:
            def f(ph=ph):
                return _step_work(
                    s, 1.0 / 60.0, self.capacity, self._classes,
                    self.substeps, self.builder.def_.enable_continuous,
                    StepStats(), until=ph, joint_types=self._jtypes,
                    sensor_ids=self._sensors, hooks=self._step.hooks)

            f()
            if cuda:
                torch.cuda.synchronize(self.device)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(n):
                    f()
                e1.record()
                e1.synchronize()
                ms = e0.elapsed_time(e1) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    f()
                ms = (time.perf_counter() - t0) / n * 1e3
            out[ph or "total"] = ms - prev if ph else ms
            prev = ms
        return out

    @property
    def profile(self):
        return self.state.profile

    @property
    def events(self):
        return self.state.events

    def body_move_events(self) -> list:
        """Reference-shaped BodyMoveEvent rows for the last step (ref:
        include/Types.cs:713-724; api/World.cs:283-290):
        [(body_handle, (x, y), (c, s), fell_asleep), ...]."""
        ev = self.state.events
        moved = _np(ev.body_moved)
        ids = np.nonzero(moved)[0]
        if ids.size == 0:
            return []
        b = self.state.bodies
        origin = _np(b.origin)
        rot = _np(b.rot)
        fell = _np(ev.body_fell_asleep)
        return [(self._handle(i, self._body_gen),
                 (float(origin[i, 0]), float(origin[i, 1])),
                 (float(rot[i, 0]), float(rot[i, 1])), bool(fell[i]))
                for i in ids]
