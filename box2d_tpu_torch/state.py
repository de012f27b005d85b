"""WorldState: the whole simulation state as dataclasses of torch tensors.

Mirror of box2d_tpu/state.py (same classes, same fields, same dtypes and
shapes), so a state can move between the two packages leaf by leaf:
`state_to_numpy` flattens any such dataclass tree to a dict keyed by dotted
field path ("bodies.center", ...) and `state_from_numpy` rebuilds the torch
tree from such a dict on a given device. Every tensor of one state lives on
one device; functions of the port take it from the tensors they are given.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Body types (ref: include/Types.cs BodyType)
STATIC = 0
KINEMATIC = 1
DYNAMIC = 2

# Body flag bits (subset of ref: src/Body.cs BodyFlags)
LOCK_LINEAR_X = 1
LOCK_LINEAR_Y = 2
LOCK_ANGULAR_Z = 4
IS_BULLET = 8
ALLOW_FAST_ROTATION = 16
ENABLE_SLEEP = 32

# Joint types
JOINT_DISTANCE = 0
JOINT_MOTOR = 1
JOINT_PRISMATIC = 2
JOINT_REVOLUTE = 3
JOINT_WELD = 4
JOINT_WHEEL = 5
JOINT_FILTER = 6
JOINT_MOUSE = 7


@dataclasses.dataclass
class Bodies:
    """Dense body state; lane i is body id i (see box2d_tpu/state.py)."""

    center: Any
    rot: Any
    v: Any
    w: Any
    force: Any
    torque: Any
    local_center: Any
    inv_mass: Any
    inv_inertia: Any
    mass: Any
    inertia: Any
    linear_damping: Any
    angular_damping: Any
    gravity_scale: Any
    type: Any
    flags: Any
    sleep_time: Any
    sleep_threshold: Any
    min_extent: Any
    max_extent: Any
    island_label: Any
    island_fresh: Any
    island_dirty: Any
    island_split_pending: Any
    awake: Any
    enabled: Any
    user_data: Any

    @property
    def origin(self):
        """Body origin p = center - R*local_center (ref: src/Solver.cs:429)."""
        from . import math2d as m

        return self.center - m.rot_vec(self.rot, self.local_center)


@dataclasses.dataclass
class Shapes:
    body: Any
    type: Any
    verts: Any
    normals: Any
    count: Any
    radius: Any
    centroid: Any
    ghost1: Any
    ghost2: Any
    friction: Any
    restitution: Any
    rolling_resistance: Any
    tangent_speed: Any
    user_material: Any
    density: Any
    filter_category: Any
    filter_mask: Any
    filter_group: Any
    is_sensor: Any
    enable_contact_events: Any
    enable_hit_events: Any
    enable_sensor_events: Any
    enabled: Any
    table: Any


@dataclasses.dataclass
class ContactStore:
    """Per-pair-lane warm-start cache (row i = pair lane i)."""

    key_a: Any
    key_b: Any
    ids: Any
    normal_impulse: Any
    tangent_impulse: Any
    rolling_impulse: Any
    touching: Any
    color: Any


@dataclasses.dataclass
class Joints:
    """Joint SoA; lane i is joint id i (see box2d_tpu/state.py)."""

    type: Any
    enabled: Any
    body_a: Any
    body_b: Any
    frame_a_p: Any
    frame_a_q: Any
    frame_b_p: Any
    frame_b_q: Any
    collide_connected: Any
    constraint_hertz: Any
    constraint_damping_ratio: Any
    hertz: Any
    damping_ratio: Any
    enable_spring: Any
    enable_limit: Any
    enable_motor: Any
    lower: Any
    upper: Any
    motor_speed: Any
    max_motor_force: Any
    length: Any
    lower_spring_force: Any
    upper_spring_force: Any
    spring_target: Any
    angular_hertz: Any
    angular_damping_ratio: Any
    linear_velocity: Any
    angular_velocity: Any
    max_velocity_force: Any
    max_velocity_torque: Any
    max_spring_force: Any
    max_spring_torque: Any
    force_threshold: Any
    torque_threshold: Any
    color: Any
    impulse: Any
    spring_impulse: Any
    spring_impulse2: Any
    motor_impulse: Any
    lower_impulse: Any
    upper_impulse: Any
    angular_impulse: Any


@dataclasses.dataclass
class Tuning:
    gravity: Any
    restitution_threshold: Any
    hit_event_threshold: Any
    contact_hertz: Any
    contact_damping_ratio: Any
    contact_speed: Any
    max_linear_speed: Any
    joint_hertz: Any
    joint_damping_ratio: Any
    enable_sleep: Any
    enable_continuous: Any
    enable_warm_starting: Any
    enable_speculative: Any
    enable_contact_softening: Any


@dataclasses.dataclass
class Events:
    contact_begin: Any
    contact_begin_count: Any
    contact_end: Any
    contact_end_count: Any
    hit_point: Any
    hit_normal: Any
    hit_speed: Any
    hit_shapes: Any
    hit_count: Any
    sensor_begin: Any
    sensor_begin_count: Any
    sensor_end: Any
    sensor_end_count: Any
    joint_force: Any
    joint_force_count: Any
    body_moved: Any
    body_fell_asleep: Any
    body_move_count: Any
    body_fell_asleep_count: Any


@dataclasses.dataclass
class Profile:
    pair_count: Any
    contact_point_count: Any
    color_count: Any
    overflow_pairs: Any
    overflow_colors: Any
    store_drops: Any
    overflow_ccd: Any
    overflow_particles: Any
    events_dropped: Any
    pair_rebuild: Any


@dataclasses.dataclass
class BroadphaseStore:
    fat: Any
    alive: Any
    shape_a: Any
    shape_b: Any
    valid: Any
    count: Any
    overflow: Any
    dirty: Any
    cell: Any = None


@dataclasses.dataclass
class WorldState:
    bodies: Bodies
    shapes: Shapes
    contacts: ContactStore
    joints: Joints
    tuning: Tuning
    events: Events
    profile: Profile
    sensor_overlap: Any
    particles: Any
    step_count: Any
    broadphase: Any = None


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Static capacities (same fields and defaults as box2d_tpu.state)."""

    max_bodies: int
    max_shapes: int
    max_joints: int
    max_contact_pairs: int
    max_neighbors: int = 16
    sap_window: int = 32
    max_verts: int = 8
    big_shape_cap: int = 16
    color_chunk: int = 0
    max_colors: int = 24
    sensor_pair_capacity: int = 256
    event_capacity: int = 256
    fast_cap: int = 0
    cand_cap: int = 8
    bp_tile: int = 512
    bp_repair_cap: int = 256
    has_filters: bool = True
    has_joint_exclusions: bool = True
    batched: bool = False


def auto_chunk(max_contact_pairs: int) -> int:
    """Default per-color bucket cap when Capacity.color_chunk == 0. Same
    rule as box2d_tpu.state.auto_chunk, so both packages lay out the same
    color buckets."""
    c = max(128, ((max_contact_pairs // 16 + 127) // 128) * 128)
    if c >= 512:
        c = ((c + 511) // 512) * 512
    return c


def _i32(device, v=0):
    return torch.tensor(v, dtype=torch.int32, device=device)


def zero_broadphase(S: int, P: int, device) -> BroadphaseStore:
    return BroadphaseStore(
        fat=torch.zeros((S, 4), dtype=torch.float32, device=device),
        alive=torch.zeros(S, dtype=torch.bool, device=device),
        shape_a=torch.zeros(P, dtype=torch.int32, device=device),
        shape_b=torch.zeros(P, dtype=torch.int32, device=device),
        valid=torch.zeros(P, dtype=torch.bool, device=device),
        count=_i32(device),
        overflow=_i32(device),
        dirty=torch.tensor(True, device=device),
        cell=torch.tensor(1e9, dtype=torch.float32, device=device),
    )


def zero_events(cap: Capacity, device, nb: int | None = None) -> Events:
    e = cap.event_capacity
    nb = cap.max_bodies if nb is None else nb
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return Events(
        contact_begin=torch.zeros((e, 2), **i32),
        contact_begin_count=_i32(device),
        contact_end=torch.zeros((e, 2), **i32),
        contact_end_count=_i32(device),
        hit_point=torch.zeros((e, 2), **f32),
        hit_normal=torch.zeros((e, 2), **f32),
        hit_speed=torch.zeros((e,), **f32),
        hit_shapes=torch.zeros((e, 2), **i32),
        hit_count=_i32(device),
        sensor_begin=torch.zeros((e, 2), **i32),
        sensor_begin_count=_i32(device),
        sensor_end=torch.zeros((e, 2), **i32),
        sensor_end_count=_i32(device),
        joint_force=torch.zeros((e,), **i32),
        joint_force_count=_i32(device),
        body_moved=torch.zeros((nb,), **b),
        body_fell_asleep=torch.zeros((nb,), **b),
        body_move_count=_i32(device),
        body_fell_asleep_count=_i32(device),
    )


def zero_profile(device) -> Profile:
    return Profile(*[_i32(device) for _ in dataclasses.fields(Profile)])


# ---------------------------------------------------------------------------
# carrying state across packages
# ---------------------------------------------------------------------------

_SUBTREES = {
    "bodies": Bodies, "shapes": Shapes, "contacts": ContactStore,
    "joints": Joints, "tuning": Tuning, "events": Events,
    "profile": Profile, "broadphase": BroadphaseStore,
}


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """Flatten a dataclass tree of arrays (this package's torch state, or
    any tree with the same field names whose leaves numpy can read, such as
    the JAX package's WorldState) to {dotted path: np.ndarray}. None leaves
    (no particles, no broadphase) are skipped."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = prefix + f.name
            if v is None:
                continue
            if dataclasses.is_dataclass(v):
                walk(v, key + ".")
            elif isinstance(v, torch.Tensor):
                out[key] = v.detach().cpu().numpy()
            else:
                out[key] = np.asarray(v)

    walk(state, "")
    return out


def state_from_numpy(leaves: dict, device) -> WorldState:
    """Inverse of state_to_numpy: build a torch WorldState on `device` from
    {dotted path: array}, nested paths included ("particles.params.radius").
    dtypes and shapes are kept as given."""
    from .particles import ParticleParams, Particles

    nested = {WorldState: dict(_SUBTREES, particles=Particles),
              Particles: {"params": ParticleParams}}

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    tree: dict = {}
    for key, val in leaves.items():
        *heads, leaf = key.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = tensor(val)

    def make(cls, node):
        kw = {k: make(nested[cls][k], v) if isinstance(v, dict) else v
              for k, v in node.items()}
        return cls(**kw)

    tree.setdefault("particles", None)
    return make(WorldState, tree)


# ---------------------------------------------------------------------------
# batched states: a leading world axis on every tensor
# ---------------------------------------------------------------------------

def map_state(fn, *trees):
    """Apply fn leaf by leaf over dataclass trees of the same structure
    (None leaves stay None): fn(*tensors) -> tensor."""
    first = trees[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: map_state(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    return fn(*trees)


def broadcast_state(state, n_worlds: int):
    """A batch of n_worlds copies of `state`: every tensor gains a leading
    world axis (the counterpart of jax.tree.map(lambda x:
    jnp.broadcast_to(x, (W,) + x.shape), state) in the JAX package's
    bench)."""
    return map_state(lambda x: x.expand((n_worlds,) + tuple(x.shape))
                     .contiguous(), state)


def stack_states(states):
    """A batch of the given states (one capacity): leaf by leaf, stacked on
    a new leading world axis."""
    return map_state(lambda *xs: torch.stack(xs), *states)


def unstack_state(batch, w: int):
    """World w of a batch, as a single-world state."""
    return map_state(lambda x: x[w], batch)
