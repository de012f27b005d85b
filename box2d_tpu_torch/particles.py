"""LiquidFun particles: the plain-water particle step.

Torch port of box2d_tpu/particles.py along the path a plain-water scene
takes (dam_break): the particle state (`ParticleParams`, `Particles`,
`ParticleConfig`, same fields, dtypes and shapes), the builder
(`create_particle`, `create_group_box`, `build`), the closed-form
particle-vs-polygon distance and ray (`_point_shape_distance_batched`,
`_ray_polygon_batched`), and `particle_step` with its sub-iterations run
in cell-sorted order: the cell sort (the nearly-sorted rank repair K4, or
the stable argsort), the single packed permutation, the neighbour passes
weight, pressure and damping through the window kernel K3
(particles_kernels.py), dense body coupling, force, gravity, limit
velocity, the anti-tunnel ray against polygons, lifetimes, integration,
the single un-sort and stuck detection.

The port always takes K3 for the neighbour passes; the JAX package does so
only on an accelerator with at least 2048 particles and otherwise runs
the windowed `_find_contacts_sorted` pipeline, which agrees with K3
wherever the windows do not truncate. The flag-gated passes, pairs and
triads, solid and rigid groups, per-block shape culling, the windowed
pipeline and the anti-tunnel ray against non-polygon shapes are not
ported: they raise NotImplementedError naming their ROADMAP.md item.

PyTorch runs eagerly: the `lax.scan` over sub-iterations is a Python loop,
and the rank repair's `lax.cond` is a host branch on one device read per
sub-iteration (world.StepStats counts it). The scalar chain (dt, inv_dt,
crit_v, mass, ...) is float32, as in the JAX step: host values are
np.float32, device values 0-d float32 tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from . import math2d as m
from . import particles_kernels as pk
from .broadphase import _top_k, compute_shape_aabbs
from .geometry import POLYGON
from .state import DYNAMIC, WorldState

# particle flags (ref: particle/Particle.cs ParticleFlag)
P_ZOMBIE = 1 << 1
P_WALL = 1 << 2
P_SPRING = 1 << 3
P_ELASTIC = 1 << 4
P_VISCOUS = 1 << 5
P_POWDER = 1 << 6
P_TENSILE = 1 << 7
P_COLOR_MIXING = 1 << 8
P_BARRIER = 1 << 9
P_STATIC_PRESSURE = 1 << 10
P_REACTIVE = 1 << 11
P_REPULSIVE = 1 << 12

# group flags (ref: particle/ParticleGroup.cs)
G_SOLID = 1 << 0
G_RIGID = 1 << 1
G_NEEDS_DEPTH = 1 << 2

# tuning constants (ref: particle/World.cs:8-45)
PARTICLE_STRIDE = 0.75
MIN_PARTICLE_WEIGHT = 1.0
MAX_PARTICLE_PRESSURE = 0.25
MAX_PARTICLE_FORCE = 0.5
PARTICLE_LINEAR_SLOP = 0.005

_NO_PRESSURE = P_POWDER | P_TENSILE

_REMAINDER = "ROADMAP.md queue 13 (the rest of the particle engine)"


@dataclasses.dataclass
class ParticleParams:
    """ref: ParticleSystem properties :604-650 (0-d float32 tensors)."""

    radius: Any
    density: Any
    gravity_scale: Any
    pressure_strength: Any
    damping_strength: Any
    elastic_strength: Any
    spring_strength: Any
    viscous_strength: Any
    surface_tension_pressure: Any
    surface_tension_normal: Any
    repulsive_strength: Any
    powder_strength: Any
    ejection_strength: Any
    static_pressure_strength: Any
    static_pressure_relaxation: Any
    color_mixing_strength: Any


def default_params(radius: float, density: float = 1.0,
                   device="cuda") -> ParticleParams:
    def f(x):
        return torch.tensor(np.float32(x), device=device)

    return ParticleParams(
        radius=f(radius), density=f(density), gravity_scale=f(1.0),
        pressure_strength=f(0.05), damping_strength=f(1.0),
        elastic_strength=f(0.25), spring_strength=f(0.25),
        viscous_strength=f(0.25), surface_tension_pressure=f(0.2),
        surface_tension_normal=f(0.2), repulsive_strength=f(1.0),
        powder_strength=f(0.5), ejection_strength=f(0.5),
        static_pressure_strength=f(0.2), static_pressure_relaxation=f(0.2),
        color_mixing_strength=f(0.5),
    )


@dataclasses.dataclass
class Particles:
    """SoA buffers (ref: ParticleSystem.cs:2585-2605); the fields, dtypes
    and shapes of box2d_tpu.particles.Particles."""

    pos: Any        # (Np, 2)
    vel: Any        # (Np, 2)
    force: Any      # (Np, 2) user forces, cleared per step
    flags: Any      # (Np,) i32
    group: Any      # (Np,) i32, -1 = none
    alive: Any      # (Np,) bool
    expiration: Any  # (Np,) seconds left; <= 0 means immortal
    color: Any      # (Np, 4) f32 RGBA
    static_pressure: Any  # (Np,)
    depth: Any      # (Np,)
    group_flags: Any      # (G,) i32
    group_strength: Any   # (G,)
    pair_a: Any
    pair_b: Any
    pair_flags: Any
    pair_strength: Any
    pair_distance: Any
    triad_a: Any
    triad_b: Any
    triad_c: Any
    triad_flags: Any
    triad_strength: Any
    triad_pa: Any
    triad_pb: Any
    triad_pc: Any
    consecutive_contact_steps: Any  # (Np,) i32
    params: Any    # ParticleParams


class ParticleConfig(NamedTuple):
    """Static config of the particle step (box2d_tpu.particles
    .ParticleConfig, same fields). The port always runs the window kernel:
    use_window_kernel=False, like every has_* gate, raises."""

    k_same: int = 12
    k_up: int = 12
    max_body_shapes: int = 16
    iterations: int = 4
    static_pressure_iterations: int = 8
    depth_iterations: int = 16
    has_barrier: bool = False
    has_viscous: bool = False
    has_repulsive: bool = False
    has_powder: bool = False
    has_tensile: bool = False
    has_colormix: bool = False
    has_static_pressure: bool = False
    has_elastic: bool = False
    has_spring: bool = False
    has_wall: bool = False
    has_solid: bool = False
    has_rigid: bool = False
    use_window_kernel: bool = True
    rank_repair: bool = False
    block_shape_slots: int = 8
    geom_types: frozenset | None = None


def unported(cfg: ParticleConfig, n_shapes: int) -> str | None:
    """What of `cfg` this port cannot step yet (with its ROADMAP.md item),
    or None."""
    for gate in ("viscous", "repulsive", "powder", "tensile",
                 "static_pressure", "colormix", "elastic", "spring",
                 "barrier", "solid", "rigid", "wall"):
        if getattr(cfg, "has_" + gate):
            return f"the particle {gate} pass: {_REMAINDER}"
    if not cfg.use_window_kernel:
        return f"the windowed _find_contacts_sorted pipeline: {_REMAINDER}"
    if min(cfg.max_body_shapes, n_shapes) > cfg.block_shape_slots:
        return f"per-block body-shape culling: {_REMAINDER}"
    if cfg.geom_types is None or not cfg.geom_types <= {POLYGON}:
        return ("the anti-tunnel ray against non-polygon shapes: ROADMAP.md "
                "queue 10 (CCD, sensors and queries)")
    return None


# ---------------------------------------------------------------------------
# host-side builder
# ---------------------------------------------------------------------------

def fill_box(center, half_w, half_h, stride) -> np.ndarray:
    """Stride-grid points filling a box: the loop of the JAX package's
    native scene core (native/scene_core.cpp fill_box), which takes its
    arguments as float32 and walks in doubles, y outer and x inner."""
    f = np.float32
    cx, cy, hw, hh, st = (f(v) for v in (center[0], center[1], half_w,
                                         half_h, stride))
    half_st = st / f(2)
    out = []
    y = float(-hh + half_st)
    while y < float(hh):
        x = float(-hw + half_st)
        while x < float(hw):
            out.append((float(cx) + x, float(cy) + y))
            x += float(st)
        y += float(st)
    return np.array(out, np.float32).reshape(-1, 2)


class ParticleSystemBuilder:
    """Create particles and groups eagerly; freeze to a Particles tree."""

    def __init__(self, radius: float, density: float = 1.0):
        self.radius = float(radius)
        self.density = float(density)
        self.pos: list = []
        self.vel: list = []
        self.flags: list = []
        self.group: list = []
        self.group_flags: list = []
        self.group_strength: list = []
        self.lifetime: list = []
        self.color: list = []

    def create_particle(self, position, velocity=(0.0, 0.0), flags=0,
                        group=-1, lifetime=0.0,
                        color=(1.0, 1.0, 1.0, 1.0)) -> int:
        if int(flags) & (P_SPRING | P_ELASTIC | P_BARRIER):
            raise NotImplementedError(
                f"particle pairs and triads (spring, elastic, barrier): "
                f"{_REMAINDER}")
        self.pos.append(np.asarray(position, np.float32))
        self.vel.append(np.asarray(velocity, np.float32))
        self.flags.append(int(flags))
        self.group.append(int(group))
        self.lifetime.append(float(lifetime))
        self.color.append(np.asarray(color, np.float32))
        return len(self.pos) - 1

    def create_group_box(self, center, half_w, half_h, flags=0,
                         group_flags=0, strength=1.0, velocity=(0.0, 0.0),
                         lifetime=0.0, color=(1.0, 1.0, 1.0, 1.0)) -> int:
        """Fill a box with particles on the standard stride grid
        (ref: CreateParticleGroup shape fill :652-720)."""
        if int(flags) & (P_SPRING | P_ELASTIC | P_BARRIER):
            raise NotImplementedError(
                f"particle pairs and triads (spring, elastic, barrier "
                f"groups): {_REMAINDER}")
        gid = len(self.group_flags)
        gf = int(group_flags)
        if gf & G_SOLID:
            gf |= G_NEEDS_DEPTH
        self.group_flags.append(gf)
        self.group_strength.append(float(strength))
        stride = PARTICLE_STRIDE * 2.0 * self.radius
        for p in fill_box(center, half_w, half_h, stride):
            self.create_particle(p, velocity, flags, gid, lifetime, color)
        return gid

    def build(self, capacity: int | None = None, device="cuda") -> Particles:
        n = len(self.pos)
        cap = capacity or max(n, 1)
        g = max(len(self.group_flags), 1)

        def up(a):
            return torch.from_numpy(np.asarray(a)).to(device)

        def pad(lst, cap_, shape=(), dtype=np.float32, fill=0):
            out = np.full((cap_,) + shape, fill, dtype)
            for i, v in enumerate(lst):
                out[i] = v
            return up(out)

        def zeros(shape, dtype=np.float32):
            return up(np.zeros(shape, dtype))

        return Particles(
            pos=pad(self.pos, cap, (2,)),
            vel=pad(self.vel, cap, (2,)),
            force=zeros((cap, 2)),
            flags=pad(self.flags, cap, (), np.int32),
            group=pad(self.group, cap, (), np.int32, -1),
            alive=up(np.arange(cap) < n),
            expiration=pad(self.lifetime, cap),
            color=pad(self.color, cap, (4,)),
            static_pressure=zeros(cap),
            depth=zeros(cap),
            group_flags=pad(self.group_flags, g, (), np.int32),
            group_strength=pad(self.group_strength, g, (), np.float32, 1.0),
            pair_a=zeros(1, np.int32), pair_b=zeros(1, np.int32),
            pair_flags=zeros(1, np.int32), pair_strength=zeros(1),
            pair_distance=zeros(1),
            triad_a=zeros(1, np.int32), triad_b=zeros(1, np.int32),
            triad_c=zeros(1, np.int32), triad_flags=zeros(1, np.int32),
            triad_strength=zeros(1), triad_pa=zeros((1, 2)),
            triad_pb=zeros((1, 2)), triad_pc=zeros((1, 2)),
            consecutive_contact_steps=zeros(cap, np.int32),
            params=default_params(self.radius, self.density, device),
        )


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def _cell_key(pos, alive, inv_diameter):
    """Row-major packed cell key (ref: ComputeTag :2610-2611). The shift
    and the bias are computed in int64 and wrapped to int32, as JAX's int32
    arithmetic wraps; dead lanes get INT32_MAX."""
    xi = torch.floor(pos[:, 0] * inv_diameter).to(torch.int64)
    yi = torch.floor(pos[:, 1] * inv_diameter).to(torch.int64)
    key = (((yi + 0x8000) << 16) | ((xi + 0x8000) & 0xFFFF)) & 0xFFFFFFFF
    key = torch.where(key >= (1 << 31), key - (1 << 32), key)
    return torch.where(alive, key, pk.INT32_MAX).to(torch.int32)


def _safe_div(a, b):
    return a / torch.where(b != 0.0, b, 1.0)


def _pick(a, idx):
    """a (Sb, V, N) at the vertex lane idx (Sb, N): (Sb, N)."""
    return torch.gather(a, 1, idx[:, None, :]).squeeze(1)


def _col(a):
    """(Sb, V) per-(shape, vertex) values as an (Sb * V, 1) column."""
    return a.reshape(-1)[:, None]


def _lane_ok(verts, counts):
    """(Sb * V, 1): the vertex lane exists (lane < the shape's count)."""
    lanes = torch.arange(verts.shape[1], device=verts.device)
    return _col(lanes[None, :] < counts[:, None])


def _point_shape_distance_batched(pos, s_origin, s_rot, verts, normals,
                                  counts, radii):
    """(N, Sb) particle-to-shape surface distances and world-space outward
    normals (box2d_tpu/particles.py:544-627, same operations in the same
    order, in its transposed (Sb, N) layout)."""
    Sb, V = verts.shape[:2]
    lane_ok = _lane_ok(verts, counts)
    dx = pos[:, 0][None, :] - s_origin[:, 0:1]
    dy = pos[:, 1][None, :] - s_origin[:, 1:2]
    c = s_rot[:, 0:1]
    s = s_rot[:, 1:2]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy

    nxt = ((torch.arange(V, device=pos.device)[None, :] + 1)
           % torch.clamp(counts, min=1)[:, None].to(torch.int64))
    vnext = torch.gather(verts, 1, nxt[..., None].expand(Sb, V, 2))
    vx, vy = _col(verts[..., 0]), _col(verts[..., 1])
    nx, ny = _col(normals[..., 0]), _col(normals[..., 1])
    ex = _col(vnext[..., 0]) - vx
    ey = _col(vnext[..., 1]) - vy
    e2 = torch.clamp(ex * ex + ey * ey, min=1e-12)

    lxv = torch.repeat_interleave(lx, V, dim=0)
    lyv = torch.repeat_interleave(ly, V, dim=0)
    seps = nx * (lxv - vx) + ny * (lyv - vy)
    seps_m = torch.where(lane_ok, seps, -math.inf)
    inside3 = (torch.where(lane_ok, seps <= 0.0, True)
               .reshape(Sb, V, -1).all(dim=1) & (counts[:, None] >= 3))
    tt = torch.clamp(((lxv - vx) * ex + (lyv - vy) * ey) / e2, 0.0, 1.0)
    cpx = vx + tt * ex
    cpy = vy + tt * ey
    ddx = lxv - cpx
    ddy = lyv - cpy
    dd2 = ddx * ddx + ddy * ddy
    dd = torch.where(lane_ok, torch.sqrt(dd2), math.inf)
    dd3 = dd.reshape(Sb, V, -1)
    # min / max take the first extreme lane, as the reference's first-true
    # select does
    dist_out, bidx = dd3.min(dim=1)
    cl_x = _pick(cpx.reshape(Sb, V, -1), bidx)
    cl_y = _pick(cpy.reshape(Sb, V, -1), bidx)
    safe = torch.where(dist_out > 0, dist_out, 1.0)
    nox = (lx - cl_x) / safe
    noy = (ly - cl_y) / safe
    seps3 = seps_m.reshape(Sb, V, -1)
    sep_max, fidx = seps3.max(dim=1)
    nix = torch.gather(normals[..., 0], 1, fidx)
    niy = torch.gather(normals[..., 1], 1, fidx)
    dist = torch.where(inside3, sep_max, dist_out) - radii[:, None]
    lnx = torch.where(inside3, nix, nox)
    lny = torch.where(inside3, niy, noy)
    is_pt = (counts == 1)[:, None]
    dcx = lx - verts[:, 0, 0][:, None]
    dcy = ly - verts[:, 0, 1][:, None]
    dlen = torch.sqrt(dcx * dcx + dcy * dcy)
    dls = torch.where(dlen > 0, dlen, 1.0)
    dist = torch.where(is_pt, dlen - radii[:, None], dist)
    lnx = torch.where(is_pt, dcx / dls, lnx)
    lny = torch.where(is_pt, dcy / dls, lny)
    wnx = c * lnx - s * lny
    wny = s * lnx + c * lny
    return dist.T, torch.stack([wnx.T, wny.T], dim=-1)


def _ray_polygon_batched(pos, delta, s_origin, s_rot, verts, normals,
                         counts):
    """(N, Sb) slab raycast against radius-0 polygons
    (box2d_tpu/particles.py:1585-1640). Returns (hit, frac, world normal
    x, y)."""
    Sb, V = verts.shape[:2]
    lane_ok = _lane_ok(verts, counts)
    c = s_rot[:, 0:1]
    s = s_rot[:, 1:2]
    dx0 = pos[:, 0][None, :] - s_origin[:, 0:1]
    dy0 = pos[:, 1][None, :] - s_origin[:, 1:2]
    lpx = c * dx0 + s * dy0
    lpy = -s * dx0 + c * dy0
    ldx = c * delta[:, 0][None, :] + s * delta[:, 1][None, :]
    ldy = -s * delta[:, 0][None, :] + c * delta[:, 1][None, :]

    bx = verts[:, 0, 0][:, None]
    by = verts[:, 0, 1][:, None]
    vx, vy = _col(verts[..., 0]), _col(verts[..., 1])
    nx, ny = _col(normals[..., 0]), _col(normals[..., 1])
    rep = lambda a: torch.repeat_interleave(a, V, dim=0)
    px = rep(lpx - bx)
    py = rep(lpy - by)
    ddx = rep(ldx)
    ddy = rep(ldy)
    rvx = vx - rep(bx)
    rvy = vy - rep(by)
    num = nx * (rvx - px) + ny * (rvy - py)
    den = nx * ddx + ny * ddy
    tf = num / torch.where(den != 0.0, den, 1.0)
    lower_c = torch.where(lane_ok & (den < 0.0), tf, -math.inf)
    upper_c = torch.where(lane_ok & (den > 0.0), tf, math.inf)
    par_miss = (lane_ok & (den == 0.0) & (num < 0.0)).reshape(
        Sb, V, -1).any(dim=1)
    lc3 = lower_c.reshape(Sb, V, -1)
    mx, sidx = lc3.max(dim=1)
    lower = torch.clamp(mx, min=0.0)
    upper = torch.clamp(upper_c.reshape(Sb, V, -1).min(dim=1).values,
                        max=1.0)
    hit = ~par_miss & (lower <= upper) & (mx > 0.0) & (mx <= 1.0)
    frac = torch.where(hit, lower, math.inf)
    lnx = torch.gather(normals[..., 0], 1, sidx)
    lny = torch.gather(normals[..., 1], 1, sidx)
    wnx = c * lnx - s * lny
    wny = s * lnx + c * lny
    return hit.T, frac.T, wnx.T, wny.T


# ---------------------------------------------------------------------------
# the particle step
# ---------------------------------------------------------------------------

def _scatter_rows(src, rank):
    """out[rank[i]] = src[i] for a permutation `rank`."""
    out = torch.empty_like(src)
    out[rank.long()] = src
    return out


def _sort_rank(key):
    """Inverse permutation of the stable argsort of `key` (jnp.argsort is
    stable)."""
    order = torch.argsort(key, stable=True)
    return _scatter_rows(torch.arange(key.shape[0], dtype=torch.int32,
                                      device=key.device), order)


def particle_step(pt: Particles, state: WorldState, dt, cfg: ParticleConfig,
                  stats=None):
    """One full particle update (ref: Solve :1512-1564;
    box2d_tpu/particles.py:642-1447). Returns (particles, body_dv (Nb, 2),
    body_dw (Nb,), neighbor_overflow): K3 never truncates, so the overflow
    is the nearby shapes beyond max_body_shapes.

    stats: a world.StepStats; counts the rank-repair reads and which branch
    each sub-iteration took (rank_repairs / full_sorts)."""
    if stats is None:
        from .world import StepStats
        stats = StepStats()
    sh = state.shapes
    why = unported(cfg, sh.type.shape[0])
    if why is not None:
        raise NotImplementedError(why)
    prm: ParticleParams = pt.params
    b = state.bodies
    nb = b.center.shape[0]
    n = pt.pos.shape[0]
    dev = pt.pos.device
    f32 = np.float32

    dt = f32(dt) / f32(cfg.iterations)
    inv_dt = f32(1.0) / dt if dt != 0 else f32(1.0)
    dt, inv_dt = float(dt), float(inv_dt)
    diameter = 2.0 * prm.radius
    inv_diameter = 1.0 / diameter
    crit_v = diameter * inv_dt                       # ref :2480
    crit_v2 = crit_v * crit_v
    crit_p = prm.density * crit_v2                   # ref :2482
    mass = prm.density * prm.radius * prm.radius * math.pi  # ref :2484
    inv_mass = _safe_div(1.0, mass)
    lin_d = prm.damping_strength
    quad_d = _safe_div(1.0, crit_v)
    vel_per_p = dt * (1.0 / prm.density) * inv_diameter
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    scal_k = torch.stack([inv_diameter, diameter * diameter, lin_d, quad_d,
                          vel_per_p, zero, zero, zero])

    # nearby rigid shapes, compacted once per step (system AABB prefilter)
    alive0 = pt.alive[:, None]
    sys_lo = torch.where(alive0, pt.pos, math.inf).min(dim=0).values \
        - diameter
    sys_hi = torch.where(alive0, pt.pos, -math.inf).max(dim=0).values \
        + diameter
    boxes = compute_shape_aabbs(state)
    near = ((boxes[:, 0] <= sys_hi[0]) & (sys_lo[0] <= boxes[:, 2])
            & (boxes[:, 1] <= sys_hi[1]) & (sys_lo[1] <= boxes[:, 3])
            & sh.enabled & b.enabled[sh.body.long()] & ~sh.is_sensor)
    S = sh.type.shape[0]
    sscore = torch.where(near, S - torch.arange(S, device=dev), 0)
    stop, _ = _top_k(sscore, min(cfg.max_body_shapes, S))
    bs_valid = stop > 0
    bs_idx = torch.where(bs_valid, S - stop, 0)
    shape_overflow = torch.clamp(near.sum() - bs_valid.sum(),
                                 min=0).to(torch.int32)

    # per-shape body rows, gathered once (body velocities are read
    # pre-step: Jacobi coupling)
    p_body = sh.body[bs_idx].long()
    s_origin = b.origin[p_body]
    s_rot = b.rot[p_body]
    s_center = b.center[p_body]
    s_v = b.v[p_body]
    s_w = b.w[p_body]
    s_invm = b.inv_mass[p_body]
    s_invI = b.inv_inertia[p_body]
    s_dyn = b.type[p_body] == DYNAMIC
    s_verts = sh.verts[bs_idx]
    s_normals = sh.normals[bs_idx]
    s_count = sh.count[bs_idx]
    s_radius = sh.radius[bs_idx]

    body_dv = torch.zeros((nb, 2), dtype=torch.float32, device=dev)
    body_dw = torch.zeros(nb, dtype=torch.float32, device=dev)

    def apply_body_impulse(dv, dw, impulse, active):
        """Sum the (n, Sb, 2) per-contact impulses per shape, then add them
        to the shapes' bodies (the dense branch, particles.py:996-999)."""
        imp = torch.where((active & s_dyn[None, :])[..., None], impulse, 0.0)
        ang = m.cross(pos[:, None, :] - s_center[None, :, :], imp)
        dv = dv.index_add(0, p_body, imp.sum(dim=0) * s_invm[:, None])
        dw = dw.index_add(0, p_body, s_invI * ang.sum(dim=0))
        return dv, dw

    # the carry stays in the PREVIOUS sub-iteration's sorted order; s2o maps
    # sorted position -> original lane, skey_prev is the key it was sorted by
    cur_pos, cur_vel, cur_force = pt.pos, pt.vel, pt.force
    cur_exp, cur_sp = pt.expiration, pt.static_pressure
    cur_flags, cur_group, cur_alive = pt.flags, pt.group, pt.alive
    s2o = torch.arange(n, dtype=torch.int32, device=dev)
    skey_prev = _cell_key(pt.pos, pt.alive, inv_diameter)
    bc_cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    nbk = -(-n // pk.B_BLK)
    rbw = pk.rank_window(n)
    for _ in range(cfg.iterations):
        # ---- cell sort: the whole sub-iteration runs in sorted space ----
        key = _cell_key(cur_pos, cur_alive, inv_diameter)
        use_rank = False
        if cfg.rank_repair and n > 0:
            # nearly-sorted repair (K4) when every particle moved at most
            # one cell since the last sort and every block's window fits;
            # else the stable argsort (the other branch of the JAX cond)
            offs_r, span_ok = pk.rank_offsets(skey_prev, nbk, rbw)
            sorted_ok = (skey_prev[1:] >= skey_prev[:-1]).all()
            drow = ((key >> 16) - (skey_prev >> 16)).abs()
            dcol = ((key & 0xFFFF) - (skey_prev & 0xFFFF)).abs()
            jump_ok = ((drow <= 1) & (dcol <= 1)).all()
            (use_rank,) = stats.read(sorted_ok & jump_ok & span_ok.all())
        if use_rank:
            rank = pk.rank_pass(key, offs_r, rbw)
            stats.rank_repairs += 1
        else:
            rank = _sort_rank(key)
            stats.full_sorts += 1
        # one packed permutation of every field the sub-iteration carries
        # (float columns ride as their int32 bits, so the copy is exact)
        ints = torch.stack([cur_flags, cur_group, cur_alive.to(torch.int32),
                            s2o, key], dim=1)
        floats = torch.cat([cur_pos, cur_vel, cur_force, cur_exp[:, None],
                            cur_sp[:, None]], dim=1)
        pack = _scatter_rows(torch.cat([floats.view(torch.int32), ints],
                                       dim=1), rank)
        fp = pack[:, :8].view(torch.float32)
        pos, vel, force = fp[:, 0:2], fp[:, 2:4], fp[:, 4:6]
        expiration, static_pressure = fp[:, 6], fp[:, 7]
        flags, group = pack[:, 8], pack[:, 9]
        alive = pack[:, 10] > 0
        s2o = pack[:, 11]
        skey = pack[:, 12].contiguous()
        pos_c = pos.contiguous()

        # ---- neighbour contacts: weight (K3) ----
        zcol = torch.zeros(n, dtype=torch.float32, device=dev)
        w_pairs = pk.window_pass(pos_c, skey, alive, zcol, zcol, scal_k, pk.PH_WEIGHT)[:, 0]

        # ---- body contacts (ref UpdateBodyContacts), dense over Sb ----
        bdist, bnrm = _point_shape_distance_batched(
            pos, s_origin, s_rot, s_verts, s_normals, s_count, s_radius)
        bc_ok = (bdist < prm.radius) & alive[:, None] & bs_valid[None, :]
        bc_n = -bnrm
        bc_w = torch.where(bc_ok, 1.0 - bdist * inv_diameter * 2.0, 0.0)
        rpn = m.cross(pos[:, None, :] - s_center[None, :, :], bnrm)
        wall = (flags & P_WALL) != 0
        inv_m_c = (torch.where(wall, 0.0, inv_mass)[:, None]
                   + s_invm[None, :] + s_invI[None, :] * rpn * rpn)
        bc_mass = torch.where(
            inv_m_c > 0, 1.0 / torch.where(inv_m_c > 0, inv_m_c, 1.0), 0.0)
        bc_mass = torch.where(bc_ok, bc_mass, 0.0)

        # ---- weight (ref ComputeWeight) ----
        weight = w_pairs + bc_w.sum(dim=1)

        # ---- force (user forces, ref SolveForce) ----
        vel = vel + dt * inv_mass * force

        # ---- gravity (ref SolveGravity) ----
        g_ = dt * prm.gravity_scale * state.tuning.gravity
        vel = vel + torch.where(alive[:, None], g_[None, :], 0.0)

        # ---- pressure (ref SolvePressure) ----
        sp_mask = (flags & P_STATIC_PRESSURE) != 0
        ppw = prm.pressure_strength * crit_p
        maxp = MAX_PARTICLE_PRESSURE * crit_p
        accum = torch.minimum(
            ppw * torch.clamp(weight - MIN_PARTICLE_WEIGHT, min=0.0), maxp)
        accum = torch.where((flags & _NO_PRESSURE) != 0, 0.0, accum)
        accum = accum + torch.where(sp_mask, static_pressure, 0.0)
        fb = (vel_per_p * bc_w * bc_mass
              * (accum[:, None] + ppw * bc_w))[..., None] * bc_n
        fb = torch.where(bc_ok[..., None], fb, 0.0)
        vel = vel - inv_mass * fb.sum(dim=1)
        body_dv, body_dw = apply_body_impulse(body_dv, body_dw, fb, bc_ok)
        vel = vel + pk.window_pass(pos_c, skey, alive, accum.contiguous(),
                                   zcol, scal_k, pk.PH_PRESSURE)

        # ---- damping (ref SolveDamping) ----
        vrel = (s_v[None, :, :]
                + m.cross_sv(s_w[None, :], pos[:, None, :] - s_center[None]))
        vn = m.dot(vrel - vel[:, None, :], bc_n)
        damp = torch.maximum(lin_d * bc_w,
                             torch.clamp(-quad_d * vn, max=0.5))
        fb = (damp * bc_mass * vn)[..., None] * bc_n
        approach = bc_ok & (vn < 0)
        fb = torch.where(approach[..., None], fb, 0.0)
        vel = vel + inv_mass * fb.sum(dim=1)
        body_dv, body_dw = apply_body_impulse(body_dv, body_dw, -fb,
                                              approach)
        vel = vel + pk.window_pass(pos_c, skey, alive,
                                   vel[:, 0].contiguous(),
                                   vel[:, 1].contiguous(), scal_k,
                                   pk.PH_DAMPING)

        # ---- limit velocity (ref LimitVelocity) ----
        v2 = m.dot(vel, vel)
        vel = torch.where((v2 > crit_v2)[:, None],
                          vel * torch.sqrt(_safe_div(crit_v2, v2))[:, None],
                          vel)

        # ---- collision anti-tunnelling against polygons (ref
        # SolveCollision; particles.py:1657-1695) ----
        step_v = dt * vel
        hit, frac, wnx, wny = _ray_polygon_batched(
            pos, step_v, s_origin, s_rot, s_verts, s_normals, s_count)
        hit = hit & bs_valid[None, :] & alive[:, None]
        frac = torch.where(hit, frac, math.inf)
        fbest, hidx = frac.min(dim=1)      # the first nearest hit
        any_hit = torch.isfinite(fbest)
        hidx = hidx[:, None]
        wn = torch.cat([torch.gather(wnx, 1, hidx),
                        torch.gather(wny, 1, hidx)], dim=1)
        fbh = torch.where(any_hit, fbest, 0.0)
        target = pos + fbh[:, None] * step_v + PARTICLE_LINEAR_SLOP * wn
        vel = torch.where(any_hit[:, None], inv_dt * (target - pos), vel)

        # ---- lifetimes (ref SolveLifetimes :1516) ----
        expiring = expiration > 0.0
        new_exp = torch.where(expiring, expiration - dt, expiration)
        new_alive = alive & ~(expiring & (new_exp <= 0.0))

        # ---- integrate (ref :1554-1561) ----
        pos = pos + torch.where(alive[:, None], dt * vel, 0.0)

        cur_pos, cur_vel, cur_force = pos, vel, force
        cur_exp, cur_sp = new_exp, static_pressure
        cur_flags, cur_group, cur_alive = flags, group, new_alive
        skey_prev = skey
        bc_cnt = bc_ok.sum(dim=1).to(torch.int32)

    # ---- un-sort once: the mutated fields back to original lanes ----
    fback = _scatter_rows(torch.cat([cur_pos, cur_vel, cur_exp[:, None]],
                                    dim=1), s2o)
    iback = _scatter_rows(torch.stack([cur_alive.to(torch.int32), bc_cnt],
                                      dim=1), s2o)
    alive_o = iback[:, 0] > 0
    # stuck detection (ref DetectStuckParticle :1520-1541)
    stuck_now = alive_o & (iback[:, 1] >= 2)
    out = dataclasses.replace(
        pt, pos=fback[:, 0:2].contiguous(), vel=fback[:, 2:4].contiguous(),
        expiration=fback[:, 4].contiguous(), alive=alive_o,
        force=torch.zeros_like(pt.force),
        consecutive_contact_steps=torch.where(
            stuck_now, pt.consecutive_contact_steps + 1, 0).to(torch.int32))
    return out, body_dv, body_dw, shape_overflow
