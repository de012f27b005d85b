"""LiquidFun particles: the whole particle step.

Torch port of box2d_tpu/particles.py: the particle state (`ParticleParams`,
`Particles`, `ParticleConfig`, same fields, dtypes and shapes), the builder
(`create_particle`, `create_group_box` with the spring / barrier pairs and
elastic triads of csrc/scene_core.cpp through native.py, `build`), the
closed-form particle-vs-polygon distance and ray
(`_point_shape_distance_batched`, `_ray_polygon_batched`), and
`particle_step` with its sub-iterations run in cell-sorted order: the cell
sort, the single packed permutation (depth and colour columns where solid
groups or colour mixing need them), the original-lane to sorted-lane remap
of pairs and triads, the neighbour passes, body coupling, every flag-gated
pass (viscous, repulsive, powder, tensile, solid depth and ejection,
static pressure, elastic, spring, rigid groups and their damping, wall,
barrier, colour mixing), the anti-tunnel ray (the slab ray where every
shape is a polygon, else queries.ray_shape_analytic), lifetimes,
integration, the single un-sort and stuck detection.

The neighbour passes take one of two paths, by the JAX rule
(box2d_tpu/particles.py:734-757): where no gated pass needs the flat pair
view or the pair / triad remap and `use_window_kernel` is set, the window
kernel K3 (particles_kernels.py) sums weight, pressure and damping, after
the rank repair K4 or a stable argsort; otherwise every sub-iteration
fully sorts and the windowed `_find_contacts_sorted` pipeline gives the
fixed same-row and row-above windows (`k_same`, `k_up`), whose truncation
counts into the overflow, and the gated passes read their flat view.

With more nearby shapes than `block_shape_slots` (a flat batch of
replicated tanks), the body coupling and the polygon anti-tunnel ray take
per-block shape culling (box2d_tpu/particles.py:679-729, :900-959,
:985-994): each block of 256 sorted particles couples with its own top-K
shapes whose fattened boxes overlap it, instead of with every nearby
shape. The culled rows reach the impulse sums as arguments, never through
a name a later pass rebinds (the reference's rigid pass rebinds them,
:1267).

Batched worlds (`particle_step(..., n_worlds=W)`, batch.py; the
counterpart of jax.vmap of the JAX step): W worlds laid flat, world-major,
one parameter set a world. Each world sorts its own cells (a stable sort
of (world, cell) keys), couples with its own nearby shapes and, when
culled, its own blocks, and sums its own neighbours: K3 batched (one
launch a phase for every world) or the windowed pipeline with every shift
and search kept inside a world. World w of the result equals the
single-world step on world w, bit for bit on the CPU.

PyTorch runs eagerly: the `lax.scan` over sub-iterations is a Python loop,
the rank repair's `lax.cond` is a host branch on one device read a
sub-iteration, the depth pass's `lax.cond` one read a sub-iteration of a
world with solid groups, and the depth relaxation's `while_loop` reads the
device every CHECK_EVERY rounds (world.StepStats counts them); the
scatter-adds' SegmentPlans read their widest fan-in once a sub-iteration
(neighbours, culled bodies) and once a step (triads, springs, groups).

Off the K3 path, the step gives the same bits on the card as on the CPU,
and again when run twice: the sums onto particles, groups and bodies are
segment sums (a stable sort by target, then a fixed pairwise tree of
elementwise adds, _segment_add) where index_add_ on the card would add a
target's lanes in another order; row and column sums take the same tree
(_tree_sum) where a reduction kernel would add in another order; square
roots are correctly rounded on both devices (_sqrt); no tensor is divided
by a host scalar (the card multiplies by its reciprocal). The plain-water
K3 path keeps its reductions, index_add_ and torch.sqrt. The scalar chain
(dt, inv_dt, crit_v, mass, ...) is float32, as in the JAX step: host
values are np.float32, device values 0-d float32 tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from . import math2d as m
from . import particles_kernels as pk
from .broadphase import _top_k, compute_shape_aabbs
from .geometry import POLYGON
from .queries import ray_shape_analytic
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
# depth relaxation rounds between two device reads of "did any depth
# shrink" (the reference's while_loop reads it every round)
CHECK_EVERY = 8


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
    .ParticleConfig, same fields): the window sizes, the trace-time pass
    gates (a pass whose flag is absent from the scene never runs), the
    window kernel K3 and rank repair K4 (taken only where no gated pass
    needs the flat pair view or the pair / triad remap), the culling
    slots and the scene's geometry families."""

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


# ---------------------------------------------------------------------------
# host-side builder
# ---------------------------------------------------------------------------

def calculate_reasonable_particle_iterations(gravity, radius, dt) -> int:
    """LiquidFun's particle iteration count for a gravity (a scalar or a
    vector), particle radius and time step: clamp(ceil(sqrt(g / (0.01 *
    r)) * dt), 1, 8) (ref: api/Particle.cs:9-38, particle/Particle.cs:
    87-93)."""
    g = (float(abs(gravity)) if not hasattr(gravity, "__len__")
         else float(math.hypot(*gravity)))
    if radius <= 0 or dt <= 0:
        return 1
    return max(1, min(8, math.ceil(math.sqrt(g / (0.01 * radius)) * dt)))


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
        self.pairs: list = []
        self.triads: list = []
        self.lifetime: list = []
        self.color: list = []

    def create_particle(self, position, velocity=(0.0, 0.0), flags=0,
                        group=-1, lifetime=0.0,
                        color=(1.0, 1.0, 1.0, 1.0)) -> int:
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
        (ref: CreateParticleGroup shape fill :652-720); spring, elastic
        and barrier groups get their pairs and triads."""
        gid = len(self.group_flags)
        gf = int(group_flags)
        if gf & G_SOLID:
            # solid groups need their depth field before the ejection can
            # act (ref: SetGroupFlags -> NeedsUpdateDepth)
            gf |= G_NEEDS_DEPTH
        self.group_flags.append(gf)
        self.group_strength.append(float(strength))
        stride = PARTICLE_STRIDE * 2.0 * self.radius
        first = len(self.pos)
        for p in fill_box(center, half_w, half_h, stride):
            self.create_particle(p, velocity, flags, gid, lifetime, color)
        if int(flags) & (P_SPRING | P_ELASTIC | P_BARRIER):
            self._build_pairs_triads(first, len(self.pos), int(flags),
                                     strength)
        return gid

    def _build_pairs_triads(self, first, last, flags, strength):
        """Spring / barrier pairs from initial proximity (under 1.2
        diameters) and elastic triads from the Voronoi diagram of the
        group (box2d_tpu/particles.py:269-303, its native path: ref
        :801-861). Barrier groups get pairs too: each pair is a barrier
        segment (ref k_pairFlags = spring | barrier,
        ParticleSystem.cs:762)."""
        from . import native

        pts = np.array(self.pos[first:last], np.float32)
        d = 2.0 * self.radius
        if flags & (P_SPRING | P_BARRIER):
            a, b, dist = native.build_pairs(pts, d * 1.2)
            for k in range(len(a)):
                self.pairs.append((first + int(a[k]), first + int(b[k]),
                                   flags, strength, float(dist[k])))
        if flags & P_ELASTIC:
            tri, rest = native.build_triads(pts, PARTICLE_STRIDE * d)
            for k in range(len(tri)):
                self.triads.append(
                    (first + int(tri[k, 0]), first + int(tri[k, 1]),
                     first + int(tri[k, 2]), flags, strength,
                     rest[k, 0], rest[k, 1], rest[k, 2]))

    def build(self, capacity: int | None = None,
              pair_capacity: int | None = None,
              triad_capacity: int | None = None,
              device="cuda") -> Particles:
        """The Particles tree (box2d_tpu/particles.py:322-367): `capacity`
        particle lanes, `pair_capacity` pair and `triad_capacity` triad
        lanes (each at least 1), padding lanes dead or flagged 0."""
        n = len(self.pos)
        cap = capacity or max(n, 1)
        g = max(len(self.group_flags), 1)
        pp = pair_capacity or max(len(self.pairs), 1)
        tp = triad_capacity or max(len(self.triads), 1)

        def up(a):
            return torch.from_numpy(np.asarray(a)).to(device)

        def pad(lst, cap_, shape=(), dtype=np.float32, fill=0):
            out = np.full((cap_,) + shape, fill, dtype)
            if len(lst):
                out[:len(lst)] = np.asarray(lst, dtype).reshape(
                    (len(lst),) + shape)
            return up(out)

        def zeros(shape, dtype=np.float32):
            return up(np.zeros(shape, dtype))

        pairs, triads = self.pairs, self.triads
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
            pair_a=pad([p[0] for p in pairs], pp, (), np.int32),
            pair_b=pad([p[1] for p in pairs], pp, (), np.int32),
            pair_flags=pad([p[2] for p in pairs], pp, (), np.int32),
            pair_strength=pad([p[3] for p in pairs], pp),
            pair_distance=pad([p[4] for p in pairs], pp),
            triad_a=pad([t[0] for t in triads], tp, (), np.int32),
            triad_b=pad([t[1] for t in triads], tp, (), np.int32),
            triad_c=pad([t[2] for t in triads], tp, (), np.int32),
            triad_flags=pad([t[3] for t in triads], tp, (), np.int32),
            triad_strength=pad([t[4] for t in triads], tp),
            triad_pa=pad([t[5] for t in triads], tp, (2,)),
            triad_pb=pad([t[6] for t in triads], tp, (2,)),
            triad_pc=pad([t[7] for t in triads], tp, (2,)),
            consecutive_contact_steps=zeros(cap, np.int32),
            params=default_params(self.radius, self.density, device),
        )


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

class _Worlds:
    """How the flat lanes of a particle step split into worlds: `w`
    worlds of `n` particle lanes each, world-major (batch.py lays a batch
    out so: world k's particles are lanes [k * n, (k + 1) * n), its
    nearby shapes rows [k * sb, (k + 1) * sb), its pairs, triads and
    groups likewise). With one world each method is what the single-world
    step did before there were worlds, and launches nothing more."""

    def __init__(self, w: int, n: int):
        self.w, self.n = w, n
        self._rows = {}

    def view(self, x):
        """x (w * k, ...) as (w, k, ...)."""
        if self.w == 1:
            return x
        return x.reshape((self.w, -1) + tuple(x.shape[1:]))

    def flat(self, x):
        """x (w, k, ...) as (w * k, ...)."""
        if self.w == 1:
            return x
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def rows(self, x, k: int):
        """A value of each world (0-d in one world, (w, ...) in w) at each
        of its k lanes: (w * k, ...); made once a step for each x."""
        if self.w == 1:
            return x
        key = (id(x), k)
        if key not in self._rows:
            self._rows[key] = (x, x.repeat_interleave(k, dim=0))
        return self._rows[key][1]

    def sum(self, x):
        """x (w * k,) summed in each world: (w,); one world: 0-d."""
        if self.w == 1:
            return x.sum()
        return x.view(self.w, -1).sum(dim=1)

    def at_lanes(self, x):
        """Each world's shape rows x (w * sb, ...) at each of its particle
        lanes, to broadcast against (w * n, sb, ...)."""
        if self.w == 1:
            return x[None]
        v = self.view(x)
        return v[:, None].expand((self.w, self.n) + tuple(v.shape[1:])
                                 ).reshape((self.w * self.n,)
                                           + tuple(v.shape[1:]))

    def shape_sum(self, x, tree: bool = False):
        """(w * n, sb, ...) per (particle, shape) values summed over each
        world's particles: (w * sb, ...); by _tree_sum where `tree`."""
        if self.w == 1:
            return _tree_sum(x.transpose(0, 1)) if tree else x.sum(dim=0)
        v = x.view((self.w, self.n) + tuple(x.shape[1:]))
        out = _tree_sum(v) if tree else v.sum(dim=1)
        return out.reshape((-1,) + tuple(x.shape[2:]))

    def search(self, seq, q, right: bool = False):
        """torch.searchsorted of each lane's q in its own world's sorted
        seq: indices local to the world."""
        if self.w == 1:
            return torch.searchsorted(seq, q, right=right)
        return torch.searchsorted(self.view(seq), self.view(q),
                                  right=right).reshape(-1)

    def map(self, fn, *args):
        """fn over each world's rows of args (torch.vmap over the world
        axis), its outputs flat again."""
        if self.w == 1:
            return fn(*args)
        out = torch.vmap(fn)(*(self.view(a) for a in args))
        return tuple(self.flat(o) for o in out)


def _lanes(x, ndim: int):
    """x, one value a lane ((N,), or 0-d for all lanes), shaped to
    broadcast against (N, ...) of ndim dims."""
    return x if x.dim() == 0 else x.reshape(x.shape + (1,) * (ndim - 1))


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


def _sqrt(x):
    """The correctly rounded float32 square root on either device. The
    card's float32 sqrt is an ulp off on some inputs; the float64 root
    rounded to float32 is the correctly rounded one (float64 holds more
    than twice float32's digits), which the CPU's float32 root already
    is. So the card and the CPU give the same bits."""
    return torch.sqrt(x.double()).to(x.dtype)


def _rot_normalize(q):
    """math2d.rot_normalize through _sqrt."""
    mag = _sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1])
    pos = mag > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, mag, 1.0), 0.0)
    return q * inv[..., None]


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
                                  counts, radii, sqrt=torch.sqrt):
    """(N, Sb) particle-to-shape surface distances and world-space outward
    normals (box2d_tpu/particles.py:544-627, same operations in the same
    order, in its transposed (Sb, N) layout); `sqrt` takes the roots
    (_sqrt where the card must give the CPU's bits)."""
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
    dd = torch.where(lane_ok, sqrt(dd2), math.inf)
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
    dlen = sqrt(dcx * dcx + dcy * dcy)
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


def _tunnel_polygons(pos, vel, dt, inv_dt, alive, bs_valid, s_origin,
                     s_rot, s_verts, s_normals, s_count, cull=None,
                     worlds=None):
    """The anti-tunnel ray of a world whose shapes are all polygons: the
    slab ray against the nearby shapes (box2d_tpu/particles.py:1657-1695),
    or, under per-block culling (`cull`, a BlockShapes), against each
    block's own shapes (:1660-1679); the velocity clamped at the first
    nearest hit. worlds: the _Worlds of a batch (each world's particles
    against its own shapes)."""
    W = worlds or _Worlds(1, pos.shape[0])
    step_v = dt * vel
    if cull is None:
        hit, frac, wnx, wny = W.map(
            _ray_polygon_batched, pos, step_v, s_origin, s_rot, s_verts,
            s_normals, s_count)
        hit = hit & W.at_lanes(bs_valid) & alive[:, None]
    else:
        dvp = cull.pad(step_v, 0.0)
        hit, frac, wnx, wny = (cull.flat(x) for x in torch.vmap(
            _ray_polygon_batched)(cull.posp, dvp, cull.origin, cull.rot,
                                  cull.verts, cull.normals, cull.count))
        hit = hit & cull.expand(cull.ok) & alive[:, None]
    frac = torch.where(hit, frac, math.inf)
    fbest, hidx = frac.min(dim=1)      # the first nearest hit
    any_hit = torch.isfinite(fbest)
    hidx = hidx[:, None]
    wn = torch.cat([torch.gather(wnx, 1, hidx),
                    torch.gather(wny, 1, hidx)], dim=1)
    fbh = torch.where(any_hit, fbest, 0.0)
    target = pos + fbh[:, None] * step_v + PARTICLE_LINEAR_SLOP * wn
    return torch.where(any_hit[:, None], inv_dt * (target - pos), vel)


def _tunnel_analytic(pos, vel, dt, inv_dt, alive, bs_valid, s_origin, s_rot,
                     s_type, s_verts, s_normals, s_count, s_radius,
                     geom_types, worlds=None):
    """The anti-tunnel ray of a world with other shapes than polygons
    (box2d_tpu/particles.py:1697-1715): the closed-form ray of every
    (particle, nearby shape) lane through queries.ray_shape_analytic,
    polygons included, a hit needing a fraction above 0; the velocity is
    clamped at the first nearest hit. worlds: the _Worlds of a batch."""
    W = worlds or _Worlds(1, pos.shape[0])
    n, sb = pos.shape[0], s_verts.shape[0] // W.w
    step_v = dt * vel
    at = W.at_lanes
    lo = m.inv_rot_vec(at(s_rot), pos[:, None] - at(s_origin))
    ld = m.inv_rot_vec(at(s_rot), step_v[:, None])
    rep = lambda x: at(x).expand(  # noqa: E731
        (n, sb) + tuple(x.shape[1:])).reshape((n * sb,) + tuple(x.shape[1:]))
    hit, frac, _, lnrm = ray_shape_analytic(
        lo.reshape(-1, 2), ld.reshape(-1, 2), 1.0, rep(s_type),
        rep(s_verts), rep(s_normals), rep(s_count), rep(s_radius),
        geom_types)
    hit = (hit.reshape(n, sb) & at(bs_valid) & alive[:, None])
    frac = frac.reshape(n, sb)
    hit = hit & torch.isfinite(frac) & (frac > 0.0)
    frac = torch.where(hit, frac, math.inf)
    wn = m.rot_vec(at(s_rot), lnrm.reshape(n, sb, 2))
    fbest, best = frac.min(dim=1)      # the first nearest hit
    rows = torch.arange(n, device=pos.device)
    any_hit = hit[rows, best]
    target = (pos + fbest[:, None] * step_v
              + PARTICLE_LINEAR_SLOP * wn[rows, best])
    return torch.where(any_hit[:, None], inv_dt * (target - pos), vel)


# ---------------------------------------------------------------------------
# per-block shape culling
# ---------------------------------------------------------------------------

CULL_BLK = 256   # sorted particles per culling block (particles.py:77)


class BlockShapes(NamedTuple):
    """The shapes each block of CULL_BLK sorted particles couples with this
    sub-iteration: K slots a block, rows (NBlk, K, ...) gathered from the
    per-shape table (box2d_tpu/particles.py:900-959). `ok` marks the
    filled slots; `body` is the slot's body lane, nb for an empty one. In
    a batch of `worlds` each world's n / worlds particles make their own
    blocks (padded alone), world-major."""

    n: int
    worlds: int
    posp: Any       # (NBlk, BLK, 2) positions, padding at 1e9
    ok: Any         # (NBlk, K)
    body: Any       # (NBlk, K) i64
    origin: Any
    rot: Any
    center: Any
    v: Any
    w: Any
    invm: Any       # 0 in an empty slot
    invI: Any
    dyn: Any        # False in an empty slot
    radius: Any
    count: Any
    verts: Any
    normals: Any
    over: Any       # overlapping shapes beyond K, summed over each world's
                    # blocks

    def pad(self, x, fill):
        """(n, ...) per-particle rows -> (NBlk, BLK, ...)."""
        nblk, blk = self.posp.shape[:2]
        w, tail = self.worlds, tuple(x.shape[1:])
        nw = self.n // w
        extra = torch.full((w, nblk // w * blk - nw) + tail, fill,
                           dtype=x.dtype, device=x.device)
        return torch.cat([x.reshape((w, nw) + tail), extra],
                         dim=1).reshape((nblk, blk) + tail)

    def flat(self, x):
        """(NBlk, BLK, K, ...) per-(particle, slot) values -> (n, K, ...)."""
        tail = tuple(x.shape[2:])
        return x.reshape((self.worlds, -1) + tail)[
            :, :self.n // self.worlds].reshape((self.n,) + tail)

    def expand(self, a):
        """(NBlk, K, ...) block rows -> (n, K, ...) per particle."""
        nblk, blk = self.posp.shape[:2]
        return self.flat(a[:, None].expand((nblk, blk) + tuple(a.shape[1:])))

    def block_sum(self, x, exact=False):
        """(n, K, ...) per-(particle, slot) values summed per block:
        (NBlk, K, ...); by _tree_sum where `exact`."""
        x = self.pad(x, 0.0)
        return _tree_sum(x) if exact else x.sum(dim=1)


def _shape_table(s_origin, s_rot, s_center, s_v, s_w, s_invm, s_invI, s_dyn,
                 s_radius, s_count, s_verts, s_normals):
    """The packed per-shape rows (Sb, 14 + 4V) that the culling gathers
    (box2d_tpu/particles.py:718-729)."""
    sb = s_verts.shape[0]
    return torch.cat([
        s_origin, s_rot, s_center, s_v, s_w[:, None], s_invm[:, None],
        s_invI[:, None], s_dyn.float()[:, None], s_radius[:, None],
        s_count.float()[:, None], s_verts.reshape(sb, -1),
        s_normals.reshape(sb, -1)], dim=1)


def _block_shapes(pos, alive, s_fatbox, bs_valid, shape_tab, p_body, k: int,
                  nb: int, n_worlds: int = 1) -> BlockShapes:
    """Each block's top-k overlapping shapes, lowest nearby-shape slot
    first (box2d_tpu/particles.py:900-944). In a batch of n_worlds worlds
    (rows of pos, s_fatbox, bs_valid, shape_tab and p_body world-major)
    each world's particles make their own blocks against its own shapes;
    `over` is then counted per world."""
    n = pos.shape[0]
    w = n_worlds
    nw = n // w
    nblk = -(-nw // CULL_BLK)      # blocks a world
    npad = nblk * CULL_BLK - nw
    dev = pos.device
    posp = torch.cat([pos.reshape(w, nw, 2),
                      torch.full((w, npad, 2), 1e9, device=dev)],
                     dim=1).reshape(w * nblk, CULL_BLK, 2)
    alivep = torch.cat([alive.reshape(w, nw),
                        torch.zeros((w, npad), dtype=torch.bool,
                                    device=dev)],
                       dim=1).reshape(w * nblk, CULL_BLK)
    blk_lo = torch.where(alivep[..., None], posp, math.inf).min(dim=1).values
    blk_hi = torch.where(alivep[..., None], posp, -math.inf).max(dim=1).values
    sb = s_fatbox.shape[0] // w
    lo = blk_lo.reshape(w, nblk, 1, 2)
    hi = blk_hi.reshape(w, nblk, 1, 2)
    fb = s_fatbox.reshape(w, 1, sb, 4)
    ov = ((lo[..., 0] <= fb[..., 2]) & (fb[..., 0] <= hi[..., 0])
          & (lo[..., 1] <= fb[..., 3]) & (fb[..., 1] <= hi[..., 1])
          & bs_valid.reshape(w, 1, sb)).reshape(w * nblk, sb)  # (NBlk, Sb)
    score = torch.where(ov, sb - torch.arange(sb, device=dev)[None, :], 0)
    top, _ = _top_k(score, k)
    ok = top > 0
    j = torch.where(ok, sb - top, 0)
    over = torch.clamp(ov.sum(dim=1) - k, min=0)
    over = (over.sum() if w == 1 else
            over.reshape(w, nblk).sum(dim=1)).to(torch.int32)
    if w > 1:
        # the rows of the block's own world
        j = j + sb * (torch.arange(w * nblk, device=dev) // nblk)[:, None]
    rows = shape_tab[j.reshape(-1)].reshape(w * nblk, k, -1)
    v = (rows.shape[2] - 14) // 4
    return BlockShapes(
        n=n, worlds=w, posp=posp, ok=ok,
        body=torch.where(ok, p_body[j], nb),
        origin=rows[..., 0:2], rot=rows[..., 2:4], center=rows[..., 4:6],
        v=rows[..., 6:8], w=rows[..., 8],
        invm=torch.where(ok, rows[..., 9], 0.0),
        invI=torch.where(ok, rows[..., 10], 0.0),
        dyn=(rows[..., 11] > 0) & ok, radius=rows[..., 12],
        count=rows[..., 13].to(torch.int32),
        verts=rows[..., 14:14 + 2 * v].reshape(w * nblk, k, v, 2),
        normals=rows[..., 14 + 2 * v:].reshape(w * nblk, k, v, 2), over=over)



# ---------------------------------------------------------------------------
# scatters, the cell sort and the windowed neighbour pipeline
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


class SegmentPlan(NamedTuple):
    """The contributions of a scatter-add onto particles or groups,
    regrouped by target: slot (t, s) holds the lane of target t's s-th
    contribution in lane order, or `n`, a zero row past the last lane."""

    lanes: Any      # (T, C) int64
    n: int          # contribution lanes


def _fan_in(idx, n_targets, valid=None):
    """The contributions each target takes, (T,) int64; lanes outside
    `valid` (whose contributions are 0) are not counted."""
    idx = idx.reshape(-1).long()
    if valid is not None:
        idx = torch.where(valid.reshape(-1), idx, n_targets)
    return torch.bincount(idx, minlength=n_targets + 1)[:n_targets]


def _segment_plan(idx, counts, width: int, valid=None) -> SegmentPlan:
    """The SegmentPlan of the targets idx over the `valid` lanes (all if
    None), whose fan-in `counts` (from _fan_in) is at most `width` (read
    from the device by the caller; a wider plan only adds zero halves to
    _tree_sum, so the sums are the same). Lanes outside `valid` must
    contribute 0: they are left out of every target's sum."""
    idx = idx.reshape(-1).long()
    n = idx.shape[0]
    t = counts.shape[0]
    if valid is not None:
        idx = torch.where(valid.reshape(-1), idx, t)
    order = torch.argsort(idx, stable=True)
    tgt = idx[order]
    keep = tgt < t
    tgt, order = tgt[keep], order[keep]
    start = torch.cumsum(counts, 0) - counts
    lanes = torch.full((t, max(width, 1)), n, dtype=torch.long,
                       device=idx.device)
    lanes[tgt, torch.arange(tgt.shape[0], device=idx.device)
          - start[tgt]] = order
    return SegmentPlan(lanes, n)


def _segment_plan_of(idx, n_targets: int) -> SegmentPlan:
    """The SegmentPlan of idx over all its lanes, its width read here."""
    counts = _fan_in(idx, n_targets)
    return _segment_plan(idx, counts, int(counts.max()) if n_targets else 0)


def _tree_sum(x):
    """x summed over dim 1 in a fixed pairwise order (zero padded to a
    power of two). Elementwise adds only: the same bits on the CPU and on
    the card, where a reduction kernel adds in another order."""
    c = x.shape[1]
    p = 1 << max(c - 1, 0).bit_length()
    if p != c:
        x = torch.cat([x, x.new_zeros((x.shape[0], p - c)
                                      + tuple(x.shape[2:]))], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _segment_add(x, plan: SegmentPlan, v):
    """x with the contributions v (one a lane of the plan's index) summed
    per target (_tree_sum, in the plan's order) and added: JAX's
    `x.at[idx].add(v)` up to the order of the adds, and the same bits on
    either device."""
    flat = v.reshape((plan.n,) + tuple(x.shape[1:]))
    flat = torch.cat([flat, flat.new_zeros((1,) + tuple(flat.shape[1:]))])
    return x + _tree_sum(flat[plan.lanes])


def _scatter_min(x, idx, v):
    """x with x[idx] = min(x[idx], v) (JAX `x.at[idx].min(v,
    mode="drop")`): lanes whose index lies outside x are dropped, not
    clipped. A minimum is exact in any order."""
    idx = idx.reshape(-1).long()
    keep = (idx >= 0) & (idx < x.shape[0])
    return x.scatter_reduce(0, torch.where(keep, idx, 0),
                            torch.where(keep, v.reshape(-1), math.inf),
                            "amin", include_self=True)


def _wrap32(x):
    """int64 values wrapped to int32, as JAX's int32 arithmetic wraps."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _shift_up(x, k):
    """The value at sorted lane i + k, zero past the end
    (box2d_tpu/particles.py:384-388)."""
    k = min(k, x.shape[0])
    pad = torch.zeros((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x[k:], pad])


def _shift_down(x, k, n_worlds: int = 1):
    """out[i + k] = x[i], zero before the start (:391-395); in a batch of
    n_worlds worlds (x world-major), before each world's start."""
    if n_worlds > 1:
        return _shift_down(x.reshape((n_worlds, -1) + tuple(x.shape[1:]))
                           .transpose(0, 1), k).transpose(0, 1).reshape(
                               x.shape)
    k = min(k, x.shape[0])
    pad = torch.zeros((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([pad, x[:x.shape[0] - k]])


def _partner_same(x, ks):
    """(n, C...) sorted field -> (n, ks, C...): its values at lanes
    i + 1 .. i + ks (:398-401)."""
    return torch.stack([_shift_up(x, k) for k in range(1, ks + 1)], dim=1)


class PairWindows(NamedTuple):
    """Sorted-space neighbour windows (box2d_tpu/particles.py:404-418).
    The same-row partner of (i, k) is sorted lane i + 1 + k; the row-above
    partner of (i, r) is cand_up[i, r]. Normals and weights are 0 on
    invalid lanes."""

    cand_up: Any   # (n, ku) int64 clipped sorted partner index
    v_same: Any    # (n, ks) bool
    v_up: Any      # (n, ku) bool
    n_same: Any    # (n, ks, 2) unit normal a -> b
    n_up: Any      # (n, ku, 2)
    w_same: Any    # (n, ks) contact weight
    w_up: Any      # (n, ku)


def _find_contacts_sorted(pos, alive, skey, diameter, cfg: ParticleConfig,
                          worlds=None):
    """Neighbour windows over cell-sorted particles (ref:
    FindContacts_Reference :1096-1117; box2d_tpu/particles.py:421-480):
    the next k_same sorted lanes (own and next cell of the row) and k_up
    lanes from the row above, found by one searchsorted. Each pair appears
    once. Returns (PairWindows, overflow): the alive particles whose
    same-row or row-above span exceeds its window; their excess contacts
    are shed this sub-iteration. worlds: the _Worlds of a batch (each
    world sorted in its own lanes; diameter one value a lane, (n, 1)): no
    window reaches past its world's last lane, and each world's overflow
    is counted apart, (W,)."""
    n = pos.shape[0]
    W = worlds or _Worlds(1, n)
    dev = pos.device
    inv_d = 1.0 / diameter
    d2max = diameter * diameter
    ks, ku = cfg.k_same, cfg.k_up
    srow = skey >> 16
    lanes = torch.arange(n, device=dev)
    # lane within its world
    loc = lanes if W.w == 1 else lanes % W.n

    def geom(p_part, al_part, in_rng, row_ok):
        d = p_part - pos[:, None, :]
        dist_sq = m.dot(d, d)
        valid = (alive[:, None] & al_part & in_rng & row_ok
                 & (dist_sq < d2max))
        pos_sq = dist_sq > 0
        inv_dist = torch.where(
            pos_sq, 1.0 / _sqrt(torch.where(pos_sq, dist_sq, 1.0)),
            0.0)
        normal = d * inv_dist[..., None]
        weight = 1.0 - dist_sq * inv_dist * inv_d    # ref :1091
        return (valid, torch.where(valid[..., None], normal, 0.0),
                torch.where(valid, weight, 0.0))

    # same-row window: static shifts
    in_rng_s = (loc[:, None]
                + torch.arange(1, ks + 1, device=dev)[None, :]) < W.n
    v_same, n_same, w_same = geom(
        _partner_same(pos, ks), _partner_same(alive, ks), in_rng_s,
        _partner_same(srow, ks) == srow[:, None])

    # row-above window: searchsorted for key(y + 1, x - 1), one packed
    # partner gather
    skey64 = skey.long()
    start_up = W.search(skey, _wrap32(skey64 + (1 << 16) - 1))
    raw_up = start_up[:, None] + torch.arange(ku, device=dev)[None, :]
    cand_up = raw_up.clamp(0, W.n - 1)
    if W.w > 1:
        cand_up = cand_up + (lanes - loc)[:, None]
    ptab = torch.cat([pos, srow.float()[:, None], alive.float()[:, None]],
                     dim=1)
    pu = ptab[cand_up]                                   # (n, ku, 4)
    v_up, n_up, w_up = geom(
        pu[..., :2], pu[..., 3] > 0, raw_up < W.n,
        pu[..., 2].to(torch.int32) == srow[:, None] + 1)

    # window-overflow accounting
    same_end = W.search(skey, _wrap32(skey64 + 2))
    up_end = W.search(skey, _wrap32(skey64 + (1 << 16) + 2))
    over = alive & (((same_end - loc - 1) > ks)
                    | ((up_end - start_up) > ku))
    return (PairWindows(cand_up, v_same, v_up, n_same, n_up, w_same, w_up),
            W.sum(over).to(torch.int32))


def _pair_accum(a_same, a_up, b_same, b_up, cand_up, n, plan=None,
                n_worlds: int = 1):
    """Per-pair contributions summed per particle in sorted space
    (box2d_tpu/particles.py:483-494): out[i] += sum_k a_same[i, k] +
    sum_r a_up[i, r]; out[i + 1 + k] += b_same[i, k] (static shifts,
    within each of n_worlds worlds); out[cand_up[i, r]] += b_up[i, r] (the
    one scatter, through `plan`, the SegmentPlan of cand_up, made here if
    not given). Contributions are already 0 on invalid lanes."""
    out = _tree_sum(a_same) + _tree_sum(a_up)
    for k in range(1, a_same.shape[1] + 1):
        out = out + _shift_down(b_same[:, k - 1], k, n_worlds)
    if plan is None:
        plan = _segment_plan_of(cand_up, n)
    return _segment_add(out, plan, b_up)


# ---------------------------------------------------------------------------
# barrier and rigid groups
# ---------------------------------------------------------------------------

def _solve_barrier(pair_a, pair_b, pair_flags, group, alive, radius, pos,
                   vel, dt, same_world=None):
    """Barrier pass (ref: SolveBarrier :1670-1760;
    box2d_tpu/particles.py:1450-1540): every pair flagged P_BARRIER is a
    moving segment; a particle of another group whose relative trajectory
    crosses it within dt takes the barrier point's velocity (the removed
    momentum is absorbed, as the JAX package does), and a particle within
    one radius of a segment loses its approach component toward it.
    Dense over (pairs x particles). pair_a / pair_b are sorted lanes;
    radius is 0-d or one value a particle. same_world: in a batch of
    worlds, the (pairs, particles) mask of a pair and a particle of one
    world (a segment blocks only its own world's particles).
    Returns the new velocity."""
    ba, bb = pair_a.long(), pair_b.long()
    is_bar = ((pair_flags & P_BARRIER) != 0) & alive[ba] & alive[bb]
    if same_world is not None:
        is_bar = is_bar[:, None] & same_world
    else:
        is_bar = is_bar[:, None]
    lanes = torch.arange(pos.shape[0], device=pos.device)
    pa, pb = pos[ba], pos[bb]
    va, vb = vel[ba], vel[bb]
    cr = m.cross

    # per (pair, particle) relative kinematics: the segment point at (s, t)
    # is qa + s e(t) + t wa with e(t) = e0 + t de, relative to the particle
    qa = pa[:, None, :] - pos[None, :, :]                    # (Pb, Np, 2)
    wa = va[:, None, :] - vel[None, :, :]
    e0 = (pb - pa)[:, None, :]
    de = (vb - va)[:, None, :]
    c0 = cr(qa, e0)
    c1 = cr(qa, de) + cr(wa, e0)
    c2 = cr(wa, de)
    eps = 1e-9
    # candidate crossing times: the linear root and both quadratic roots
    t_lin = _safe_div(-c0, c1)
    disc = c1 * c1 - 4.0 * c0 * c2
    sq = _sqrt(disc.clamp(min=0.0))
    t_q1 = _safe_div(-c1 - sq, 2.0 * c2)
    t_q2 = _safe_div(-c1 + sq, 2.0 * c2)
    lin = c2.abs() < eps
    ok_lin = lin & (c1.abs() > eps)
    ok_q = ~lin & (disc >= 0.0)
    cand_t = torch.stack([t_lin, t_q1, t_q2], dim=-1)        # (Pb, Np, 3)
    cand_ok = torch.stack([ok_lin, ok_q, ok_q], dim=-1)
    et = e0[:, :, None, :] + cand_t[..., None] * de[:, :, None, :]
    pr = qa[:, :, None, :] + cand_t[..., None] * wa[:, :, None, :]
    s = _safe_div(-m.dot(pr, et), m.dot(et, et))
    same_group = group[ba][:, None] == group[None, :]
    valid = (cand_ok & (cand_t >= 0.0) & (cand_t <= dt)
             & (s >= 0.0) & (s <= 1.0) & is_bar[:, :, None]
             & (~same_group)[:, :, None] & alive[None, :, None])
    t_sel = torch.where(valid, cand_t, math.inf)
    # earliest hit over the candidates, then over the pairs (first minimum)
    t_pair = t_sel.min(dim=-1).values                        # (Pb, Np)
    s_pair = torch.gather(s, -1, t_sel.argmin(dim=-1)[..., None])[..., 0]
    k = t_pair.argmin(dim=0)                                 # (Np,)
    hit = torch.isfinite(t_pair.min(dim=0).values)
    s_hit = s_pair[k, lanes]
    v_s = va[k] + s_hit[:, None] * (vb[k] - va[k])
    vel = vel + torch.where(hit[:, None], v_s - vel, 0.0)

    # proximity guard: particles pressed within one radius of a segment
    # lose their approach component toward it (two-sided)
    e2 = m.dot(e0, e0).clamp(min=1e-12)
    s_c = (-m.dot(qa, e0) / e2).clamp(0.0, 1.0)             # (Pb, Np)
    cl = qa + s_c[..., None] * e0        # particle -> closest segment point
    d2 = m.dot(cl, cl)
    near = (is_bar & ~same_group & alive[None, :]
            & (d2 < radius * radius))
    d2m = torch.where(near, d2, math.inf)
    kn = d2m.argmin(dim=0)
    has_near = torch.isfinite(d2m.min(dim=0).values)
    dn = _sqrt(d2[kn, lanes].clamp(min=1e-12))
    n_vec = cl[kn, lanes] / torch.where(dn != 0.0, dn, 1.0)[:, None]
    s_n = s_c[kn, lanes]
    v_seg = va[kn] + s_n[:, None] * (vb[kn] - va[kn])
    appr = m.dot(vel - v_seg, n_vec)                         # > 0: toward
    cut = torch.where(has_near & (appr > 0.0), appr, 0.0)
    return vel - cut[:, None] * n_vec


def _rigid_group_stats(group, group_flags, alive, pos, vel, mass,
                       plan=None):
    """Per-rigid-group mass statistics (ref: ParticleGroup.UpdateStatistics
    :42-120; box2d_tpu/particles.py:1543-1571): returns (in_rigid (Np,),
    n_groups, center, linvel, omega, inv_mass, inv_inertia), the last five
    per group. plan: the SegmentPlan of the particles' groups (made here
    if not given)."""
    g = group.clamp(min=0).long()
    ng = group_flags.shape[0]
    rigid = (group_flags & G_RIGID) != 0
    in_rigid = alive & (group >= 0) & rigid[g]
    w1 = torch.where(in_rigid, 1.0, 0.0)
    if plan is None:
        plan = _segment_plan_of(g, ng)

    def gsum(v):
        return _segment_add(torch.zeros(ng, dtype=torch.float32,
                                        device=pos.device), plan, v)

    cnt = gsum(w1)
    safe = cnt.clamp(min=1.0)
    center = torch.stack([gsum(w1 * pos[:, 0]) / safe,
                          gsum(w1 * pos[:, 1]) / safe], dim=-1)
    linvel = torch.stack([gsum(w1 * vel[:, 0]) / safe,
                          gsum(w1 * vel[:, 1]) / safe], dim=-1)
    rel = pos - center[g]
    relv = vel - linvel[g]
    inertia_u = gsum(w1 * m.dot(rel, rel))
    angm = gsum(w1 * m.cross(rel, relv))
    omega = _safe_div(angm, inertia_u.clamp(min=1e-9))
    inv_m = torch.where(cnt > 0, _safe_div(1.0, mass * cnt), 0.0)
    inv_i = torch.where(inertia_u > 1e-9, _safe_div(1.0, mass * inertia_u),
                        0.0)
    return in_rigid, ng, center, linvel, omega, inv_m, inv_i


def _solve_rigid(group, group_flags, alive, pos, vel, mass, plan=None):
    """ref: SolveRigid (box2d_tpu/particles.py:1574-1582): members of a
    rigid group take the rigid-motion velocity of its statistics."""
    in_rigid, _, center, linvel, omega, _, _ = _rigid_group_stats(
        group, group_flags, alive, pos, vel, mass, plan)
    g = group.clamp(min=0).long()
    v_rigid = linvel[g] + m.cross_sv(omega[g], pos - center[g])
    return torch.where(in_rigid[:, None], v_rigid, vel)


def _relax_depth(d, ia, ib, same, r_edge, big_d, cap, stats):
    """The solid groups' depth relaxation (box2d_tpu/particles.py:1043-1053):
    rounds of d[a] = min(d[a], d[b] + r) over same-group contact edges
    until a round shrinks nothing, at most `cap` rounds. The device is
    read every CHECK_EVERY rounds: a round after the fixed point changes
    nothing, so the result is the JAX loop's, and never past the cap."""
    rounds = 0
    while rounds < cap:
        dn = _scatter_min(d, ia, torch.where(same, d[ib] + r_edge, big_d))
        dn = _scatter_min(dn, ib, torch.where(same, d[ia] + r_edge, big_d))
        rounds += 1
        changed = dn < d
        d = dn
        if rounds % CHECK_EVERY == 0 and rounds < cap:
            stats.rounds["reads"] += 1
            (more,) = stats.read(changed.any())
            if not more:
                break
    stats.rounds["depth"] += rounds
    return d


# ---------------------------------------------------------------------------
# the particle step
# ---------------------------------------------------------------------------

def particle_step(pt: Particles, state: WorldState, dt, cfg: ParticleConfig,
                  stats=None, n_worlds: int = 1):
    """One full particle update (ref: Solve :1512-1564;
    box2d_tpu/particles.py:642-1447). Returns (particles, body_dv (Nb, 2),
    body_dw (Nb,), neighbor_overflow): the nearby shapes beyond
    max_body_shapes plus the worst sub-iteration's sum of particles whose
    spans exceed the neighbour windows (the windowed path; K3 never
    truncates) and, under per-block culling, overlapping shapes beyond the
    blocks' slots.

    stats: a world.StepStats; counts the device reads (the rank repair's
    branch, the depth pass's gate, the depth relaxation's checks), which
    sort each sub-iteration took (rank_repairs / full_sorts) and the depth
    relaxation's rounds.

    n_worlds: W > 1 steps a batch of W worlds of one configuration (the
    counterpart of jax.vmap of the JAX step; batch.py): pt and state are
    laid flat, world-major, as batch.py lays them (world w's particle
    lanes [w * n, (w + 1) * n), its shapes, bodies, pairs, triads and
    groups likewise, every id offset to its own lanes), pt.params and
    state.tuning hold one value a world. Each world sorts its own cells,
    couples with its own nearby shapes (and blocks) only and sums its own
    neighbours (K3 batched, one launch a phase for all worlds); body_dv /
    body_dw are the flat bodies' and the overflow is (W,). The rank
    repair is never taken, whatever cfg.rank_repair says: the JAX package
    keeps it off under vmap (box2d_tpu/particles.py:186-190). A step's
    device reads do not grow with W: each is an any or a max over the
    worlds."""
    if stats is None:
        from .world import StepStats
        stats = StepStats()
    sh = state.shapes
    prm: ParticleParams = pt.params
    b = state.bodies
    nb = b.center.shape[0]
    n = pt.pos.shape[0]
    dev = pt.pos.device
    f32 = np.float32
    W = _Worlds(n_worlds, n // n_worlds)
    batched = n_worlds > 1

    # a world's value at each particle lane (one world: the value itself),
    # as a column against (n, C), and at each lane of the flat pair view
    def lane_v(x):
        return W.rows(x, W.n)

    def lane_c(x):
        return _lanes(lane_v(x), 2)

    def pair_v(x):
        return W.rows(x, W.n * (cfg.k_same + cfg.k_up))

    def pair_c(x):
        return _lanes(pair_v(x), 2)

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
    zero = torch.zeros_like(inv_diameter)
    # K3's scalars: (8,), or a row a world
    scal_k = torch.stack([inv_diameter, diameter * diameter, lin_d, quad_d,
                          vel_per_p, zero, zero, zero], dim=-1)

    # nearby rigid shapes, compacted once per step (system AABB prefilter),
    # each world against its own shapes
    alive0 = pt.alive[:, None]
    sys_lo = W.view(torch.where(alive0, pt.pos, math.inf)).min(
        dim=-2).values - _lanes(diameter, 2)
    sys_hi = W.view(torch.where(alive0, pt.pos, -math.inf)).max(
        dim=-2).values + _lanes(diameter, 2)
    boxes = compute_shape_aabbs(state)
    S = sh.type.shape[0] // n_worlds
    lo_s, hi_s = W.rows(sys_lo, S), W.rows(sys_hi, S)
    near = W.view((boxes[:, 0] <= hi_s[..., 0]) & (lo_s[..., 0] <= boxes[:, 2])
                  & (boxes[:, 1] <= hi_s[..., 1])
                  & (lo_s[..., 1] <= boxes[:, 3])
                  & sh.enabled & b.enabled[sh.body.long()] & ~sh.is_sensor)
    sscore = torch.where(near, S - torch.arange(S, device=dev), 0)
    stop, _ = _top_k(sscore, min(cfg.max_body_shapes, S))
    bs_valid = stop > 0
    bs_idx = torch.where(bs_valid, S - stop, 0)
    shape_overflow = torch.clamp(near.sum(-1) - bs_valid.sum(-1),
                                 min=0).to(torch.int32)
    if batched:
        # each world's nearby shapes as rows of the flat shape lanes
        bs_idx = (bs_idx + S * torch.arange(n_worlds, device=dev)[:, None]
                  ).reshape(-1)
        bs_valid = bs_valid.reshape(-1)

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

    # per-block culling when the nearby shapes outnumber a block's slots:
    # the shapes' boxes grown by the coupling radius and one diameter of
    # travel (a particle moves under a diameter a sub-iteration)
    sb = bs_idx.shape[0] // n_worlds
    use_cull = sb > cfg.block_shape_slots
    if use_cull:
        marg = _lanes(W.rows(prm.radius + diameter + PARTICLE_LINEAR_SLOP,
                             sb), 2)
        s_boxes = boxes[bs_idx]
        s_fatbox = torch.where(
            bs_valid[:, None],
            torch.cat([s_boxes[:, :2] - marg, s_boxes[:, 2:] + marg], dim=1),
            math.inf)
        shape_tab = _shape_table(s_origin, s_rot, s_center, s_v, s_w, s_invm,
                                 s_invI, s_dyn, s_radius, s_count, s_verts,
                                 s_normals)

    body_dv = torch.zeros((nb, 2), dtype=torch.float32, device=dev)
    body_dw = torch.zeros(nb, dtype=torch.float32, device=dev)
    polygons_only = (cfg.geom_types is not None
                     and cfg.geom_types <= {POLYGON})

    # which gated passes need the flat (ia, ib) pair view, and which the
    # pair / triad remap (:731-738); either turns K3 and K4 off (:757)
    need_flat = (cfg.has_viscous or cfg.has_repulsive or cfg.has_powder
                 or cfg.has_tensile or cfg.has_solid
                 or cfg.has_static_pressure or cfg.has_colormix
                 or cfg.has_rigid)
    need_inv = cfg.has_elastic or cfg.has_spring or cfg.has_barrier
    use_kernel = cfg.use_window_kernel and not need_flat and not need_inv
    ks, ku = cfg.k_same, cfg.k_up
    if cfg.has_barrier:
        # the pair lanes flagged P_BARRIER, once a step (nonzero reads the
        # device once): the barrier pass runs over these alone. Every
        # other lane is masked out of its minima, so the result is that
        # of all lanes, and with none the pass changes nothing
        bar_lanes = torch.nonzero((pt.pair_flags & P_BARRIER) != 0)[:, 0]
        stats.syncs += 1
    # off the K3 path every sum runs in a fixed order on either device
    exact = not use_kernel
    root = _sqrt if exact else torch.sqrt
    rsum = _tree_sum if exact else functools.partial(torch.sum, dim=1)

    # the SegmentPlans of the triad, spring and group scatters, built once
    # a step over original lanes with one read of their widest fan-in: a
    # sub-iteration's permutation moves whole rows of the triad and spring
    # plans (their targets are particles) and renames the lanes of the
    # group plan (its contributions are), never a target's count. Only the
    # lanes that can contribute count (elastic triads, springs, the
    # members of rigid groups); the others add 0
    ng = pt.group_flags.shape[0]
    fixed = []
    if cfg.has_elastic:
        tri_ok = (pt.triad_flags & P_ELASTIC) != 0
        fixed += [("ta", pt.triad_a, n, tri_ok), ("tb", pt.triad_b, n, tri_ok),
                  ("tc", pt.triad_c, n, tri_ok)]
    if cfg.has_spring:
        spr_ok = (pt.pair_flags & P_SPRING) != 0
        fixed += [("sa", pt.pair_a, n, spr_ok), ("sb", pt.pair_b, n, spr_ok)]
    if cfg.has_rigid:
        gp0 = pt.group.clamp(min=0)
        fixed += [("g", gp0, ng, (pt.group >= 0)
                   & ((pt.group_flags & G_RIGID) != 0)[gp0])]
    counts = [_fan_in(x, t, ok) for _, x, t, ok in fixed]
    plan0 = {name: _segment_plan(x, c, w, ok) for (name, x, _, ok), c, w in
             zip(fixed, counts, stats.read(*(c.max() for c in counts))
                 if fixed else ())}
    if exact and not use_cull:
        # the shapes' bodies: a body holds at most Sb of the nearby shapes
        # (a wider plan only pads), so no read
        plan_body = _segment_plan(p_body, _fan_in(p_body, nb), sb)

    # the carry stays in the PREVIOUS sub-iteration's sorted order; s2o maps
    # sorted position -> original lane, skey_prev is the key it was sorted
    # by. Pair and triad ids stay original-lane ids throughout: each
    # sub-iteration remaps its own copies (:825-838), so the carry always
    # holds the originals (:1382-1387)
    cur_pos, cur_vel, cur_force = pt.pos, pt.vel, pt.force
    cur_exp, cur_sp = pt.expiration, pt.static_pressure
    cur_flags, cur_group, cur_alive = pt.flags, pt.group, pt.alive
    cur_depth, cur_color = pt.depth, pt.color
    gflags = pt.group_flags
    s2o = torch.arange(n, dtype=torch.int32, device=dev)
    skey_prev = _cell_key(pt.pos, pt.alive, lane_v(inv_diameter))
    bc_cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    # the worst sub-iteration's window and culling overflow (one a world)
    iter_over = torch.zeros(() if not batched else (n_worlds,),
                            dtype=torch.int32, device=dev)
    nbk = -(-n // pk.B_BLK)
    rbw = pk.rank_window(n)
    if need_flat:
        lanes = torch.arange(n, device=dev)
        if batched:
            loc = lanes % W.n
    if cfg.has_rigid:
        # the particle mass at each group of a world (rigid statistics)
        g_mass = W.rows(mass, pt.group_flags.shape[0] // n_worlds)
    if batched:
        # (world, cell) sort keys: each world's lanes stay together, in
        # its own cell order, equal keys in lane order
        lane_world = torch.arange(n, device=dev) // W.n
        world_key = lane_world << 32
        if cfg.has_barrier:
            # a barrier segment and a particle of one world
            bar_world = bar_lanes // (pt.pair_a.shape[0] // n_worlds)
            same_world = bar_world[:, None] == lane_world[None, :]
    for _ in range(cfg.iterations):
        # ---- cell sort: the whole sub-iteration runs in sorted space ----
        key = _cell_key(cur_pos, cur_alive, lane_v(inv_diameter))
        use_rank = False
        if cfg.rank_repair and use_kernel and n > 0 and not batched:
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
            rank = _sort_rank(key if not batched else
                              world_key | (key.long() - pk.INT32_MIN))
            stats.full_sorts += 1
        # one packed permutation of every field the sub-iteration carries
        # (float columns ride as their int32 bits, so the copy is exact),
        # with the depth and colour columns where a pass needs them
        # (:797-824)
        ints = torch.stack([cur_flags, cur_group, cur_alive.to(torch.int32),
                            s2o, key], dim=1)
        fcols = [cur_pos, cur_vel, cur_force, cur_exp[:, None],
                 cur_sp[:, None]]
        if cfg.has_solid:
            fcols.append(cur_depth[:, None])
        if cfg.has_colormix:
            fcols.append(cur_color.reshape(n, -1))
        floats = torch.cat(fcols, dim=1)
        nf = floats.shape[1]
        pack = _scatter_rows(torch.cat([floats.view(torch.int32), ints],
                                       dim=1), rank)
        fp = pack[:, :nf].view(torch.float32)
        pos, vel, force = fp[:, 0:2], fp[:, 2:4], fp[:, 4:6]
        expiration, static_pressure = fp[:, 6], fp[:, 7]
        c_at = 8
        if cfg.has_solid:
            depth = fp[:, c_at]
            c_at += 1
        if cfg.has_colormix:
            col = fp[:, c_at:c_at + cur_color.shape[1]].reshape(
                cur_color.shape)
        flags, group = pack[:, nf], pack[:, nf + 1]
        alive = pack[:, nf + 2] > 0
        s2o = pack[:, nf + 3]
        skey = pack[:, nf + 4].contiguous()
        pos_c = pos.contiguous()
        if need_inv or cfg.has_rigid:
            # pair and triad ids are original lanes; map them to this
            # sub-iteration's sorted lanes (:825-838)
            inv_order = _scatter_rows(torch.arange(n, dtype=torch.int32,
                                                   device=dev), s2o)

            def remap(idx):
                return torch.where(idx >= 0,
                                   inv_order[idx.clamp(min=0).long()], idx)

            tri_a, tri_b, tri_c = (remap(pt.triad_a), remap(pt.triad_b),
                                   remap(pt.triad_c))
            pr_a, pr_b = remap(pt.pair_a), remap(pt.pair_b)
            # the step's plans in sorted space: a particle target's row is
            # its original lane's; a particle contribution is renamed
            s2o_l = s2o.long()
            plans = {k: SegmentPlan(p.lanes[s2o_l], p.n)
                     for k, p in plan0.items() if k != "g"}
            if cfg.has_rigid:
                sorted_of = torch.cat([inv_order.long(),
                                       s2o_l.new_full((1,), n)])
                plan_g = SegmentPlan(sorted_of[plan0["g"].lanes], n)

        def k3(p0, p1, phase):
            """K3 on this sub-iteration's table: one launch for all worlds
            of a batch."""
            if not batched:
                return pk.window_pass(pos_c, skey, alive, p0, p1, scal_k,
                                      phase)
            return pk.window_pass_batched(
                *(W.view(x) for x in (pos_c, skey, alive, p0, p1)), scal_k,
                phase).reshape(n, 2)

        # ---- neighbour contacts (ref UpdateContacts) ----
        if use_kernel:
            zcol = torch.zeros(n, dtype=torch.float32, device=dev)
            w_pairs = k3(zcol, zcol, pk.PH_WEIGHT)[:, 0]
            c_over = None      # K3 never truncates
        else:
            pw, c_over = _find_contacts_sorted(pos_c, alive, skey,
                                               lane_c(diameter), cfg, W)
        if need_flat:
            # the flat sorted-space pair view of the gated passes
            # (:880-893): lane (i, k) pairs sorted lane ia = i with ib
            if not batched:
                idx_same = (lanes[:, None]
                            + torch.arange(1, ks + 1, device=dev)[None, :]
                            ).clamp(0, n - 1)
            else:
                idx_same = (loc[:, None]
                            + torch.arange(1, ks + 1, device=dev)[None, :]
                            ).clamp(0, W.n - 1) + (lanes - loc)[:, None]
            cand = torch.cat([idx_same, pw.cand_up], dim=1)
            ia = lanes[:, None].expand(cand.shape).reshape(-1)
            ib = cand.reshape(-1)
            c_ok = torch.cat([pw.v_same, pw.v_up], dim=1).reshape(-1)
            c_n = torch.cat([pw.n_same, pw.n_up], dim=1).reshape(-1, 2)
            c_w = torch.cat([pw.w_same, pw.w_up], dim=1).reshape(-1)
            c_flags = torch.where(c_ok, flags[ia] | flags[ib], 0)
        # ---- body contacts (ref UpdateBodyContacts): dense over Sb, or
        # each block's K culled shapes ----
        if use_cull:
            cull = _block_shapes(pos, alive, s_fatbox, bs_valid, shape_tab,
                                 p_body, cfg.block_shape_slots, nb, n_worlds)
            bdist, bnrm = (cull.flat(x) for x in torch.vmap(
                functools.partial(_point_shape_distance_batched, sqrt=root))(
                    cull.posp, cull.origin, cull.rot, cull.verts,
                    cull.normals, cull.count, cull.radius))
            bc_valid = cull.expand(cull.ok)
            e_center, e_v, e_w = (cull.expand(cull.center),
                                  cull.expand(cull.v), cull.expand(cull.w))
            e_invm, e_invI = cull.expand(cull.invm), cull.expand(cull.invI)
            e_dyn = cull.expand(cull.dyn)
            c_over = cull.over if c_over is None else c_over + cull.over
        else:
            cull = None
            bdist, bnrm = W.map(
                functools.partial(_point_shape_distance_batched, sqrt=root),
                pos, s_origin, s_rot, s_verts, s_normals, s_count, s_radius)
            bc_valid = W.at_lanes(bs_valid)
            e_center, e_v, e_w = (W.at_lanes(s_center), W.at_lanes(s_v),
                                  W.at_lanes(s_w))
            e_invm, e_invI, e_dyn = (W.at_lanes(s_invm), W.at_lanes(s_invI),
                                     W.at_lanes(s_dyn))

        if exact:
            # the SegmentPlans of the row-above partners, of the flat
            # view's partners and of the culled slots' bodies, one read for
            # all a sub-iteration
            fans = [(pw.cand_up, n, pw.v_up)]
            if need_flat:
                fans.append((ib, n, c_ok))
            if cull is not None:
                fans.append((cull.body, nb, cull.ok))
            fans = [(idx, ok, _fan_in(idx, t, ok)) for idx, t, ok in fans]
            sub = [_segment_plan(idx, cnt, w, ok) for (idx, ok, cnt), w in
                   zip(fans, stats.read(*(c.max() for _, _, c in fans)))]
            plan_up = sub[0]
            if need_flat:
                plan_ib = sub[1]
            if cull is not None:
                plan_body = sub[-1]
        if need_flat:
            def pair_add(x, fa, fb):
                """x.at[ia].add(fa).at[ib].add(fb): each row's own lanes
                summed by _tree_sum, the partners' through plan_ib."""
                own = _tree_sum(fa.reshape((n, ks + ku) + tuple(x.shape[1:])))
                return _segment_add(x + own, plan_ib, fb)

        def body_vel_at():
            """Body surface velocity at the particles, (n, C, 2)."""
            return e_v + m.cross_sv(e_w, pos[:, None, :] - e_center)

        def apply_body_impulse(dv, dw, impulse, active):
            """Sum the (n, C, 2) per-contact impulses per shape (dense, C =
            Sb) or per (block, slot) (culled, C = K), then add them to the
            shapes' bodies (box2d_tpu/particles.py:977-1000). The culled
            rows are this sub-iteration's `cull`, never a rebound name.
            Off the K3 path both sums take _tree_sum and the bodies'
            plan_body; empty slots add nothing (JAX mode="drop")."""
            imp = torch.where((active & e_dyn)[..., None], impulse, 0.0)
            ang = m.cross(pos[:, None, :] - e_center, imp)
            if cull is None:
                if exact:
                    return (_segment_add(dv, plan_body, W.shape_sum(
                                imp, True) * s_invm[:, None]),
                            _segment_add(dw, plan_body, s_invI * W.shape_sum(
                                ang, True)))
                dv = dv.index_add(0, p_body,
                                  W.shape_sum(imp) * s_invm[:, None])
                dw = dw.index_add(0, p_body, s_invI * W.shape_sum(ang))
                return dv, dw
            if exact:
                return (_segment_add(dv, plan_body, cull.block_sum(imp, True)
                                     * cull.invm[..., None]),
                        _segment_add(dw, plan_body,
                                     cull.invI * cull.block_sum(ang, True)))
            # empty slots add into a spare row nb
            tgt = cull.body.reshape(-1)
            dv = torch.cat([dv, dv[:1]]).index_add(
                0, tgt, (cull.block_sum(imp) * cull.invm[..., None]).reshape(
                    -1, 2))[:nb]
            dw = torch.cat([dw, dw[:1]]).index_add(
                0, tgt, (cull.invI * cull.block_sum(ang)).reshape(-1))[:nb]
            return dv, dw

        bc_ok = (bdist < lane_c(prm.radius)) & alive[:, None] & bc_valid
        bc_n = -bnrm
        bc_w = torch.where(bc_ok, 1.0 - bdist * lane_c(inv_diameter) * 2.0,
                           0.0)
        rpn = m.cross(pos[:, None, :] - e_center, bnrm)
        wall = (flags & P_WALL) != 0
        inv_m_c = (torch.where(wall, 0.0, lane_v(inv_mass))[:, None]
                   + e_invm + e_invI * rpn * rpn)
        bc_mass = torch.where(
            inv_m_c > 0, 1.0 / torch.where(inv_m_c > 0, inv_m_c, 1.0), 0.0)
        bc_mass = torch.where(bc_ok, bc_mass, 0.0)

        # ---- weight (ref ComputeWeight, :1016-1019) ----
        if use_kernel:
            weight = w_pairs + bc_w.sum(dim=1)
        else:
            weight = _pair_accum(pw.w_same, pw.w_up, pw.w_same, pw.w_up,
                                 pw.cand_up, n, plan_up, n_worlds
                                 ) + _tree_sum(bc_w)

        if cfg.has_solid:
            # ---- depth relaxation (ref ComputeDepth :1002-1062; :1021-
            # 1062): groups flagged G_NEEDS_DEPTH seed their surface
            # (contact weight < 0.8) at depth 0 and relax inner depths
            # over same-group contacts, then clear the flag; skipped when
            # no group is flagged (one read, the JAX lax.cond)
            needs = (gflags & G_NEEDS_DEPTH) != 0
            (any_needs,) = stats.read(needs.any())
            if any_needs:
                ga, gb = group[ia], group[ib]
                same = (c_ok & (ga == gb) & (ga >= 0)
                        & needs[ga.clamp(min=0).long()])
                cw_same = torch.where(same, c_w, 0.0)
                w_acc = pair_add(torch.zeros(n, dtype=torch.float32,
                                             device=dev), cw_same, cw_same)
                upd = (alive & (group >= 0)
                       & needs[group.clamp(min=0).long()])
                big_d = 1e9
                d = _relax_depth(
                    torch.where(w_acc < 0.8, 0.0, big_d), ia, ib, same,
                    torch.where(same, 1.0 - c_w, big_d), big_d,
                    cfg.depth_iterations, stats)
                d = torch.where(d < big_d, d * lane_v(diameter), 0.0)
                depth = torch.where(upd, d, depth)
                gflags = gflags & ~(needs.to(torch.int32) * G_NEEDS_DEPTH)

        # ---- force (user forces, ref SolveForce) ----
        vel = vel + lane_c(dt * inv_mass) * force

        if cfg.has_viscous:
            # ---- viscous (ref SolveViscous, :1067-1080) ----
            visc = (c_flags & P_VISCOUS) != 0
            f = pair_c(prm.viscous_strength) * c_w[:, None] * (
                vel[ib] - vel[ia])
            f = torch.where(visc[:, None], f, 0.0)
            vel = pair_add(vel, f, -f)
            bvisc = bc_ok & ((flags & P_VISCOUS) != 0)[:, None]
            fb = (lane_c(prm.viscous_strength) * bc_mass * bc_w)[
                ..., None] * (body_vel_at() - vel[:, None, :])
            fb = torch.where(bvisc[..., None], fb, 0.0)
            vel = vel + lane_c(inv_mass) * rsum(fb)
            body_dv, body_dw = apply_body_impulse(body_dv, body_dw, -fb,
                                                  bvisc)

        if cfg.has_repulsive:
            # ---- repulsive (ref SolveRepulsive, :1082-1087) ----
            rep = (((c_flags & P_REPULSIVE) != 0)
                   & (group[ia] != group[ib]))
            f = (pair_v(prm.repulsive_strength * crit_v) * c_w)[
                :, None] * c_n
            f = torch.where(rep[:, None], f, 0.0)
            vel = pair_add(vel, -f, f)

        if cfg.has_powder:
            # ---- powder (ref SolvePowder, :1089-1095) ----
            min_w = 1.0 - PARTICLE_STRIDE
            pow_ = ((c_flags & P_POWDER) != 0) & (c_w > min_w)
            f = (pair_v(prm.powder_strength * crit_v)
                 * (c_w - min_w))[:, None] * c_n
            f = torch.where(pow_[:, None], f, 0.0)
            vel = pair_add(vel, -f, f)

        if cfg.has_tensile:
            # ---- tensile (ref SolveTensile, :1097-1111) ----
            tens = (c_flags & P_TENSILE) != 0
            wn = ((1.0 - c_w) * c_w)[:, None] * c_n
            wn = torch.where(tens[:, None], wn, 0.0)
            acc2 = pair_add(torch.zeros((n, 2), dtype=torch.float32,
                                        device=dev), -wn, wn)
            p_s = pair_v(prm.surface_tension_pressure * crit_v)
            n_s = pair_v(prm.surface_tension_normal * crit_v)
            max_var = pair_v(MAX_PARTICLE_FORCE * crit_v)
            fh = torch.minimum(
                p_s * (weight[ia] + weight[ib] - 2.0)
                + n_s * m.dot(acc2[ib] - acc2[ia], c_n), max_var) * c_w
            f = torch.where(tens, fh, 0.0)[:, None] * c_n
            vel = pair_add(vel, -f, f)

        if cfg.has_solid:
            # ---- solid ejection (ref SolveSolid :2200; :1113-1119) ----
            sol = (group[ia] != group[ib]) & c_ok
            ej = (pair_v(prm.ejection_strength * inv_dt)
                  * (depth[ia] + depth[ib]) * c_w)
            f = torch.where(sol, ej, 0.0)[:, None] * c_n
            vel = pair_add(vel, -f, f)

        # ---- gravity (ref SolveGravity) ----
        g_ = _lanes(dt * prm.gravity_scale, 2) * state.tuning.gravity
        vel = vel + torch.where(alive[:, None], lane_v(g_), 0.0)

        sp_mask = (flags & P_STATIC_PRESSURE) != 0
        if cfg.has_static_pressure:
            # ---- static pressure (ref SolveStaticPressure, :1127-1145):
            # a fixed number of relaxation rounds ----
            pp_w = lane_v(prm.static_pressure_strength * crit_p)
            max_p = lane_v(MAX_PARTICLE_PRESSURE * crit_p)
            relax = lane_v(prm.static_pressure_relaxation)
            cw_sp = torch.where((c_flags & P_STATIC_PRESSURE) != 0, c_w, 0.0)
            for _ in range(cfg.static_pressure_iterations):
                acc = pair_add(torch.zeros(n, dtype=torch.float32,
                                           device=dev),
                               cw_sp * static_pressure[ib],
                               cw_sp * static_pressure[ia])
                spb = torch.clamp(
                    (acc + pp_w * (weight - MIN_PARTICLE_WEIGHT))
                    / (weight + relax), min=0.0)
                spb = torch.minimum(spb, max_p)
                static_pressure = torch.where(sp_mask, spb, 0.0)

        # ---- pressure (ref SolvePressure, :1147-1175) ----
        ppw = prm.pressure_strength * crit_p
        maxp = MAX_PARTICLE_PRESSURE * crit_p
        accum = torch.minimum(
            lane_v(ppw) * torch.clamp(weight - MIN_PARTICLE_WEIGHT, min=0.0),
            lane_v(maxp))
        accum = torch.where((flags & _NO_PRESSURE) != 0, 0.0, accum)
        accum = accum + torch.where(sp_mask, static_pressure, 0.0)
        fb = (lane_c(vel_per_p) * bc_w * bc_mass
              * (accum[:, None] + lane_c(ppw) * bc_w))[..., None] * bc_n
        fb = torch.where(bc_ok[..., None], fb, 0.0)
        vel = vel - lane_c(inv_mass) * rsum(fb)
        body_dv, body_dw = apply_body_impulse(body_dv, body_dw, fb, bc_ok)
        if use_kernel:
            vel = vel + k3(accum.contiguous(), zcol, pk.PH_PRESSURE)
        else:
            # window form: a-side broadcasts, same-row partners by shifts,
            # row-above partners by one gather
            acc_b_s = _partner_same(accum, ks)
            acc_b_u = accum[pw.cand_up]
            f_s = (lane_c(vel_per_p) * pw.w_same
                   * (accum[:, None] + acc_b_s))[..., None] * pw.n_same
            f_u = (lane_c(vel_per_p) * pw.w_up
                   * (accum[:, None] + acc_b_u))[..., None] * pw.n_up
            vel = vel + _pair_accum(-f_s, -f_u, f_s, f_u, pw.cand_up, n,
                                    plan_up, n_worlds)

        # ---- damping (ref SolveDamping, :1177-1205) ----
        vn = m.dot(body_vel_at() - vel[:, None, :], bc_n)
        damp = torch.maximum(lane_c(lin_d) * bc_w,
                             torch.clamp(-lane_c(quad_d) * vn, max=0.5))
        fb = (damp * bc_mass * vn)[..., None] * bc_n
        approach = bc_ok & (vn < 0)
        fb = torch.where(approach[..., None], fb, 0.0)
        vel = vel + lane_c(inv_mass) * rsum(fb)
        body_dv, body_dw = apply_body_impulse(body_dv, body_dw, -fb,
                                              approach)
        if use_kernel:
            vel = vel + k3(vel[:, 0].contiguous(), vel[:, 1].contiguous(),
                           pk.PH_DAMPING)
        else:
            vb_s = _partner_same(vel, ks)
            vb_u = vel[pw.cand_up]
            vn_s = m.dot(vb_s - vel[:, None, :], pw.n_same)
            vn_u = m.dot(vb_u - vel[:, None, :], pw.n_up)
            damp_s = torch.maximum(lane_c(lin_d) * pw.w_same,
                                   torch.clamp(-lane_c(quad_d) * vn_s,
                                               max=0.5))
            damp_u = torch.maximum(lane_c(lin_d) * pw.w_up,
                                   torch.clamp(-lane_c(quad_d) * vn_u,
                                               max=0.5))
            f_ds = torch.where((pw.v_same & (vn_s < 0))[..., None],
                               (damp_s * vn_s)[..., None] * pw.n_same, 0.0)
            f_du = torch.where((pw.v_up & (vn_u < 0))[..., None],
                               (damp_u * vn_u)[..., None] * pw.n_up, 0.0)
            vel = vel + _pair_accum(f_ds, f_du, -f_ds, -f_du, pw.cand_up, n,
                                    plan_up, n_worlds)

        if cfg.has_static_pressure:
            # ---- extra damping of static-pressure particles (ref :1978;
            # :1207-1217) ----
            ed = bc_ok & sp_mask[:, None]
            vn = m.dot(body_vel_at() - vel[:, None, :], bc_n)
            fb = (0.5 * bc_mass * vn)[..., None] * bc_n
            fb = torch.where((ed & (vn < 0))[..., None], fb, 0.0)
            vel = vel + lane_c(inv_mass) * rsum(fb)
            body_dv, body_dw = apply_body_impulse(body_dv, body_dw, -fb,
                                                  ed & (vn < 0))

        if cfg.has_elastic:
            # ---- elastic triads (ref SolveElastic, :1219-1241); a dead
            # member severs its triad (ref SolveZombie :2873-2906) ----
            ta, tb, tc = tri_a.long(), tri_b.long(), tri_c.long()
            el = (((pt.triad_flags & P_ELASTIC) != 0)
                  & alive[ta] & alive[tb] & alive[tc])
            pa_ = pos[ta] + dt * vel[ta]
            pb_ = pos[tb] + dt * vel[tb]
            pc_ = pos[tc] + dt * vel[tc]
            # a divisor on the device: CUDA divides by a host scalar as a
            # product with its reciprocal, an ulp off the CPU's quotient
            midp = (pa_ + pb_ + pc_) / torch.full((), 3.0, device=dev)
            pa_, pb_, pc_ = pa_ - midp, pb_ - midp, pc_ - midp
            rc = (m.dot(pt.triad_pa, pa_) + m.dot(pt.triad_pb, pb_)
                  + m.dot(pt.triad_pc, pc_))
            rs = (m.cross(pt.triad_pa, pa_) + m.cross(pt.triad_pb, pb_)
                  + m.cross(pt.triad_pc, pc_))
            r = _rot_normalize(torch.stack([rc, rs], dim=-1))
            strength = W.rows(prm.elastic_strength * inv_dt,
                              pt.triad_a.shape[0] // n_worlds
                              ) * pt.triad_strength
            strength = torch.where(el, strength, 0.0)[:, None]
            fa = strength * (m.rot_vec(r, pt.triad_pa) - pa_)
            fbv = strength * (m.rot_vec(r, pt.triad_pb) - pb_)
            fc = strength * (m.rot_vec(r, pt.triad_pc) - pc_)
            for idx, name, f in ((ta, "ta", fa), (tb, "tb", fbv),
                                 (tc, "tc", fc)):
                vel = _segment_add(vel, plans[name], f)

        if cfg.has_spring:
            # ---- springs (ref SolveSpring, :1243-1253) ----
            sa, sb_ = pr_a.long(), pr_b.long()
            spr = (((pt.pair_flags & P_SPRING) != 0)
                   & alive[sa] & alive[sb_])
            dvec = (pos[sb_] + dt * vel[sb_]) - (pos[sa] + dt * vel[sa])
            r1 = _sqrt(m.dot(dvec, dvec))
            fs = (W.rows(prm.spring_strength * inv_dt,
                         pt.pair_a.shape[0] // n_worlds) * pt.pair_strength
                  * _safe_div(pt.pair_distance - r1, r1))[:, None] * dvec
            fs = torch.where(spr[:, None], fs, 0.0)
            vel = _segment_add(vel, plans["sa"], -fs)
            vel = _segment_add(vel, plans["sb"], fs)

        # ---- limit velocity (ref LimitVelocity) ----
        v2 = m.dot(vel, vel)
        vel = torch.where((v2 > lane_v(crit_v2))[:, None],
                          vel * root(_safe_div(lane_v(crit_v2), v2))[:, None],
                          vel)

        if cfg.has_rigid:
            vel, body_dv, body_dw = _rigid_damping(
                group, gflags, alive, flags, pos, vel, g_mass,
                lane_v(inv_mass), lane_v(prm.damping_strength),
                pair_v(prm.damping_strength), body_vel_at(), bc_ok,
                bc_n, bc_w, e_center, e_invm, e_invI, ia, ib, c_ok, c_n, c_w,
                apply_body_impulse, body_dv, body_dw, plan_g, plan_ib)

        if cfg.has_wall:
            # ---- wall particles stay put (ref SolveWall, :1341-1344) ----
            vel = torch.where(wall[:, None], 0.0, vel)

        if cfg.has_rigid:
            # ---- rigid groups move as rigid bodies (ref SolveRigid) ----
            vel = _solve_rigid(group, gflags, alive, pos, vel, g_mass,
                               plan_g)

        # ---- collision anti-tunnelling (ref SolveCollision) ----
        if polygons_only:
            vel = _tunnel_polygons(pos, vel, dt, inv_dt, alive, bs_valid,
                                   s_origin, s_rot, s_verts, s_normals,
                                   s_count, cull, W)
        else:
            vel = _tunnel_analytic(pos, vel, dt, inv_dt, alive, bs_valid,
                                   s_origin, s_rot, sh.type[bs_idx],
                                   s_verts, s_normals, s_count, s_radius,
                                   cfg.geom_types, W)

        # ---- barrier segments block crossing (ref SolveBarrier) ----
        if cfg.has_barrier and bar_lanes.numel():
            vel = _solve_barrier(pr_a[bar_lanes], pr_b[bar_lanes],
                                 pt.pair_flags[bar_lanes], group, alive,
                                 lane_v(prm.radius), pos, vel, dt,
                                 same_world if batched else None)

        if cfg.has_colormix:
            # ---- colour mixing (ref SolveColorMixing :2243; :1359-1365) -
            mix = ((c_flags & P_COLOR_MIXING) != 0) & c_ok
            dcol = pair_c(0.5 * prm.color_mixing_strength) * (
                col[ib] - col[ia])
            dcol = torch.where(mix[:, None], dcol, 0.0)
            col = pair_add(col, dcol, -dcol)

        # ---- lifetimes (ref SolveLifetimes :1516) ----
        expiring = expiration > 0.0
        new_exp = torch.where(expiring, expiration - dt, expiration)
        new_alive = alive & ~(expiring & (new_exp <= 0.0))

        # ---- integrate (ref :1554-1561) ----
        pos = pos + torch.where(alive[:, None], dt * vel, 0.0)

        cur_pos, cur_vel, cur_force = pos, vel, force
        cur_exp, cur_sp = new_exp, static_pressure
        cur_flags, cur_group, cur_alive = flags, group, new_alive
        if cfg.has_solid:
            cur_depth = depth
        if cfg.has_colormix:
            cur_color = col
        skey_prev = skey
        bc_cnt = bc_ok.sum(dim=1).to(torch.int32)
        if c_over is not None:
            iter_over = torch.maximum(iter_over, c_over)

    # ---- un-sort once: the mutated fields back to original lanes
    # (:1407-1439) ----
    fcols = [cur_pos, cur_vel, cur_exp[:, None]]
    if cfg.has_static_pressure:
        fcols.append(cur_sp[:, None])
    if cfg.has_colormix:
        fcols.append(cur_color.reshape(n, -1))
    if cfg.has_solid:
        fcols.append(cur_depth[:, None])
    fback = _scatter_rows(torch.cat(fcols, dim=1), s2o)
    iback = _scatter_rows(torch.stack([cur_alive.to(torch.int32), bc_cnt],
                                      dim=1), s2o)
    alive_o = iback[:, 0] > 0
    extra = {}
    c = 5
    if cfg.has_static_pressure:
        extra["static_pressure"] = fback[:, c].contiguous()
        c += 1
    if cfg.has_colormix:
        nc = pt.color.shape[1]
        extra["color"] = fback[:, c:c + nc].contiguous()
        c += nc
    if cfg.has_solid:
        extra["depth"] = fback[:, c].contiguous()
        extra["group_flags"] = gflags
    # stuck detection (ref DetectStuckParticle :1520-1541)
    stuck_now = alive_o & (iback[:, 1] >= 2)
    out = dataclasses.replace(
        pt, pos=fback[:, 0:2].contiguous(), vel=fback[:, 2:4].contiguous(),
        expiration=fback[:, 4].contiguous(), alive=alive_o,
        force=torch.zeros_like(pt.force),
        consecutive_contact_steps=torch.where(
            stuck_now, pt.consecutive_contact_steps + 1, 0).to(torch.int32),
        **extra)
    return out, body_dv, body_dw, shape_overflow + iter_over


def _rigid_damping(group, gflags, alive, flags, pos, vel, mass, inv_mass,
                   damping, damping_pairs, body_v, bc_ok, bc_n, bc_w,
                   e_center, e_invm, e_invI, ia, ib, c_ok, c_n, c_w,
                   apply_body_impulse, body_dv, body_dw, plan_g, plan_ib):
    """Rigid-group damping (ref SolveRigidDamping :1916-1977;
    box2d_tpu/particles.py:1261-1339): the impulses of (a) rigid-group
    against body contacts and (b) contacts across groups where either side
    is rigid, summed per group Jacobi-style and applied once to the members
    as a rigid-motion velocity. The group statistics have names of their
    own: the body rows (e_*) and the impulse sum keep theirs. A group's
    sum is taken per particle first (its own lanes by _tree_sum, its
    partners' through plan_ib), then per group through plan_g (the
    SegmentPlan of the particles' groups); lanes of a side that is not
    rigid add zeros, where the reference sends them to the last group.
    mass is the particle mass at each group, inv_mass and damping at each
    particle and damping_pairs at each lane of the flat pair view (each
    0-d in one world). Returns (vel, body_dv, body_dw)."""
    (in_rigid, ngrp, g_center, g_linvel, g_omega, g_invm,
     g_invI) = _rigid_group_stats(group, gflags, alive, pos, vel, mass,
                                  plan_g)
    gp = group.clamp(min=0).long()
    n = pos.shape[0]
    dev = pos.device
    glin_d = torch.zeros((ngrp, 2), dtype=torch.float32, device=dev)
    gw_d = torch.zeros(ngrp, dtype=torch.float32, device=dev)

    def rows(x):
        """Per particle: the sum of its own lanes of the flat pair view."""
        return _tree_sum(x.reshape((n, -1) + tuple(x.shape[1:])))

    def partners(x):
        """Per particle: the sum of the flat lanes it is the partner of."""
        return _segment_add(x.new_zeros((n,) + tuple(x.shape[1:])), plan_ib,
                            x)

    # (a) rigid group <-> rigid body contacts
    rel_g = pos[:, None, :] - g_center[gp][:, None, :]
    pgv = g_linvel[gp][:, None, :] + m.cross_sv(g_omega[gp][:, None], rel_g)
    vn = m.dot(body_v - pgv, bc_n)
    act = in_rigid[:, None] & bc_ok & (vn < 0)
    td_a = m.cross(rel_g, bc_n)
    td_b = m.cross(pos[:, None, :] - e_center, bc_n)
    ksum = (g_invm[gp][:, None] + g_invI[gp][:, None] * td_a * td_a
            + e_invm + e_invI * td_b * td_b)
    f = _lanes(damping, 2) * torch.clamp(bc_w, max=1.0) * _safe_div(vn,
                                                                     ksum)
    f = torch.where(act & (ksum > 0), f, 0.0)
    glin_d = _segment_add(glin_d, plan_g, _tree_sum(
        (f * g_invm[gp][:, None])[..., None] * bc_n))
    gw_d = _segment_add(gw_d, plan_g,
                        _tree_sum(f * td_a * g_invI[gp][:, None]))
    body_dv, body_dw = apply_body_impulse(body_dv, body_dw,
                                          -f[..., None] * bc_n, act)

    # (b) particle contacts across groups where either side is rigid
    ga = group[ia]
    gb = group[ib]
    ga_g = ga.clamp(min=0).long()
    gb_g = gb.clamp(min=0).long()
    a_r = in_rigid[ia]
    b_r = in_rigid[ib]
    pmid = 0.5 * (pos[ia] + pos[ib])
    pw_inv = torch.where((flags & P_WALL) != 0, 0.0, inv_mass)

    def side(gsel, rsel, pidx):
        relm = pmid - g_center[gsel]
        vl = torch.where(rsel[:, None],
                         g_linvel[gsel] + m.cross_sv(g_omega[gsel], relm),
                         vel[pidx])
        inv_m_s = torch.where(rsel, g_invm[gsel], pw_inv[pidx])
        inv_i_s = torch.where(rsel, g_invI[gsel], 0.0)
        td = torch.where(rsel, m.cross(relm, c_n), 0.0)
        return vl, inv_m_s, inv_i_s, td

    va_l, ima, iia, tda = side(ga_g, a_r, ia)
    vb_l, imb, iib, tdb = side(gb_g, b_r, ib)
    vn_p = m.dot(vb_l - va_l, c_n)
    actp = c_ok & (ga != gb) & (a_r | b_r) & (vn_p < 0)
    ksum_p = ima + iia * tda * tda + imb + iib * tdb * tdb
    fp = damping_pairs * c_w * _safe_div(vn_p, ksum_p)
    fp = torch.where(actp & (ksum_p > 0), fp, 0.0)
    # side A gets +fp, side B gets -fp (ref ApplyDamping)
    glin_d = _segment_add(glin_d, plan_g, rows(
        torch.where(a_r, fp * ima, 0.0)[:, None] * c_n))
    gw_d = _segment_add(gw_d, plan_g,
                        rows(torch.where(a_r, fp * tda * iia, 0.0)))
    vel = vel + rows(torch.where(~a_r, fp * ima, 0.0)[:, None] * c_n)
    glin_d = _segment_add(glin_d, plan_g, partners(
        torch.where(b_r, -fp * imb, 0.0)[:, None] * c_n))
    gw_d = _segment_add(gw_d, plan_g,
                        partners(torch.where(b_r, -fp * tdb * iib, 0.0)))
    vel = _segment_add(vel, plan_ib,
                       torch.where(~b_r, -fp * imb, 0.0)[:, None] * c_n)

    # the accumulated rigid-motion deltas, applied to the members
    vel = vel + torch.where(
        in_rigid[:, None],
        glin_d[gp] + m.cross_sv(gw_d[gp], pos - g_center[gp]), 0.0)
    return vel, body_dv, body_dw
