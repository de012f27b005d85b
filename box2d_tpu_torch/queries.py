"""Scene queries: ray casts, overlaps, shape casts, explosions, the mover.

Torch port of box2d_tpu/queries.py (ref: api/World.cs:339-772 and the
per-geometry casts of include/Collision.cs). Each JAX function is one
query vmapped over the shapes; here the local casts take a lane axis
first, and a world query is one pass over (query, shape) lanes. The ray
casts and `overlap_point` also take a leading axis of queries, the
port's form of a `jax.vmap` over rays: 1,024 lidar rays are one pass.

A world query computes only the lanes whose shape can count (enabled, on
an enabled body, passing the query filter, and not a sensor where the
JAX function drops sensors), and each family of geometry (circle,
segment, sharp polygon, rounded shape) on its own shapes; that takes one
device read of the shape columns per query. Every lane's arithmetic is
independent of the others, so each kept lane computes what the JAX
function computes there, and the dropped lanes are the ones its mask
throws away. GJK and the shape cast are the lane-batched
`distance.shape_distance` and `shape_cast_pair`, with their masked loops.

Ties follow the JAX package: `argmin` and `argsort(stable=True)` take the
first of equal values, and `collide_mover` keeps `lax.top_k`'s order
(ascending index among equal scores) through `broadphase._top_k`.
`stats` (world.StepStats), where given, counts the device reads and the
loop rounds of a query.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import geometry as g
from . import math2d as m
from .broadphase import _top_k, compute_shape_aabbs
from .constants import FLT_EPSILON, MAX_POLYGON_VERTICES
from .distance import _sel, shape_cast_pair, shape_distance
from .state import DYNAMIC, WorldState

# (query, shape) lanes of one pass; larger batches of queries go in turns
LANE_BUDGET = 1 << 21
INF = math.inf


class RayResult(NamedTuple):
    hit: torch.Tensor
    shape: torch.Tensor     # i32 shape id (-1 when no hit)
    point: torch.Tensor     # (2,) world
    normal: torch.Tensor    # (2,) world
    fraction: torch.Tensor


class RayHits(NamedTuple):
    """Fixed-capacity all-hits ray cast result, sorted by fraction."""

    count: torch.Tensor     # i32 number of valid rows (<= capacity)
    shape: torch.Tensor     # (K,) i32 shape ids, fraction-ascending
    point: torch.Tensor     # (K, 2) world hit points
    normal: torch.Tensor    # (K, 2) world normals
    fraction: torch.Tensor  # (K,)


def _inf_like(x):
    return torch.full_like(x, INF)


# ---------------------------------------------------------------------------
# local-space ray casts, one lane per (ray, shape)
# ---------------------------------------------------------------------------

def _ray_circle(p1, d, max_frac, center, radius):
    """ref: include/Collision.cs:93-130 Circle.RayCast."""
    s = p1 - center
    rr = radius * radius
    u, length = m.get_length_and_normalize(d)
    t = -m.dot(s, u)
    c = m.mul_add(s, t, u)
    cc = m.dot(c, c)
    h = torch.sqrt(torch.clamp(rr - cc, min=0.0))
    fraction = t - h
    inside = m.dot(s, s) < rr
    valid = ((length > 0) & (cc <= rr) & (fraction >= 0)
             & (max_frac * length >= fraction))
    hit_point = m.mul_add(s, fraction, u) + center
    normal = m.normalize(hit_point - center)
    frac = torch.where(valid, fraction / torch.where(length > 0, length, 1.0),
                       torch.where(inside, 0.0, _inf_like(fraction)))
    point = _sel(valid, m.mul_add(center, radius, normal), p1)
    return (valid | inside, frac, point,
            _sel(valid, normal, torch.zeros_like(normal)))


def _ray_segment(p1, d, max_frac, v1, v2, one_sided):
    """ref: include/Collision.cs:656-686 Segment.RayCast."""
    e = v2 - v1
    e_unit, length = m.get_length_and_normalize(e)
    normal = m.right_perp(e_unit)
    numerator = m.dot(normal, v1 - p1)
    denominator = m.dot(normal, d)
    t = numerator / torch.where(denominator != 0.0, denominator, 1.0)
    p = m.mul_add(p1, t, d)
    s = m.dot(p - v1, e_unit)
    side_ok = ~one_sided | (m.cross(p1 - v1, e) >= 0.0)
    hit = (side_ok & (length > 0) & (denominator != 0.0) & (t >= 0)
           & (t <= max_frac) & (s >= 0) & (s <= length))
    out_normal = _sel(numerator > 0.0, -normal, normal)
    return hit, torch.where(hit, t, _inf_like(t)), p, out_normal


def _ray_polygon_sharp(p1, d, max_frac, verts, normals, count):
    """Slab clipping for radius-0 polygons (ref: Collision.cs:497-545)."""
    V = verts.shape[1]
    base = verts[:, 0]
    p = p1 - base
    lane_ok = (torch.arange(V, device=verts.device)[None, :]
               < count[:, None])
    rel = (verts - base[:, None]) - p[:, None]
    num = normals[..., 0] * rel[..., 0] + normals[..., 1] * rel[..., 1]
    den = normals[..., 0] * d[:, None, 0] + normals[..., 1] * d[:, None, 1]
    # entering faces raise `lower`; exiting faces cap `upper`
    tf = num / torch.where(den != 0.0, den, 1.0)
    lower_cand = torch.where(lane_ok & (den < 0.0), tf, -INF)
    upper_cand = torch.where(lane_ok & (den > 0.0), tf, INF)
    # parallel & outside any face => miss
    par_miss = (lane_ok & (den == 0.0) & (num < 0.0)).any(dim=1)
    mx, first = lower_cand.max(dim=1)      # the first of equal maxima
    lower = torch.clamp(mx, min=0.0)
    upper = torch.minimum(upper_cand.min(dim=1).values,
                          torch.as_tensor(max_frac, dtype=mx.dtype,
                                          device=mx.device))
    entered = mx > 0.0
    ok = ~par_miss & (lower <= upper)
    inside = ok & ~entered
    hit = ok & entered & (mx <= max_frac)
    frac = torch.where(hit, lower,
                       torch.where(inside, 0.0, _inf_like(lower)))
    point = _sel(hit, m.mul_add(p1, lower, d), p1)
    best_n = torch.gather(normals, 1, first[:, None, None].expand(-1, 1, 2))
    best_n = best_n[:, 0]
    return (hit | inside, frac, point,
            _sel(hit, best_n, torch.zeros_like(best_n)))


def _ray_capsule(p1, d, max_frac, v1, v2, radius):
    """Analytic capsule ray cast (ref: include/Collision.cs:230-290
    Capsule.RayCast): slab vs the infinite rounded band, endpoint circles."""
    a, cap_len = m.get_length_and_normalize(v2 - v1)
    q = p1 - v1
    qa = m.dot(q, a)
    qp = m.mul_add(q, -qa, a)
    inside_band = m.dot(qp, qp) < radius * radius

    # endpoint circle casts
    hit1, f1, pt1, n1 = _ray_circle(p1, d, max_frac, v1, radius)
    hit2, f2, pt2, n2 = _ray_circle(p1, d, max_frac, v2, radius)
    circle_best = f1 <= f2
    hit_c = torch.where(circle_best, hit1, hit2)
    f_c = torch.where(circle_best, f1, f2)
    pt_c = _sel(circle_best, pt1, pt2)
    n_c = _sel(circle_best, n1, n2)

    # side wall intersection
    n = m.right_perp(a)
    u, ray_len = m.get_length_and_normalize(d)
    den = -a[:, 0] * u[:, 1] + u[:, 0] * a[:, 1]
    safe_den = torch.where(torch.abs(den) > FLT_EPSILON, den, 1.0)
    b1 = m.mul_sub(q, radius, n)
    b2 = m.mul_add(q, radius, n)
    inv_den = 1.0 / safe_den
    s21 = (a[:, 0] * b1[:, 1] - b1[:, 0] * a[:, 1]) * inv_den
    s22 = (a[:, 0] * b2[:, 1] - b2[:, 0] * a[:, 1]) * inv_den
    first_is_1 = s21 < s22
    s2 = torch.where(first_is_1, s21, s22)
    bsel = _sel(first_is_1, b1, b2)
    n_side = _sel(first_is_1, n, -n)
    s1 = (-bsel[:, 0] * u[:, 1] + u[:, 0] * bsel[:, 1]) * inv_den
    side_valid = ((torch.abs(den) > FLT_EPSILON) & (s2 >= 0)
                  & (s2 <= max_frac * ray_len) & (s1 >= 0)
                  & (s1 <= cap_len) & (cap_len > 0) & ~inside_band)
    f_side = s2 / torch.where(ray_len > 0, ray_len, 1.0)
    pt_side = (m.lerp(v1, v2, s1 / torch.where(cap_len > 0, cap_len, 1.0))
               + radius[:, None] * n_side)

    # endpoints are fallbacks when the side param is out of range
    hit = side_valid | (hit_c & ~inside_band)
    frac = torch.where(side_valid, f_side, f_c)
    pt = _sel(side_valid, pt_side, pt_c)
    nrm = _sel(side_valid, n_side, n_c)
    # starting inside: report hit at origin, fraction 0
    hit = hit | inside_band
    frac = torch.where(inside_band, 0.0,
                       torch.where(hit, frac, _inf_like(frac)))
    return hit, frac, pt, nrm


def ray_shape_analytic(p1, d, max_frac, stype, verts, normals, count, radius,
                       types_present: frozenset | None = None):
    """Closed-form-only dispatch (no GJK), per lane: rounded polygons are
    treated as their sharp core (box2d_tpu/queries.py:165). Used by the
    particle anti-tunnel pass and `World.shape_ray_cast`. types_present:
    the geometry types that can occur; absent families are not
    computed."""
    tp = types_present
    has = lambda *ts: tp is None or any(t in tp for t in ts)  # noqa: E731
    n = p1.shape[0]
    miss = (torch.zeros(n, dtype=torch.bool, device=p1.device),
            torch.full((n,), INF, device=p1.device), p1, torch.zeros_like(p1))
    hit_c, f_c, pt_c, n_c = (
        _ray_circle(p1, d, max_frac, verts[:, 0], radius)
        if has(g.CIRCLE) else miss)
    hit_k, f_k, pt_k, n_k = (
        _ray_capsule(p1, d, max_frac, verts[:, 0], verts[:, 1], radius)
        if has(g.CAPSULE) else miss)
    hit_s, f_s, pt_s, n_s = (
        _ray_segment(p1, d, max_frac, verts[:, 0], verts[:, 1],
                     stype == g.CHAIN_SEGMENT)
        if has(g.SEGMENT, g.CHAIN_SEGMENT, g.CAPSULE) else miss)
    hit_p, f_p, pt_p, n_p = (
        _ray_polygon_sharp(p1, d, max_frac, verts, normals, count)
        if has(g.POLYGON) else miss)
    is_circle = stype == g.CIRCLE
    is_cap = (stype == g.CAPSULE) & (radius > 0.0)
    is_seg = ((stype == g.SEGMENT) | (stype == g.CHAIN_SEGMENT)
              | ((stype == g.CAPSULE) & (radius == 0.0)))

    def pick(c, k, s, p):
        if c.dim() == 1:
            return torch.where(is_circle, c, torch.where(
                is_cap, k, torch.where(is_seg, s, p)))
        return _sel(is_circle, c, _sel(is_cap, k, _sel(is_seg, s, p)))

    return (pick(hit_c, hit_k, hit_s, hit_p), pick(f_c, f_k, f_s, f_p),
            pick(pt_c, pt_k, pt_s, pt_p), pick(n_c, n_k, n_s, n_p))


def _ray_rounded(p1, d, max_frac, verts, count, radius, stats=None):
    """Rounded shapes via the conservative-advancement cast of the ray
    point (ref: Collision.cs:546-558, Capsule/Polygon with radius)."""
    n, V = verts.shape[:2]
    dev = p1.device
    zero2 = torch.zeros(n, 2, device=dev)
    ident = m.rot_identity((n,), device=dev)
    out = shape_cast_pair(
        verts, count, radius, p1[:, None, :].expand(n, V, 2).contiguous(),
        torch.ones(n, dtype=torch.int32, device=dev),
        torch.zeros(n, device=dev), zero2, ident, zero2, ident, d, max_frac,
        stats=stats)
    return (out.hit, torch.where(out.hit, out.fraction,
                                 _inf_like(out.fraction)),
            out.point, -out.normal)


# the geometry families of _ray_shape_local (box2d_tpu/queries.py:215)
_CIRCLE, _SEGMENT, _SHARP, _ROUNDED = range(4)


def _ray_family(stype, radius):
    """The family _ray_shape_local picks for each shape (numpy)."""
    fam = np.full(stype.shape, _ROUNDED)
    fam[(stype == g.POLYGON) & (radius == 0.0)] = _SHARP
    fam[(stype == g.SEGMENT) | (stype == g.CHAIN_SEGMENT)
        | ((stype == g.CAPSULE) & (radius == 0.0))] = _SEGMENT
    fam[stype == g.CIRCLE] = _CIRCLE
    return fam


def _ray_shape_local(family: int, p1, d, max_frac, stype, verts, normals,
                     count, radius, stats=None):
    """The local ray cast of one family of shapes, per lane."""
    if family == _CIRCLE:
        return _ray_circle(p1, d, max_frac, verts[:, 0], radius)
    if family == _SEGMENT:
        return _ray_segment(p1, d, max_frac, verts[:, 0], verts[:, 1],
                            stype == g.CHAIN_SEGMENT)
    if family == _SHARP:
        return _ray_polygon_sharp(p1, d, max_frac, verts, normals, count)
    return _ray_rounded(p1, d, max_frac, verts, count, radius, stats)


# ---------------------------------------------------------------------------
# world queries
# ---------------------------------------------------------------------------

def _query_filter_mask(state: WorldState, category_bits, mask_bits):
    sh = state.shapes
    cat = int(category_bits) & 0xFFFFFFFF
    msk = int(mask_bits) & 0xFFFFFFFF
    return (((sh.filter_category.to(torch.int64) & msk) != 0)
            & ((sh.filter_mask.to(torch.int64) & cat) != 0))


def _live(state: WorldState):
    """Enabled shapes on enabled bodies."""
    sh = state.shapes
    return sh.enabled & state.bodies.enabled[sh.body.long()]


def _fetch(stats, *tensors):
    """Tensors to numpy in one device read, counted in stats.syncs."""
    if stats is not None:
        stats.syncs += 1
    return [x.cpu().numpy() for x in tensors]


def _lanes(mask, stats):
    """Shape ids (a device tensor and its numpy twin) where mask holds."""
    (host,) = _fetch(stats, mask)
    ids = np.nonzero(host)[0]
    return torch.as_tensor(ids, device=mask.device), ids


def _shape_pose(state: WorldState):
    sh = state.shapes
    b = state.bodies
    body = sh.body.long()
    return b.origin[body], b.rot[body]


def _as_queries(x, width: int, dev):
    """(Q, width) float32 queries and whether one unbatched query came."""
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return x.reshape(-1, width), x.dim() == 1


def _per_chunk(n_queries: int, n_shapes: int):
    """Query ranges so that a pass holds at most LANE_BUDGET lanes."""
    step = max(1, LANE_BUDGET // max(n_shapes, 1))
    return [(r0, min(r0 + step, n_queries))
            for r0 in range(0, n_queries, step)]


def _cast_rays(state: WorldState, origin, translation, category_bits,
               mask_bits, stats):
    """Every ray against every shape: (valid, fraction, local point, local
    normal), each (R, S[, 2]), fraction inf where not valid; then each
    shape's body origin and rotation, (S, 2)."""
    sh = state.shapes
    dev = origin.device
    R = origin.shape[0]
    S = sh.type.shape[0]
    p, q = _shape_pose(state)
    cand = (_live(state) & ~sh.is_sensor
            & _query_filter_mask(state, category_bits, mask_bits))
    host_cand, stype, radius = _fetch(stats, cand, sh.type, sh.radius)
    fam = _ray_family(stype, radius)
    hit = torch.zeros(R, S, dtype=torch.bool, device=dev)
    frac = torch.full((R, S), INF, device=dev)
    pt = torch.zeros(R, S, 2, device=dev)
    nrm = torch.zeros(R, S, 2, device=dev)
    for family in (_CIRCLE, _SEGMENT, _SHARP, _ROUNDED):
        ids = np.nonzero(host_cand & (fam == family))[0]
        if ids.size == 0:
            continue
        k = ids.size
        idx = torch.as_tensor(ids, device=dev)
        ps, qs = p[idx], q[idx]
        cols = (sh.type[idx], sh.verts[idx], sh.normals[idx], sh.count[idx],
                sh.radius[idx])
        for r0, r1 in _per_chunk(R, k):
            r = r1 - r0
            lo = m.inv_rot_vec(qs[None], origin[r0:r1, None] - ps[None])
            ld = m.inv_rot_vec(qs[None], translation[r0:r1, None])
            rep = [c.expand((r,) + tuple(c.shape)).reshape(
                (r * k,) + tuple(c.shape[1:])) for c in cols]
            h, f, lp, ln = _ray_shape_local(
                family, lo.reshape(-1, 2), ld.reshape(-1, 2), 1.0, *rep,
                stats=stats)
            hit[r0:r1, idx] = h.reshape(r, k)
            frac[r0:r1, idx] = f.reshape(r, k)
            pt[r0:r1, idx] = lp.reshape(r, k, 2)
            nrm[r0:r1, idx] = ln.reshape(r, k, 2)
    valid = hit & cand[None, :]
    return valid, torch.where(valid, frac, INF), pt, nrm, p, q


def cast_ray_closest(state: WorldState, origin, translation,
                     category_bits=0x1, mask_bits=0xFFFFFFFF,
                     stats=None) -> RayResult:
    """Closest-hit ray cast against all shapes (ref: api/World.cs:466-503
    CastRayClosest). origin and translation are (2,) for one ray or
    (R, 2) for R rays; the result has the same leading axis."""
    dev = state.bodies.center.device
    o, one = _as_queries(origin, 2, dev)
    tr, _ = _as_queries(translation, 2, dev)
    valid, frac, pt, nrm, p, q = _cast_rays(state, o, tr, category_bits,
                                            mask_bits, stats)
    rays = torch.arange(o.shape[0], device=dev)
    best = torch.argmin(frac, dim=1)
    fbest = frac[rays, best]
    found = torch.isfinite(fbest)
    w_pt = m.transform_point(p[best], q[best], pt[rays, best])
    w_n = m.rot_vec(q[best], nrm[rays, best])
    out = RayResult(
        hit=found,
        shape=torch.where(found, best, -1).to(torch.int32),
        point=_sel(found, w_pt, o),
        normal=_sel(found, w_n, torch.zeros_like(w_n)),
        fraction=torch.where(found, fbest, 1.0))
    return RayResult(*(x[0] for x in out)) if one else out


def cast_ray_all(state: WorldState, origin, translation, max_hits: int = 16,
                 category_bits=0x1, mask_bits=0xFFFFFFFF,
                 stats=None) -> RayHits:
    """All-hits ray cast, fraction-sorted (ref: api/World.cs:442-465);
    one ray or a leading axis of rays, as cast_ray_closest."""
    dev = state.bodies.center.device
    o, one = _as_queries(origin, 2, dev)
    tr, _ = _as_queries(translation, 2, dev)
    valid, frac, pt, nrm, p, q = _cast_rays(state, o, tr, category_bits,
                                            mask_bits, stats)
    order = torch.argsort(frac, dim=1, stable=True)[:, :max_hits]
    ofrac = torch.gather(frac, 1, order)
    found = torch.isfinite(ofrac)
    opt = torch.gather(pt, 1, order[..., None].expand(-1, -1, 2))
    onrm = torch.gather(nrm, 1, order[..., None].expand(-1, -1, 2))
    w_pt = m.transform_point(p[order], q[order], opt)
    w_n = m.rot_vec(q[order], onrm)
    out = RayHits(
        count=torch.clamp(valid.sum(dim=1), 0, max_hits).to(torch.int32),
        shape=torch.where(found, order, -1).to(torch.int32),
        point=torch.where(found[..., None], w_pt, 0.0),
        normal=torch.where(found[..., None], w_n, 0.0),
        fraction=torch.where(found, ofrac, 1.0))
    return RayHits(*(x[0] for x in out)) if one else out


def _point_distance(state: WorldState, idx, points, radius_b: float,
                    stats):
    """GJK distance (use_radii) of each point, a proxy of one vertex and
    radius radius_b, to each shape of idx: (Q, k) DistanceOutput fields
    flattened query-major."""
    sh = state.shapes
    p, q = _shape_pose(state)
    Q, k = points.shape[0], idx.shape[0]
    dev = points.device
    V = sh.verts.shape[1]
    n = Q * k
    rep = lambda x: x[idx].expand((Q, k) + tuple(x.shape[1:])).reshape(  # noqa
        (n,) + tuple(x.shape[1:]))
    pt = points[:, None, None, :].expand(Q, k, V, 2).reshape(n, V, 2)
    return shape_distance(
        rep(sh.verts), rep(sh.count), rep(sh.radius), pt,
        torch.ones(n, dtype=torch.int32, device=dev),
        torch.full((n,), radius_b, device=dev), rep(p), rep(q),
        torch.zeros(n, 2, device=dev), m.rot_identity((n,), device=dev),
        use_radii=True, stats=stats)


def overlap_point(state: WorldState, point, category_bits=0x1,
                  mask_bits=0xFFFFFFFF, stats=None) -> torch.Tensor:
    """Mask (S,) of shapes containing a world point, or (Q, S) for (Q, 2)
    points (box2d_tpu/queries.py:325): inside iff the distance to the
    shape's core is <= its radius."""
    sh = state.shapes
    dev = state.bodies.center.device
    pts, one = _as_queries(point, 2, dev)
    cand = _live(state) & _query_filter_mask(state, category_bits,
                                             mask_bits)
    idx, ids = _lanes(cand, stats)
    out = torch.zeros(pts.shape[0], sh.type.shape[0], dtype=torch.bool,
                      device=dev)
    if ids.size:
        for r0, r1 in _per_chunk(pts.shape[0], ids.size):
            d = _point_distance(state, idx, pts[r0:r1], 0.0, stats)
            out[r0:r1, idx] = (d.distance <= 0.0).reshape(r1 - r0, -1)
    return out[0] if one else out


def overlap_aabb(state: WorldState, aabb, category_bits=0x1,
                 mask_bits=0xFFFFFFFF) -> torch.Tensor:
    """Boolean mask of shapes whose AABB overlaps (ref: api/World.cs:
    339-358)."""
    boxes = compute_shape_aabbs(state)
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=boxes.device)
    return (m.aabb_overlaps(boxes, aabb[None, :]) & _live(state)
            & _query_filter_mask(state, category_bits, mask_bits))


def _proxy_lanes(verts, count, radius, position, rotation, n, dev):
    """One query proxy broadcast to n lanes."""
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    return (verts[None].expand((n,) + tuple(verts.shape)),
            torch.full((n,), int(count), dtype=torch.int32, device=dev),
            torch.full((n,), float(radius), device=dev),
            torch.as_tensor(position, dtype=torch.float32,
                            device=dev).expand(n, 2),
            torch.as_tensor(rotation, dtype=torch.float32,
                            device=dev).expand(n, 2))


def overlap_shape(state: WorldState, verts, count, radius, position,
                  rotation, category_bits=0x1, mask_bits=0xFFFFFFFF,
                  stats=None) -> torch.Tensor:
    """Mask of shapes overlapping a query proxy (ref: api/World.cs
    OverlapShape -> GJK distance < ~0)."""
    sh = state.shapes
    dev = state.bodies.center.device
    cand = _live(state) & _query_filter_mask(state, category_bits,
                                             mask_bits)
    idx, ids = _lanes(cand, stats)
    out = torch.zeros(sh.type.shape[0], dtype=torch.bool, device=dev)
    if ids.size:
        p, q = _shape_pose(state)
        vb, cb, rb, pb, qb = _proxy_lanes(verts, count, radius, position,
                                          rotation, ids.size, dev)
        d = shape_distance(sh.verts[idx], sh.count[idx], sh.radius[idx],
                           vb, cb, rb, p[idx], q[idx], pb, qb,
                           use_radii=True, stats=stats)
        out[idx] = d.distance < 10.0 * FLT_EPSILON
    return out


def cast_shape_closest(state: WorldState, verts, count, radius, position,
                       rotation, translation, category_bits=0x1,
                       mask_bits=0xFFFFFFFF, stats=None) -> RayResult:
    """Closest-hit shape cast (ref: api/World.cs:504-565 CastShape). Shape
    0 is always cast: without a hit the JAX function returns its cast's
    point and normal."""
    sh = state.shapes
    dev = state.bodies.center.device
    S = sh.type.shape[0]
    cand = (_live(state) & ~sh.is_sensor
            & _query_filter_mask(state, category_bits, mask_bits))
    lane0 = torch.arange(S, device=dev) == 0
    idx, ids = _lanes(cand | lane0, stats)
    p, q = _shape_pose(state)
    vb, cb, rb, pb, qb = _proxy_lanes(verts, count, radius, position,
                                      rotation, ids.size, dev)
    tr = torch.as_tensor(translation, dtype=torch.float32,
                         device=dev).expand(ids.size, 2)
    outs = shape_cast_pair(sh.verts[idx], sh.count[idx], sh.radius[idx],
                           vb, cb, rb, p[idx], q[idx], pb, qb, tr, 1.0,
                           stats=stats)
    frac = torch.full((S,), INF, device=dev)
    frac[idx] = torch.where(outs.hit & cand[idx], outs.fraction, INF)
    point = torch.zeros(S, 2, device=dev)
    normal = torch.zeros(S, 2, device=dev)
    point[idx] = outs.point
    normal[idx] = outs.normal
    best = torch.argmin(frac)
    found = torch.isfinite(frac[best])
    return RayResult(
        hit=found, shape=torch.where(found, best, -1).to(torch.int32),
        point=point[best], normal=normal[best],
        fraction=torch.where(found, frac[best], 1.0))


def explode(state: WorldState, position, radius, impulse_per_length,
            falloff=0.0, mask_bits=0xFFFFFFFF, stats=None) -> WorldState:
    """Apply an explosion impulse to dynamic bodies (ref: api/World.cs:
    709-772 Explode/ExplosionCallback). Returns a new state; the given one
    is not changed."""
    sh = state.shapes
    b = state.bodies
    dev = b.center.device
    body_all = sh.body.long()
    cand = (_live(state) & ~sh.is_sensor & (b.type[body_all] == DYNAMIC)
            & ((sh.filter_category.to(torch.int64)
                & (int(mask_bits) & 0xFFFFFFFF)) != 0))
    idx, ids = _lanes(cand, stats)
    if ids.size == 0:
        return state
    position = torch.as_tensor(position, dtype=torch.float32, device=dev)
    out = _point_distance(state, idx, position[None], 1.0, stats)
    p, q = _shape_pose(state)
    p, q = p[idx], q[idx]
    eligible = out.distance <= radius + falloff
    centroid_w = m.transform_point(p, q, sh.centroid[idx])
    closest = _sel(out.distance == 0.0, centroid_w, out.point_a)
    direction = closest - position[None, :]
    dlen2 = m.dot(direction, direction)
    direction = _sel(dlen2 > 100.0 * FLT_EPSILON * FLT_EPSILON,
                     m.normalize(direction),
                     torch.tensor([1.0, 0.0], device=dev).expand_as(
                         direction))

    # projected perimeter onto the line perpendicular to the blast
    local_line = m.inv_rot_vec(q, m.left_perp(direction))
    verts = sh.verts[idx]
    proj = (verts[..., 0] * local_line[:, None, 0]
            + verts[..., 1] * local_line[:, None, 1])
    lane_ok = (torch.arange(verts.shape[1], device=dev)[None, :]
               < sh.count[idx][:, None])
    pmax = torch.where(lane_ok, proj, -INF).max(dim=1).values
    pmin = torch.where(lane_ok, proj, INF).min(dim=1).values
    perimeter = pmax - pmin + 2.0 * sh.radius[idx]

    d = out.distance
    if falloff > 0:
        scale = torch.where(d > radius, torch.clamp(
            (radius + falloff - d) / falloff, 0.0, 1.0), 1.0)
    else:
        scale = torch.ones_like(d)
    magnitude = impulse_per_length * perimeter * scale
    impulse = torch.where(eligible[:, None], magnitude[:, None] * direction,
                          0.0)

    # per-body velocity changes (impulse at the closest point)
    body = body_all[idx]
    dv = impulse * b.inv_mass[body][:, None]
    lever = closest - b.center[body]
    dw = b.inv_inertia[body] * m.cross(lever, impulse)
    return dataclasses.replace(state, bodies=dataclasses.replace(
        b, v=b.v.index_add(0, body, dv), w=b.w.index_add(0, body, dw)))


# ---------------------------------------------------------------------------
# character mover (ref: src/Mover.cs:11-47)
# ---------------------------------------------------------------------------

def _mover_verts(p1, p2, dev, fill_p1: bool):
    """The capsule's core as an 8-row proxy: rows 0 and 1 hold p1 and p2;
    the others hold p1 (collide_mover) or zeros (cast_mover), as the JAX
    functions build them."""
    a = torch.as_tensor(p1, dtype=torch.float32, device=dev)
    b = torch.as_tensor(p2, dtype=torch.float32, device=dev)
    rest = a if fill_p1 else torch.zeros(2, device=dev)
    return torch.stack([a, b] + [rest] * (MAX_POLYGON_VERTICES - 2))


def cast_mover(state: WorldState, p1, p2, radius, translation,
               category_bits=0x1, mask_bits=0xFFFFFFFF, stats=None):
    """Capsule-mover shape cast with encroachment (ref: api/World.cs:
    568-626 CastMover): the largest fraction of `translation` the mover
    can travel, as a 0-d tensor."""
    sh = state.shapes
    dev = state.bodies.center.device
    cand = (_live(state) & ~sh.is_sensor
            & _query_filter_mask(state, category_bits, mask_bits))
    idx, ids = _lanes(cand, stats)
    if ids.size == 0:
        return torch.ones((), device=dev)
    p, q = _shape_pose(state)
    n = ids.size
    vb, cb, rb, pb, qb = _proxy_lanes(_mover_verts(p1, p2, dev, False), 2,
                                      radius, (0.0, 0.0), (1.0, 0.0), n, dev)
    tr = torch.as_tensor(translation, dtype=torch.float32,
                         device=dev).expand(n, 2)
    outs = shape_cast_pair(sh.verts[idx], sh.count[idx], sh.radius[idx],
                           vb, cb, rb, p[idx], q[idx], pb, qb, tr, 1.0,
                           can_encroach=True, stats=stats)
    return torch.where(outs.hit, outs.fraction, 1.0).min()


def solve_planes(target_delta, plane_normals, plane_offsets, push_limits,
                 valid):
    """Iteratively push a movement delta out of collision planes
    (ref: src/Mover.cs:11-34 SolvePlanes): 20 sweeps over the K planes,
    with no device read. Plane separation of point p: dot(normal, p) +
    offset. Returns (delta, push)."""
    n = plane_normals
    K = n.shape[0]
    delta = torch.as_tensor(target_delta, dtype=torch.float32,
                            device=n.device)
    push = [torch.zeros((), device=n.device) for _ in range(K)]
    for _ in range(20):
        for i in range(K):
            sep = m.dot(n[i], delta) + plane_offsets[i] + 0.005
            new_push = torch.minimum(torch.clamp(push[i] - sep, min=0.0),
                                     push_limits[i])
            dpush = torch.where(valid[i], new_push - push[i], 0.0)
            delta = m.mul_add(delta, dpush, n[i])
            push[i] = torch.where(valid[i], new_push, push[i])
    return delta, torch.stack(push)


def clip_vector(vector, plane_normals, push, clip_velocity, valid):
    """ref: src/Mover.cs:37-47 ClipVector."""
    v = torch.as_tensor(vector, dtype=torch.float32,
                        device=plane_normals.device)
    for i in range(plane_normals.shape[0]):
        active = valid[i] & (push[i] != 0.0) & clip_velocity[i]
        d = torch.clamp(m.dot(v, plane_normals[i]), max=0.0)
        v = torch.where(active, m.mul_sub(v, d, plane_normals[i]), v)
    return v


def collide_mover(state: WorldState, p1, p2, radius, max_planes: int = 8,
                  category_bits=0x1, mask_bits=0xFFFFFFFF, stats=None):
    """Collision planes of a capsule mover against all shapes (ref:
    api/World.cs:566-626 CollideMover): (normals (K, 2), offsets (K,),
    valid (K,)) of the deepest max_planes shapes, for solve_planes. Where
    fewer shapes touch, the rest are the lowest-index others, as
    `lax.top_k` breaks ties; their planes are computed as the JAX
    function computes them (a second GJK over the K chosen lanes)."""
    sh = state.shapes
    dev = state.bodies.center.device
    S = sh.type.shape[0]
    cand = (_live(state) & ~sh.is_sensor
            & _query_filter_mask(state, category_bits, mask_bits))
    idx, ids = _lanes(cand, stats)
    mover = _mover_verts(p1, p2, dev, True)

    def planes(lanes):
        n = lanes.shape[0]
        p, q = _shape_pose(state)
        vb, cb, rb, pb, qb = _proxy_lanes(mover, 2, 0.0, (0.0, 0.0),
                                          (1.0, 0.0), n, dev)
        out = shape_distance(sh.verts[lanes], sh.count[lanes],
                             torch.zeros(n, device=dev), vb, cb, rb,
                             p[lanes], q[lanes], pb, qb, stats=stats)
        total_r = radius + sh.radius[lanes]
        return out.distance <= total_r, out.normal, total_r - out.distance

    hit = torch.zeros(S, dtype=torch.bool, device=dev)
    score = torch.full((S,), -INF, device=dev)
    if ids.size:
        h, _, depth = planes(idx)
        hit[idx] = h
        score[idx] = torch.where(h, depth, -INF)
    _, top = _top_k(score, max_planes)
    _, normal, depth = planes(top)
    return normal, -depth, hit[top]
