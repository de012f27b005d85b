"""GJK distance, segment distance, the conservative-advancement shape cast
and time of impact, batched over lanes.

Torch port of box2d_tpu/distance.py (ref: src/Distance.cs). The JAX
functions take one pair and are vmapped; here every function takes the
lane axis first. Each `lax.while_loop` becomes a Python loop over all
lanes in which a per-lane `running` mask freezes the lanes that have
finished (their carry is kept with `torch.where`), which is what the
vmapped loop does: every lane runs until the last one stops, and a lane
whose condition is false keeps its carry. So the results match lane for
lane. The caps are the reference's loop bounds: GJK 20, cast 20, and in
the TOI 20 outer rounds, `MAX_POLYGON_VERTICES` push-back rounds
(box2d_tpu/distance.py:597) and 50 root-finder rounds. A loop stops early
once no lane is running; it reads that from the device once every
`CHECK_EVERY` rounds (the TOI's outer loop, whose round holds the inner
loops' launches, every round), through `StepStats.read` where the caller
passes one (rounds on frozen lanes change nothing). The caller's
`StepStats.rounds` counts the rounds each loop ran and those reads.

A proxy is (verts (N, V, 2), count (N,), radius (N,)); padded rows repeat
a real vertex so masked support maths stays finite. `active` (N,) bool,
where given, leaves the lanes outside it frozen from the start: their
outputs are the loop's initial carry, and the callers discard them.

Like the reference, this follows upstream Box2D v3 where the C# port
reads wB from proxy A (ref: Distance.cs:117/124/131).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math2d as m
from .constants import FLT_EPSILON, LINEAR_SLOP, MAX_POLYGON_VERTICES

GJK_ITERS = 20
CAST_ITERS = 20
TOI_ITERS = 20
PUSH_ITERS = MAX_POLYGON_VERTICES
ROOT_ITERS = 50
# rounds between two device reads of "is any lane still running"
CHECK_EVERY = 4

_EPS_SQR = float(torch.tensor(FLT_EPSILON * FLT_EPSILON,
                              dtype=torch.float32))

TOI_UNKNOWN = 0
TOI_OVERLAPPED = 1
TOI_HIT = 2
TOI_SEPARATED = 3
TOI_FAILED = 4


def _still_running(running, stats, r, loop, every=CHECK_EVERY):
    """False when round r of `loop` may be skipped: checked every `every`
    rounds, one device read each. Counts the round in `stats.rounds`."""
    if r % every == 0:
        if stats is None:
            return bool(running.any())
        stats.rounds["reads"] += 1
        (v,) = stats.read(running.any())
        if not v:
            return False
    if stats is not None:
        stats.rounds[loop] += 1
    return True


def _sel(c, a, b):
    """Per-lane select: c (N,) against a, b of shape (N, ...)."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


def _safe_den(x):
    return torch.where(x != 0.0, x, torch.ones_like(x))


def _take(x, idx):
    """x[n, idx[n]] for x (N, V) or (N, V, 2) and idx (N,)."""
    if x.dim() == 2:
        return x.gather(1, idx[:, None])[:, 0]
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


class SegmentDistanceResult(NamedTuple):
    fraction1: torch.Tensor
    fraction2: torch.Tensor
    closest1: torch.Tensor
    closest2: torch.Tensor
    distance_squared: torch.Tensor


def segment_distance(p1, q1, p2, q2) -> SegmentDistanceResult:
    """Closest points between two segments (box2d_tpu/distance.py:36, ref:
    src/Distance.cs:20-72)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    dd1 = m.dot(d1, d1)
    dd2 = m.dot(d2, d2)
    rd1 = m.dot(r, d1)
    rd2 = m.dot(r, d2)
    d12 = m.dot(d1, d2)
    denom = dd1 * dd2 - d12 * d12
    sdd1 = _safe_den(dd1)
    sdd2 = _safe_den(dd2)
    f1g = torch.where(denom != 0.0, torch.clamp(
        (d12 * rd2 - rd1 * dd2) / _safe_den(denom), 0.0, 1.0), 0.0)
    f2g = (d12 * f1g + rd2) / sdd2
    f1g = torch.where(
        f2g < 0.0, torch.clamp(-rd1 / sdd1, 0.0, 1.0),
        torch.where(f2g > 1.0, torch.clamp((d12 - rd1) / sdd1, 0.0, 1.0),
                    f1g))
    f2g = torch.clamp(f2g, 0.0, 1.0)
    f1_d1 = torch.clamp(-rd1 / sdd1, 0.0, 1.0)
    f2_d2 = torch.clamp(rd2 / sdd2, 0.0, 1.0)
    deg1 = dd1 < _EPS_SQR
    deg2 = dd2 < _EPS_SQR
    f1 = torch.where(deg1 | deg2, torch.where(~deg1, f1_d1, 0.0), f1g)
    f2 = torch.where(deg1 | deg2, torch.where(deg1 & ~deg2, f2_d2, 0.0), f2g)
    c1 = m.mul_add(p1, f1, d1)
    c2 = m.mul_add(p2, f2, d2)
    e = c2 - c1
    return SegmentDistanceResult(f1, f2, c1, c2, m.dot(e, e))


# ---------------------------------------------------------------------------
# GJK
# ---------------------------------------------------------------------------


def _find_support(verts, count, d):
    """Index (N,) of the first vertex with the largest dot(v, d), masking
    padded lanes (ref: src/Distance.cs:86-100)."""
    dots = verts[..., 0] * d[:, None, 0] + verts[..., 1] * d[:, None, 1]
    lane = torch.arange(verts.shape[1], device=verts.device)
    dots = torch.where(lane[None, :] < count[:, None], dots, float("-inf"))
    return torch.argmax(dots, dim=1)


class DistanceOutput(NamedTuple):
    point_a: torch.Tensor    # (N, 2) world witness on A
    point_b: torch.Tensor
    distance: torch.Tensor   # (N,)
    normal: torch.Tensor     # (N, 2) world unit normal from A to B
    cache_count: torch.Tensor    # (N,) simplex vertex count (3 = overlap)
    cache_index_a: torch.Tensor  # (N, 3)
    cache_index_b: torch.Tensor
    iterations: torch.Tensor


_CONSTS = {}


def _const(vals, n, like):
    """The row `vals` broadcast to (n, len(vals)), in like's dtype and on
    its device (uploaded once per device)."""
    key = (tuple(vals), like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(vals, dtype=like.dtype, device=like.device)
        if t.is_cuda:
            # the upload runs on this thread's stream; another thread's
            # stream may read the entry, so it is published once written
            torch.cuda.current_stream(t.device).synchronize()
        _CONSTS[key] = t
    return t.expand(n, len(vals))


def _solve_simplex2(w):
    """Closest point on a 1-simplex; returns (perm, a, count, d)
    (ref: src/Distance.cs:154-166)."""
    n = w.shape[0]
    w1, w2 = w[:, 0], w[:, 1]
    e12 = w2 - w1
    d12_2 = -m.dot(w1, e12)
    d12_1 = m.dot(w2, e12)
    inv = 1.0 / _safe_den(d12_1 + d12_2)
    c_v1 = d12_2 <= 0.0
    c_v2 = ~c_v1 & (d12_1 <= 0.0)
    vert = c_v1 | c_v2
    ip = c_v1.new_zeros((), dtype=torch.int64)
    perm = _sel(c_v2, _const([1, 1, 2], n, ip), _const([0, 1, 2], n, ip))
    z = torch.zeros_like(inv)
    new_a = _sel(vert, _const([1.0, 0.0, 0.0], n, inv),
                 torch.stack([d12_1 * inv, d12_2 * inv, z], dim=1))
    count = torch.where(vert, 1, 2)
    d_edge = m.cross_sv(m.cross(w1 + w2, e12), e12)
    d = _sel(c_v1, -w1, _sel(c_v2, -w2, d_edge))
    return perm, new_a, count, d


def _solve_simplex3(w):
    """Closest point on a 2-simplex (ref: src/Distance.cs:167-215)."""
    n = w.shape[0]
    w1, w2, w3 = w[:, 0], w[:, 1], w[:, 2]
    e12 = w2 - w1
    d12_1 = m.dot(w2, e12)
    d12_2 = -m.dot(w1, e12)
    e13 = w3 - w1
    d13_1 = m.dot(w3, e13)
    d13_2 = -m.dot(w1, e13)
    e23 = w3 - w2
    d23_1 = m.dot(w3, e23)
    d23_2 = -m.dot(w2, e23)
    n123 = m.cross(e12, e13)
    d123_1 = n123 * m.cross(w2, w3)
    d123_2 = n123 * m.cross(w3, w1)
    d123_3 = n123 * m.cross(w1, w2)

    # mutually prioritized regions, in the reference's if-chain order
    c1 = (d12_2 <= 0.0) & (d13_2 <= 0.0)
    c2 = (d12_1 > 0.0) & (d12_2 > 0.0) & (d123_3 <= 0.0)
    c3 = (d13_1 > 0.0) & (d13_2 > 0.0) & (d123_2 <= 0.0)
    c4 = (d12_1 <= 0.0) & (d23_2 <= 0.0)
    c5 = (d13_1 <= 0.0) & (d23_1 <= 0.0)
    c6 = (d23_1 > 0.0) & (d23_2 > 0.0) & (d123_1 <= 0.0)
    conds = (c1, c2, c3, c4, c5, c6)

    inv12 = 1.0 / _safe_den(d12_1 + d12_2)
    inv13 = 1.0 / _safe_den(d13_1 + d13_2)
    inv23 = 1.0 / _safe_den(d23_1 + d23_2)
    inv123 = 1.0 / _safe_den(d123_1 + d123_2 + d123_3)

    def pick(vals, default):
        out = default
        for cond, val in reversed(list(zip(conds, vals))):
            out = _sel(cond, val, out)
        return out

    ip = c1.new_zeros((), dtype=torch.int64)
    p012 = _const([0, 1, 2], n, ip)
    perm = pick((p012, p012, _const([0, 2, 2], n, ip),
                 _const([1, 1, 2], n, ip), _const([2, 1, 2], n, ip),
                 _const([2, 1, 2], n, ip)), p012)
    z = torch.zeros_like(inv12)
    one = _const([1.0, 0.0, 0.0], n, inv12)
    new_a = pick((one, torch.stack([d12_1 * inv12, d12_2 * inv12, z], 1),
                  torch.stack([d13_1 * inv13, d13_2 * inv13, z], 1),
                  one, one,
                  torch.stack([d23_2 * inv23, d23_1 * inv23, z], 1)),
                 torch.stack([d123_1 * inv123, d123_2 * inv123,
                              d123_3 * inv123], 1))
    ic = torch.zeros(n, dtype=torch.int64, device=w.device)
    count = pick(tuple(ic + k for k in (1, 2, 2, 1, 1, 2)), ic + 3)
    d_e12 = m.cross_sv(m.cross(w1 + w2, e12), e12)
    d_e13 = m.cross_sv(m.cross(w1 + w3, e13), e13)
    d_e23 = m.cross_sv(m.cross(w2 + w3, e23), e23)
    d = pick((-w1, d_e12, d_e13, -w2, -w3, d_e23), torch.zeros_like(w1))
    return perm, new_a, count, d


def shape_distance(verts_a, count_a, radius_a, verts_b, count_b, radius_b,
                   p_a, q_a, p_b, q_b, use_radii: bool = False,
                   active=None, stats=None) -> DistanceOutput:
    """GJK closest distance between two convex proxies per lane
    (box2d_tpu/distance.py:217, ref: src/Distance.cs:219-319)."""
    n = verts_a.shape[0]
    dev = verts_a.device
    xp, xq = m.inv_mul_transforms(p_a, q_a, p_b, q_b)
    local_b = m.rot_vec(xq[:, None, :], verts_b) + xp[:, None, :]
    count_a = count_a.long()
    count_b = count_b.long()

    # cold-start simplex: the first vertex pair (ref: :104-110)
    count = torch.ones(n, dtype=torch.int64, device=dev)
    idx_a = torch.zeros(n, 3, dtype=torch.int64, device=dev)
    idx_b = torch.zeros_like(idx_a)
    wa = verts_a[:, :1].expand(n, 3, 2)
    wb = local_b[:, :1].expand(n, 3, 2)
    bary = _const([1.0, 0.0, 0.0], n, wa)
    nun = torch.zeros(n, 2, dtype=wa.dtype, device=dev)
    it = torch.zeros(n, dtype=torch.int64, device=dev)
    done = (torch.zeros(n, dtype=torch.bool, device=dev) if active is None
            else ~active)
    overlap = torch.zeros(n, dtype=torch.bool, device=dev)
    slots = torch.arange(3, device=dev)
    for r in range(GJK_ITERS):
        running = ~done
        if not _still_running(running, stats, r, "gjk"):
            break
        w = wa - wb
        perm1, a1, cnt1, d1 = _solve_simplex2(w)
        perm3, a3, cnt3, d3 = _solve_simplex3(w)
        is1 = count == 1
        is2 = count == 2
        perm = _sel(is1, _const([0, 1, 2], n, perm1), _sel(is2, perm1, perm3))
        bary_n = _sel(is1, _const([1.0, 0.0, 0.0], n, a1),
                      _sel(is2, a1, a3))
        cnt_n = torch.where(is1, 1, torch.where(is2, cnt1, cnt3))
        d = _sel(is1, -w[:, 0], _sel(is2, d1, d3))

        pidx_a = idx_a.gather(1, perm)
        pidx_b = idx_b.gather(1, perm)
        p2 = perm[:, :, None].expand(n, 3, 2)
        pwa = wa.gather(1, p2)
        pwb = wb.gather(1, p2)

        # termination: triangle (overlap) or vanishing direction
        # (ref: :257-271)
        ovl = cnt_n == 3
        stop = ovl | (m.dot(d, d) < _EPS_SQR)
        nun_n = _sel(stop, nun, d)

        # support point (ref: :273-280)
        sa = _find_support(verts_a, count_a, d)
        sb = _find_support(local_b, count_b, -d)

        # duplicate support check against the simplex before it was
        # solved (ref: :282-295)
        dup = ((slots[None, :] < count[:, None]) & (sa[:, None] == idx_a)
               & (sb[:, None] == idx_b)).any(dim=1)

        # append at the post-solve count; a full simplex drops it
        put = slots[None, :] == cnt_n[:, None]
        grow = ~stop & ~dup
        put = put & grow[:, None]
        cnt_out = torch.where(grow, cnt_n + 1, cnt_n)
        idx_a_n = torch.where(put, sa[:, None], pidx_a)
        idx_b_n = torch.where(put, sb[:, None], pidx_b)
        wa_n = torch.where(put[..., None], _take(verts_a, sa)[:, None], pwa)
        wb_n = torch.where(put[..., None], _take(local_b, sb)[:, None], pwb)

        count = torch.where(running, cnt_out, count)
        idx_a = _sel(running, idx_a_n, idx_a)
        idx_b = _sel(running, idx_b_n, idx_b)
        wa = _sel(running, wa_n, wa)
        wb = _sel(running, wb_n, wb)
        bary = _sel(running, bary_n, bary)
        nun = _sel(running, nun_n, nun)
        it = it + running.long()
        overlap = torch.where(running, ovl, overlap)
        done = done | (running & (stop | dup))

    # witness points (ref: :144-153)
    b0, b1, b2 = bary[:, 0:1], bary[:, 1:2], bary[:, 2:3]
    is1 = count == 1
    is2 = count == 2
    la = _sel(is1, wa[:, 0], _sel(is2, b0 * wa[:, 0] + b1 * wa[:, 1],
                                  b0 * wa[:, 0] + b1 * wa[:, 1]
                                  + b2 * wa[:, 2]))
    lb = _sel(is1, wb[:, 0], _sel(is2, b0 * wb[:, 0] + b1 * wb[:, 1], la))

    normal = m.rot_vec(q_a, m.normalize(nun))
    dist = m.distance(la, lb)
    pa = m.transform_point(p_a, q_a, la)
    pb = m.transform_point(p_a, q_a, lb)  # both witnesses live in A's frame

    if use_radii:
        shrink = dist > 0.1 * LINEAR_SLOP
        dist_r = torch.clamp(dist - radius_a - radius_b, min=0.0)
        pa_r = m.mul_add(pa, radius_a, normal)
        pb_r = m.mul_sub(pb, radius_b, normal)
        dist = torch.where(shrink, dist_r, dist)
        pa = _sel(shrink, pa_r, pa)
        pb = _sel(shrink, pb_r, pb)

    dist = torch.where(overlap, 0.0, dist)
    normal = _sel(overlap, torch.zeros_like(normal), normal)
    return DistanceOutput(pa, pb, dist, normal, count.to(torch.int32),
                          idx_a.to(torch.int32), idx_b.to(torch.int32),
                          it.to(torch.int32))


# ---------------------------------------------------------------------------
# conservative-advancement shape cast (ref: src/Distance.cs:322-381)
# ---------------------------------------------------------------------------


class CastOutput(NamedTuple):
    fraction: torch.Tensor  # (N,)
    point: torch.Tensor     # (N, 2)
    normal: torch.Tensor    # (N, 2)
    hit: torch.Tensor       # (N,) bool


def shape_cast_pair(verts_a, count_a, radius_a, verts_b, count_b, radius_b,
                    p_a, q_a, p_b, q_b, translation_b, max_fraction,
                    can_encroach=False, active=None,
                    stats=None) -> CastOutput:
    """Cast proxy B (moving by translation_b) against static proxy A, per
    lane (box2d_tpu/distance.py:312)."""
    n = verts_a.shape[0]
    dev = verts_a.device
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    target = torch.clamp(radius_a + radius_b - LINEAR_SLOP, min=LINEAR_SLOP)
    tolerance = 0.25 * LINEAR_SLOP
    frac = zf
    it = torch.zeros(n, dtype=torch.int64, device=dev)
    done = (torch.zeros(n, dtype=torch.bool, device=dev) if active is None
            else ~active)
    out = CastOutput(zf, torch.zeros(n, 2, device=dev),
                     torch.zeros(n, 2, device=dev),
                     torch.zeros(n, dtype=torch.bool, device=dev))
    for r in range(CAST_ITERS):
        running = ~done
        if not _still_running(running, stats, r, "cast"):
            break
        pb_t = m.mul_add(p_b, frac, translation_b)
        d = shape_distance(verts_a, count_a, radius_a, verts_b, count_b,
                           radius_b, p_a, q_a, pb_t, q_b, active=running,
                           stats=stats)
        close = d.distance < target + tolerance

        # initial touch (ref: :349-361)
        first = it == 0
        encroach_ok = can_encroach & (d.distance > 2.0 * LINEAR_SLOP)
        target_n = torch.where(close & first & encroach_ok,
                               d.distance - LINEAR_SLOP, target)
        hit_first = close & first & ~encroach_ok
        c1 = m.mul_add(d.point_a, radius_a, d.normal)
        c2 = m.mul_add(d.point_b, -radius_b, d.normal)
        hit_later = close & ~first

        # conservative advancement (ref: :372-378) unless a hit above
        advancing = ~hit_first & ~hit_later
        denom = m.dot(translation_b, d.normal)
        miss = advancing & (denom >= 0.0)
        adv = (target_n - d.distance) / _safe_den(denom)
        frac_n = torch.where(advancing, frac + adv, frac)
        past = advancing & ~miss & (frac_n >= max_fraction)

        hf = running & hit_first
        hl = running & hit_later
        out = CastOutput(
            torch.where(hf, 0.0, torch.where(hl, frac, out.fraction)),
            _sel(hf, 0.5 * (c1 + c2),
                 _sel(hl, m.mul_add(d.point_a, radius_a, d.normal),
                      out.point)),
            _sel(hf | hl, d.normal, out.normal),
            out.hit | hf | hl)
        frac = torch.where(running, frac_n, frac)
        target = torch.where(running, target_n, target)
        it = it + running.long()
        done = done | (running & (hit_first | hit_later | miss | past))
    return out


# ---------------------------------------------------------------------------
# time of impact (ref: src/Distance.cs:382-645)
# ---------------------------------------------------------------------------


class Sweep(NamedTuple):
    """Body motion over the step, per lane (ref: include/Collision.cs
    :867-880)."""

    local_center: torch.Tensor  # (N, 2)
    c1: torch.Tensor            # COM at t = 0
    c2: torch.Tensor            # COM at t = 1
    q1: torch.Tensor            # rotation at t = 0
    q2: torch.Tensor            # rotation at t = 1


def sweep_transform(sweep: Sweep, t):
    """ref: src/Distance.cs:8-18 GetSweepTransform; t (N,)."""
    tt = t[:, None]
    p = (1.0 - tt) * sweep.c1 + tt * sweep.c2
    q = m.rot_normalize((1.0 - tt) * sweep.q1 + tt * sweep.q2)
    return p - m.rot_vec(q, sweep.local_center), q


class TOIOutput(NamedTuple):
    state: torch.Tensor     # (N,) i32 TOI_*
    fraction: torch.Tensor  # (N,)
    point: torch.Tensor     # (N, 2)
    normal: torch.Tensor    # (N, 2)


class _SepFn(NamedTuple):
    kind: torch.Tensor    # 0 points, 1 face A, 2 face B
    axis: torch.Tensor
    local_point: torch.Tensor


def _xf(p, q, v):
    return m.transform_point(p, q, v)


def time_of_impact(verts_a, count_a, radius_a, sweep_a: Sweep,
                   verts_b, count_b, radius_b, sweep_b: Sweep,
                   max_fraction, active=None, stats=None) -> TOIOutput:
    """Conservative-advancement TOI with swept separating axes, per lane
    (box2d_tpu/distance.py:384, ref: src/Distance.cs:529-645)."""
    n = verts_a.shape[0]
    dev = verts_a.device
    count_a = count_a.long()
    count_b = count_b.long()
    target = torch.clamp(radius_a + radius_b - LINEAR_SLOP, min=LINEAR_SLOP)
    tolerance = 0.25 * LINEAR_SLOP
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    tmax = zf + max_fraction

    def pose(t):
        return sweep_transform(sweep_a, t) + sweep_transform(sweep_b, t)

    def make_sep_fn(cache, t1):
        """ref: :390-444."""
        xa_p, xa_q, xb_p, xb_q = pose(t1)
        ia0 = cache.cache_index_a[:, 0].long()
        ia1 = cache.cache_index_a[:, 1].long()
        ib0 = cache.cache_index_b[:, 0].long()
        ib1 = cache.cache_index_b[:, 1].long()
        one_point = cache.cache_count == 1
        face_b = ~one_point & (ia0 == ia1)
        va0 = _take(verts_a, ia0)
        vb0 = _take(verts_b, ib0)

        pa = _xf(xa_p, xa_q, va0)
        pb = _xf(xb_p, xb_q, vb0)
        axis_pts = m.normalize(pb - pa)

        lb1, lb2 = vb0, _take(verts_b, ib1)
        one = torch.ones_like(zf)
        axis_fb = m.normalize(m.cross_vs(lb2 - lb1, one))
        lp_fb = 0.5 * (lb1 + lb2)
        nrm_fb = m.rot_vec(xb_q, axis_fb)
        s_fb = m.dot(pa - _xf(xb_p, xb_q, lp_fb), nrm_fb)
        axis_fb = _sel(s_fb < 0.0, -axis_fb, axis_fb)

        la1, la2 = va0, _take(verts_a, ia1)
        axis_fa = m.normalize(m.cross_vs(la2 - la1, one))
        lp_fa = 0.5 * (la1 + la2)
        nrm_fa = m.rot_vec(xa_q, axis_fa)
        s_fa = m.dot(pb - _xf(xa_p, xa_q, lp_fa), nrm_fa)
        axis_fa = _sel(s_fa < 0.0, -axis_fa, axis_fa)

        kind = torch.where(one_point, 0, torch.where(face_b, 2, 1))
        axis = _sel(one_point, axis_pts, _sel(face_b, axis_fb, axis_fa))
        local_point = _sel(one_point, torch.zeros_like(lp_fb),
                           _sel(face_b, lp_fb, lp_fa))
        return _SepFn(kind, axis, local_point)

    def find_min_separation(sf, t):
        """ref: :445-491."""
        xa_p, xa_q, xb_p, xb_q = pose(t)
        axis = sf.axis
        ia_pts = _find_support(verts_a, count_a, m.inv_rot_vec(xa_q, axis))
        ib_pts = _find_support(verts_b, count_b, m.inv_rot_vec(xb_q, -axis))
        s_pts = m.dot(_xf(xb_p, xb_q, _take(verts_b, ib_pts))
                      - _xf(xa_p, xa_q, _take(verts_a, ia_pts)), axis)
        nrm_a = m.rot_vec(xa_q, axis)
        ib_fa = _find_support(verts_b, count_b, m.inv_rot_vec(xb_q, -nrm_a))
        s_fa = m.dot(_xf(xb_p, xb_q, _take(verts_b, ib_fa))
                     - _xf(xa_p, xa_q, sf.local_point), nrm_a)
        nrm_b = m.rot_vec(xb_q, axis)
        ia_fb = _find_support(verts_a, count_a, m.inv_rot_vec(xa_q, -nrm_b))
        s_fb = m.dot(_xf(xa_p, xa_q, _take(verts_a, ia_fb))
                     - _xf(xb_p, xb_q, sf.local_point), nrm_b)
        k0, k1 = sf.kind == 0, sf.kind == 1
        ia = torch.where(k0, ia_pts, torch.where(k1, -1, ia_fb))
        ib = torch.where(k0, ib_pts, torch.where(k1, ib_fa, -1))
        s = torch.where(k0, s_pts, torch.where(k1, s_fa, s_fb))
        return s, ia, ib

    def evaluate_separation(sf, vac, vbc, t):
        """ref: :492-524; vac / vbc are the support vertices A[ia] and
        B[ib] (index 0 where the kind has none)."""
        xa_p, xa_q, xb_p, xb_q = pose(t)
        wa_ = _xf(xa_p, xa_q, vac)
        wb_ = _xf(xb_p, xb_q, vbc)
        s_pts = m.dot(wb_ - wa_, sf.axis)
        s_fa = m.dot(wb_ - _xf(xa_p, xa_q, sf.local_point),
                     m.rot_vec(xa_q, sf.axis))
        s_fb = m.dot(wa_ - _xf(xb_p, xb_q, sf.local_point),
                     m.rot_vec(xb_q, sf.axis))
        return torch.where(sf.kind == 0, s_pts,
                           torch.where(sf.kind == 1, s_fa, s_fb))

    t1 = zf
    done = (torch.zeros(n, dtype=torch.bool, device=dev) if active is None
            else ~active)
    st = torch.full((n,), TOI_UNKNOWN, dtype=torch.int32, device=dev)
    out = TOIOutput(st, tmax, torch.zeros(n, 2, device=dev),
                    torch.zeros(n, 2, device=dev))
    for r in range(TOI_ITERS):
        running = ~done
        if not _still_running(running, stats, r, "toi", every=1):
            break
        xa_p, xa_q, xb_p, xb_q = pose(t1)
        d = shape_distance(verts_a, count_a, 0.0, verts_b, count_b, 0.0,
                           xa_p, xa_q, xb_p, xb_q, active=running,
                           stats=stats)
        overlapped = d.distance <= 0.0
        touching = ~overlapped & (d.distance <= target + tolerance)
        pa_r = m.mul_add(d.point_a, radius_a, d.normal)
        pb_r = m.mul_add(d.point_b, -radius_b, d.normal)
        mid = 0.5 * (pa_r + pb_r)
        sf = make_sep_fn(d, t1)

        # the push-back loop over t2 (ref: :583-631); istate 0 continue,
        # 1 advance t1 = t2, 2 separated, 3 failed, 4 hit
        t1i, t2 = t1, tmax
        idone = overlapped | touching | ~running
        istate = torch.zeros(n, dtype=torch.int64, device=dev)
        for pr in range(PUSH_ITERS):
            irun = ~idone
            if not _still_running(irun, stats, pr, "push"):
                break
            s2, ia, ib = find_min_separation(sf, t2)
            vac = _take(verts_a, torch.clamp(ia, min=0))
            vbc = _take(verts_b, torch.clamp(ib, min=0))
            separated = s2 > target + tolerance
            advanced = ~separated & (s2 > target - tolerance)
            s1 = evaluate_separation(sf, vac, vbc, t1i)
            failed = ~separated & ~advanced & (s1 < target - tolerance)
            hit_now = (~separated & ~advanced & ~failed
                       & (s1 <= target + tolerance))
            new_state = torch.where(
                separated, 2, torch.where(advanced, 1, torch.where(
                    failed, 3, torch.where(hit_now, 4, 0))))

            # the root finder: false position / bisection (ref: :615-628);
            # its result is read only where new_state is 0
            a1, a2, s1r, s2r = t1i, t2, s1, s2
            rdone = ~(irun & (new_state == 0))
            rconv = torch.zeros(n, dtype=torch.bool, device=dev)
            t_out = t2
            for k in range(ROOT_ITERS):
                rrun = ~rdone
                if not _still_running(rrun, stats, k, "root"):
                    break
                if k & 1:
                    t_mid = a1 + (target - s1r) * (a2 - a1) / _safe_den(
                        s2r - s1r)
                else:
                    t_mid = 0.5 * (a1 + a2)
                s = evaluate_separation(sf, vac, vbc, t_mid)
                converged = torch.abs(s - target) < tolerance
                upper = s > target
                a1 = torch.where(rrun & upper, t_mid, a1)
                s1r = torch.where(rrun & upper, s, s1r)
                a2 = torch.where(rrun & ~upper, t_mid, a2)
                s2r = torch.where(rrun & ~upper, s, s2r)
                t_out = torch.where(rrun & converged, t_mid, t_out)
                rconv = rconv | (rrun & converged)
                rdone = rdone | (rrun & converged)
            t2n = torch.where(rconv, t_out, t2)

            idone_n = new_state != 0
            t1i = torch.where(irun & advanced, t2, t1i)
            t2 = torch.where(irun & ~idone_n, t2n, t2)
            istate = torch.where(irun, new_state, istate)
            idone = idone | (irun & (idone_n | (pr + 1 >= PUSH_ITERS)))

        # the outcome of this round, in the reference's order of priority
        f_st, f_fr, f_pt, f_nm = out
        i32 = lambda v: torch.full_like(f_st, v)
        for cond, (o_st, o_fr, o_pt, o_nm) in (
                (istate == 2, (i32(TOI_SEPARATED), tmax, f_pt, f_nm)),
                (istate == 3, (i32(TOI_FAILED), t1i, mid, d.normal)),
                (istate == 4, (i32(TOI_HIT), t1i, mid, d.normal)),
                (touching, (i32(TOI_HIT), t1, mid, d.normal)),
                (overlapped, (i32(TOI_OVERLAPPED), zf, f_pt, f_nm))):
            f_st = torch.where(cond, o_st, f_st)
            f_fr = torch.where(cond, o_fr, f_fr)
            f_pt = _sel(cond, o_pt, f_pt)
            f_nm = _sel(cond, o_nm, f_nm)
        finished = overlapped | touching | (istate >= 2)
        timeout = ~finished & (r + 1 >= TOI_ITERS)
        f_st = torch.where(timeout, TOI_FAILED, f_st)
        f_fr = torch.where(timeout, t1i, f_fr)
        f_pt = _sel(timeout, mid, f_pt)
        f_nm = _sel(timeout, d.normal, f_nm)
        out = TOIOutput(torch.where(running, f_st, out.state),
                        torch.where(running, f_fr, out.fraction),
                        _sel(running, f_pt, out.point),
                        _sel(running, f_nm, out.normal))
        t1 = torch.where(running, t1i, t1)
        done = done | (running & (finished | timeout))
    return out
