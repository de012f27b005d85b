"""Contact manifolds for circles, capsules, segments, polygons and chain
segments.

Torch port of box2d_tpu/manifold.py: the `Manifold` record,
`collide_polygons_batched` (:419, ref: src/Manifold.cs:410-562) and its
one-pair case `collide_polygons` (:324), the four
classes a scene of circles and capsules adds: `collide_circles`,
`collide_capsule_circle`, `collide_polygon_circle` and `collide_capsules`
(:100-275), and the one-sided chain segment against a circle and against
a polygon or capsule (:703-941, ref: src/Manifold.cs:570-915). The JAX
functions take one pair and are vmapped; here every function takes the
pair axis first and is plain tensor code in the same order of operations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math2d as m
from .constants import FLT_EPSILON, LINEAR_SLOP, SPECULATIVE_DISTANCE
from .distance import segment_distance, shape_distance


class Manifold(NamedTuple):
    """Up-to-two-point contact manifold, batched over pair lanes (P, ...).
    anchor_a/anchor_b are world-oriented offsets from each body's origin."""

    normal: torch.Tensor      # (P, 2)
    point_count: torch.Tensor  # (P,) i32
    anchor_a: torch.Tensor    # (P, 2, 2)
    anchor_b: torch.Tensor    # (P, 2, 2)
    point: torch.Tensor       # (P, 2, 2)
    separation: torch.Tensor  # (P, 2)
    ids: torch.Tensor         # (P, 2) i32


def _w(c, a, b):
    return torch.where(c, a, b)


def _make_id(a, b):
    """Feature id packing (ref: src/Manifold.cs:22 B2_MAKE_ID)."""
    return (a << 8) | (b & 0xFF)


def _safe_div(num, den):
    return num / torch.where(den != 0.0, den, 1.0)


def _wv(c, a, b):
    """Per-lane select between (P, 2) vectors."""
    return torch.where(c[:, None], a, b)


def _manifold(normal, count, anchors, seps, ids, p_a, q_a, p_b, live,
              origin=None) -> Manifold:
    """Rotate local anchors (P, 2, 2) into world orientation, derive
    anchor_b and point (box2d_tpu/manifold.py:67 _finalize), then zero the
    lanes outside `live` (the `_select(..., _empty())` of the JAX code)."""
    if origin is not None:
        anchors = anchors + origin[:, None, :]
    aa = m.rot_vec(q_a[:, None, :], anchors)
    ab = aa + (p_a - p_b)[:, None, :]
    pt = aa + p_a[:, None, :]
    out = Manifold(m.rot_vec(q_a, normal), count.to(torch.int32), aa, ab, pt,
                   seps, ids.to(torch.int32))
    return Manifold(*[
        torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
        for x in out])


def _one_point(normal, anchor, separation, pid, p_a, q_a, p_b, live,
               origin=None) -> Manifold:
    z = torch.zeros_like(anchor)
    zs = torch.zeros_like(separation)
    if not isinstance(pid, torch.Tensor):
        pid = torch.full_like(separation, pid, dtype=torch.int32)
    return _manifold(normal, torch.ones_like(pid),
                     torch.stack([anchor, z], dim=1),
                     torch.stack([separation, zs], dim=1),
                     torch.stack([pid, torch.zeros_like(pid)], dim=1),
                     p_a, q_a, p_b, live, origin)


def collide_circles(center_a, radius_a, p_a, q_a, center_b, radius_b, p_b,
                    q_b) -> Manifold:
    """ref: src/Manifold.cs:24-46."""
    xp, xq = m.inv_mul_transforms(p_a, q_a, p_b, q_b)
    point_a = center_a
    point_b = m.transform_point(xp, xq, center_b)
    normal, dist = m.get_length_and_normalize(point_b - point_a)
    separation = dist - radius_a - radius_b
    c_a = m.mul_add(point_a, radius_a, normal)
    c_b = m.mul_add(point_b, -radius_b, normal)
    return _one_point(normal, 0.5 * (c_a + c_b), separation, 0, p_a, q_a,
                      p_b, separation <= SPECULATIVE_DISTANCE)


def collide_capsule_circle(p1, p2, radius_a, p_a, q_a, center_b, radius_b,
                           p_b, q_b) -> Manifold:
    """ref: src/Manifold.cs:49-83. Also serves segment-vs-circle."""
    xp, xq = m.inv_mul_transforms(p_a, q_a, p_b, q_b)
    pb = m.transform_point(xp, xq, center_b)
    e = p2 - p1
    s1 = m.dot(pb - p1, e)
    s2 = m.dot(p2 - pb, e)
    s = _safe_div(s1, m.dot(e, e))
    pa = _wv(s1 < 0.0, p1, _wv(s2 < 0.0, p2, m.mul_add(p1, s, e)))
    normal, dist = m.get_length_and_normalize(pb - pa)
    separation = dist - radius_a - radius_b
    c_a = m.mul_add(pa, radius_a, normal)
    c_b = m.mul_add(pb, -radius_b, normal)
    return _one_point(normal, 0.5 * (c_a + c_b), separation, 0, p_a, q_a,
                      p_b, separation <= SPECULATIVE_DISTANCE)


def collide_polygon_circle(verts, normals, count, radius_a, p_a, q_a,
                           center_b, radius_b, p_b, q_b) -> Manifold:
    """ref: src/Manifold.cs:91-165. verts/normals (P, V, 2), count >= 3."""
    P, V = verts.shape[0], verts.shape[1]
    lane = torch.arange(P, device=verts.device)
    xp, xq = m.inv_mul_transforms(p_a, q_a, p_b, q_b)
    center = m.transform_point(xp, xq, center_b)
    radius = radius_a + radius_b

    seps = m.dot(normals, center[:, None, :] - verts)
    seps = torch.where(torch.arange(V, device=verts.device)[None, :]
                       < count[:, None], seps, float("-inf"))
    normal_index = torch.argmax(seps, dim=1)
    separation = seps[lane, normal_index]

    i1 = normal_index
    i2 = torch.where(i1 + 1 < count, i1 + 1, 0)
    v1 = verts[lane, i1]
    v2 = verts[lane, i2]
    u1 = m.dot(center - v1, v2 - v1)
    u2 = m.dot(center - v2, v1 - v2)
    deep = separation <= FLT_EPSILON

    n_v1 = m.normalize(center - v1)
    sep_v1 = m.dot(center - v1, n_v1)
    n_v2 = m.normalize(center - v2)
    sep_v2 = m.dot(center - v2, n_v2)
    n_face = normals[lane, normal_index]

    use_v1 = (u1 < 0.0) & ~deep
    use_v2 = (u2 < 0.0) & ~deep & ~use_v1
    normal = _wv(use_v1, n_v1, _wv(use_v2, n_v2, n_face))
    sep_out = _w(use_v1, sep_v1, _w(use_v2, sep_v2, separation))

    vref = _wv(use_v2, v2, v1)
    c_a_vert = m.mul_add(vref, radius_a, normal)
    c_a_face = m.mul_add(center, radius_a - m.dot(center - v1, n_face),
                         n_face)
    c_a = _wv(use_v1 | use_v2, c_a_vert, c_a_face)
    c_b = m.mul_sub(center, radius_b, normal)
    sep_final = _w(use_v1 | use_v2, m.dot(c_b - c_a, normal),
                   separation - radius)
    return _one_point(normal, 0.5 * (c_a + c_b), sep_final, 0, p_a, q_a, p_b,
                      sep_out <= radius + SPECULATIVE_DISTANCE)


def collide_capsules(a1, a2, radius_a, p_a, q_a, b1, b2, radius_b, p_b,
                     q_b) -> Manifold:
    """Capsule vs capsule, both 2-vertex (ref: src/Manifold.cs:167-315)."""
    origin = a1
    sp_a = p_a + m.rot_vec(q_a, origin)
    xp, xq = m.inv_mul_transforms(sp_a, q_a, p_b, q_b)
    p1 = torch.zeros_like(a1)
    q1 = a2 - origin
    p2 = m.transform_point(xp, xq, b1)
    q2 = m.transform_point(xp, xq, b2)

    f1, f2, closest1, closest2, dsq = segment_distance(p1, q1, p2, q2)
    radius = radius_a + radius_b
    max_distance = radius + SPECULATIVE_DISTANCE
    in_range = dsq <= max_distance * max_distance
    dist = torch.sqrt(torch.clamp(dsq, min=0.0))

    u1, length1 = m.get_length_and_normalize(q1 - p1)
    u2, length2 = m.get_length_and_normalize(q2 - p2)
    fp2 = m.dot(p2 - p1, u1)
    fq2 = m.dot(q2 - p1, u1)
    outside_a = (((fp2 < 0.0) & (fq2 < 0.0))
                 | ((fp2 >= length1) & (fq2 >= length1)))
    fp1 = m.dot(p1 - p2, u2)
    fq1 = m.dot(q1 - p2, u2)
    outside_b = (((fp1 < 0.0) & (fq1 < 0.0))
                 | ((fp1 >= length2) & (fq1 >= length2)))
    parallel_overlap = ~outside_a & ~outside_b

    def seg_separation(nrm, pa_, pb_, qb_):
        ss1 = m.dot(pb_ - pa_, nrm)
        ss2 = m.dot(qb_ - pa_, nrm)
        s_pos = torch.minimum(ss1, ss2)
        s_neg = torch.minimum(-ss1, -ss2)
        flipn = s_pos <= s_neg
        return _w(flipn, s_neg, s_pos), _wv(flipn, -nrm, nrm)

    sep_a, normal_a = seg_separation(m.left_perp(u1), p1, p2, q2)
    sep_b, normal_b = seg_separation(m.left_perp(u2), p2, p1, q1)
    use_a = sep_a + 0.1 * LINEAR_SLOP >= sep_b

    def clip_two(pc, qc, fp, fq, ln):
        s_lo = _safe_div(-fp, fq - fp)
        c_lo = _wv((fp < 0.0) & (fq > 0.0), m.lerp(pc, qc, s_lo), pc)
        t_lo = _safe_div(-fq, fp - fq)
        d_lo = _wv((fq < 0.0) & (fp > 0.0), m.lerp(qc, pc, t_lo), qc)
        s_hi = _safe_div(fp - ln, fp - fq)
        c_hi = _wv((fp > ln) & (fq < ln), m.lerp(pc, qc, s_hi), c_lo)
        t_hi = _safe_div(fq - ln, fq - fp)
        d_hi = _wv((fq > ln) & (fp < ln), m.lerp(qc, pc, t_hi), d_lo)
        return c_hi, d_hi

    cpa, cqa = clip_two(p2, q2, fp2, fq2, length1)
    spa = m.dot(cpa - p1, normal_a)
    sqa = m.dot(cqa - p1, normal_a)
    ok_a = (spa <= dist + LINEAR_SLOP) | (sqa <= dist + LINEAR_SLOP)
    pt0_a = m.mul_add(cpa, 0.5 * (radius_a - radius_b - spa), normal_a)
    pt1_a = m.mul_add(cqa, 0.5 * (radius_a - radius_b - sqa), normal_a)

    cpb, cqb = clip_two(p1, q1, fp1, fq1, length2)
    spb = m.dot(cpb - p2, normal_b)
    sqb = m.dot(cqb - p2, normal_b)
    ok_b = (spb <= dist + LINEAR_SLOP) | (sqb <= dist + LINEAR_SLOP)
    pt0_b = m.mul_add(cpb, 0.5 * (radius_b - radius_a - spb), normal_b)
    pt1_b = m.mul_add(cqb, 0.5 * (radius_b - radius_a - sqb), normal_b)

    two_pt = parallel_overlap & _w(use_a, ok_a, ok_b)

    # two-point manifold
    n2 = _wv(use_a, normal_a, -normal_b)
    a2_0 = _wv(use_a, pt0_a, pt0_b)
    a2_1 = _wv(use_a, pt1_a, pt1_b)
    s2_0 = _w(use_a, spa, spb) - radius
    s2_1 = _w(use_a, sqa, sqb) - radius
    id2_1 = _w(use_a, _make_id(0, 1), _make_id(1, 0))

    # single-point fallback (ref: :284-298)
    nrm = closest2 - closest1
    nrm = _wv(m.dot(nrm, nrm) > FLT_EPSILON * FLT_EPSILON,
              m.normalize(nrm), m.left_perp(u1))
    c1 = m.mul_add(closest1, radius_a, nrm)
    c2 = m.mul_add(closest2, -radius_b, nrm)
    i1 = _w(f1 == 0.0, 0, 1)
    i2 = _w(f2 == 0.0, 0, 1)
    a1_0 = 0.5 * (c1 + c2)
    s1_0 = dist - radius
    id1_0 = _make_id(i1, i2)

    zero2 = torch.zeros_like(a1_0)
    normal = _wv(two_pt, n2, nrm)
    count = _w(two_pt, 2, 1)
    anchors = torch.stack([_wv(two_pt, a2_0, a1_0),
                           _wv(two_pt, a2_1, zero2)], dim=1)
    seps = torch.stack([_w(two_pt, s2_0, s1_0), _w(two_pt, s2_1, 0.0)],
                       dim=1)
    ids = torch.stack([_w(two_pt, 0, id1_0), _w(two_pt, id2_1, 0)], dim=1)
    return _manifold(normal, count, anchors, seps, ids, p_a, q_a, p_b,
                     in_range, origin=origin)


def collide_polygons(va, na, ca, ra, p_a, q_a, vb, nb, cb, rb, p_b,
                     q_b) -> Manifold:
    """One polygon pair (box2d_tpu/manifold.py:324, for one-off callers):
    va/na (V, 2), ca and ra scalars, p_a/q_a (2,); the same for b. The
    one-lane case of collide_polygons_batched; every field without the
    pair axis."""
    dev = va.device

    def lane(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)[None]

    f32, i32 = torch.float32, torch.int32
    man = collide_polygons_batched(
        lane(va, f32), lane(na, f32), lane(ca, i32), lane(ra, f32),
        lane(p_a, f32), lane(q_a, f32), lane(vb, f32), lane(nb, f32),
        lane(cb, i32), lane(rb, f32), lane(p_b, f32), lane(q_b, f32))
    return Manifold(*(x[0] for x in man))


def collide_polygons_batched(va, na, ca, ra, p_a, q_a,
                             vb, nb_, cb, rb, p_b, q_b) -> Manifold:
    """Lane-major polygon-polygon manifolds: va/na (P, V, 2), ca (P,) i32,
    ra (P,), p_a/q_a (P, 2); same for b. Same arithmetic, in the same order,
    as the JAX function."""
    P, V = va.shape[0], va.shape[1]
    dev = va.device
    lanes = torch.arange(V, device=dev)
    inf = float("inf")

    vax, vay = va[..., 0], va[..., 1]
    nax, nay = na[..., 0], na[..., 1]
    vbx, vby = vb[..., 0], vb[..., 1]
    nbx, nby = nb_[..., 0], nb_[..., 1]
    qac, qas = q_a[:, 0], q_a[:, 1]
    qbc, qbs = q_b[:, 0], q_b[:, 1]

    def sel(arr, idx):
        oh = idx[:, None] == lanes[None, :]
        return torch.where(oh, arr, 0.0).sum(dim=1)

    ox, oy = vax[:, 0], vay[:, 0]
    spx = p_a[:, 0] + qac * ox - qas * oy
    spy = p_a[:, 1] + qas * ox + qac * oy
    dx = p_b[:, 0] - spx
    dy = p_b[:, 1] - spy
    xpx = qac * dx + qas * dy
    xpy = -qas * dx + qac * dy
    xqc = qac * qbc + qas * qbs
    xqs = qac * qbs - qas * qbc

    lvax = vax - ox[:, None]
    lvay = vay - oy[:, None]
    lnax, lnay = nax, nay
    lvbx = xqc[:, None] * vbx - xqs[:, None] * vby + xpx[:, None]
    lvby = xqs[:, None] * vbx + xqc[:, None] * vby + xpy[:, None]
    lnbx = xqc[:, None] * nbx - xqs[:, None] * nby
    lnby = xqs[:, None] * nbx + xqc[:, None] * nby

    ok_a = lanes[None, :] < ca[:, None]
    ok_b = lanes[None, :] < cb[:, None]

    def max_separation(n1x, n1y, v1x, v1y, c1ok, v2x, v2y, c2ok):
        best_sep = torch.full((P,), -inf, dtype=torch.float32, device=dev)
        best_i = torch.zeros((P,), dtype=torch.int32, device=dev)
        for i in range(V):
            sij = (n1x[:, i:i + 1] * (v2x - v1x[:, i:i + 1])
                   + n1y[:, i:i + 1] * (v2y - v1y[:, i:i + 1]))
            si = torch.where(c2ok, sij, inf).min(dim=1).values
            take = c1ok[:, i] & (si > best_sep)
            best_sep = _w(take, si, best_sep)
            best_i = _w(take, i, best_i)
        return best_sep, best_i

    sep_a, edge_a0 = max_separation(lnax, lnay, lvax, lvay, ok_a,
                                    lvbx, lvby, ok_b)
    sep_b, edge_b0 = max_separation(lnbx, lnby, lvbx, lvby, ok_b,
                                    lvax, lvay, ok_a)
    radius = ra + rb
    in_range = ((sep_a <= SPECULATIVE_DISTANCE + radius)
                & (sep_b <= SPECULATIVE_DISTANCE + radius))
    flip = sep_a < sep_b

    ena_x = sel(lnax, edge_a0)
    ena_y = sel(lnay, edge_a0)
    dots_b = torch.where(ok_b, lnbx * ena_x[:, None] + lnby * ena_y[:, None],
                         inf)
    inc_b = torch.argmin(dots_b, dim=1).to(torch.int32)
    enb_x = sel(lnbx, edge_b0)
    enb_y = sel(lnby, edge_b0)
    dots_a = torch.where(ok_a, lnax * enb_x[:, None] + lnay * enb_y[:, None],
                         inf)
    inc_a = torch.argmin(dots_a, dim=1).to(torch.int32)
    edge_a = _w(flip, inc_a, edge_a0)
    edge_b = _w(flip, edge_b0, inc_b)

    c_ref = _w(flip, cb, ca)
    c_inc = _w(flip, ca, cb)
    i11 = _w(flip, edge_b, edge_a)
    i12 = _w(i11 + 1 < c_ref, i11 + 1, 0)
    i21 = _w(flip, edge_a, edge_b)
    i22 = _w(i21 + 1 < c_inc, i21 + 1, 0)
    fl = flip[:, None]
    rvx = _w(fl, lvbx, lvax)
    rvy = _w(fl, lvby, lvay)
    rnx = _w(fl, lnbx, lnax)
    rny = _w(fl, lnby, lnay)
    ivx = _w(fl, lvax, lvbx)
    ivy = _w(fl, lvay, lvby)
    v11x, v11y = sel(rvx, i11), sel(rvy, i11)
    v12x, v12y = sel(rvx, i12), sel(rvy, i12)
    v21x, v21y = sel(ivx, i21), sel(ivy, i21)
    v22x, v22y = sel(ivx, i22), sel(ivy, i22)
    nrx, nry = sel(rnx, i11), sel(rny, i11)
    tx, ty = -nry, nrx
    upper1 = (v12x - v11x) * tx + (v12y - v11y) * ty
    upper2 = (v21x - v11x) * tx + (v21y - v11y) * ty
    lower2 = (v22x - v11x) * tx + (v22y - v11y) * ty
    nonoverlap = (upper2 < 0.0) | (upper1 < lower2)

    span = upper2 - lower2
    big = span > FLT_EPSILON
    safe_span = _w(span != 0.0, span, 1.0)
    t_lo = (0.0 - lower2) / safe_span
    t_up = (upper1 - lower2) / safe_span
    lo_clip = (lower2 < 0.0) & big
    up_clip = (upper2 > upper1) & big
    v_lo_x = _w(lo_clip, v22x + (v21x - v22x) * t_lo, v22x)
    v_lo_y = _w(lo_clip, v22y + (v21y - v22y) * t_lo, v22y)
    v_up_x = _w(up_clip, v22x + (v21x - v22x) * t_up, v21x)
    v_up_y = _w(up_clip, v22y + (v21y - v22y) * t_up, v21y)
    sep_lower = (v_lo_x - v11x) * nrx + (v_lo_y - v11y) * nry
    sep_upper = (v_up_x - v11x) * nrx + (v_up_y - v11y) * nry

    nmx = _w(flip, -nrx, nrx)
    nmy = _w(flip, -nry, nry)
    r1 = _w(flip, rb, ra)
    r2 = _w(flip, ra, rb)
    adj_lo = 0.5 * (r1 - r2 - sep_lower)
    adj_up = 0.5 * (r1 - r2 - sep_upper)
    v_lo_x = v_lo_x + adj_lo * nrx
    v_lo_y = v_lo_y + adj_lo * nry
    v_up_x = v_up_x + adj_up * nrx
    v_up_y = v_up_y + adj_up * nry

    id0 = _w(flip, _make_id(i21, i12), _make_id(i11, i22))
    id1 = _w(flip, _make_id(i22, i11), _make_id(i12, i21))
    pt0x = _w(flip, v_up_x, v_lo_x)
    pt0y = _w(flip, v_up_y, v_lo_y)
    pt1x = _w(flip, v_lo_x, v_up_x)
    pt1y = _w(flip, v_lo_y, v_up_y)
    sp0 = _w(flip, sep_upper, sep_lower) - radius
    sp1 = _w(flip, sep_lower, sep_upper) - radius
    clip_count = _w(nonoverlap, 0, 2).to(torch.int32)

    # vertex-vertex fallback when separated (ref: :474-544)
    speculative = torch.maximum(sep_a, sep_b) > 0.1 * LINEAR_SLOP
    j11 = edge_a
    j12 = _w(edge_a + 1 < ca, edge_a + 1, 0)
    j21 = edge_b
    j22 = _w(edge_b + 1 < cb, edge_b + 1, 0)
    p1x, p1y = sel(lvax, j11), sel(lvay, j11)
    q1x, q1y = sel(lvax, j12), sel(lvay, j12)
    p2x, p2y = sel(lvbx, j21), sel(lvby, j21)
    q2x, q2y = sel(lvbx, j22), sel(lvby, j22)
    d1x, d1y = q1x - p1x, q1y - p1y
    d2x, d2y = q2x - p2x, q2y - p2y
    rx, ry = p1x - p2x, p1y - p2y
    dd1 = d1x * d1x + d1y * d1y
    dd2 = d2x * d2x + d2y * d2y
    rd1 = rx * d1x + ry * d1y
    rd2 = rx * d2x + ry * d2y
    eps_sqr = float(torch.tensor(FLT_EPSILON * FLT_EPSILON,
                                 dtype=torch.float32))
    d12 = d1x * d2x + d1y * d2y
    denom = dd1 * dd2 - d12 * d12
    sdd1 = _w(dd1 != 0.0, dd1, 1.0)
    sdd2 = _w(dd2 != 0.0, dd2, 1.0)
    f1g = _w(denom != 0.0,
             torch.clamp((d12 * rd2 - rd1 * dd2) / _w(denom != 0.0, denom, 1.0),
                         0.0, 1.0), 0.0)
    f2g = (d12 * f1g + rd2) / sdd2
    f1g = _w(f2g < 0.0, torch.clamp(-rd1 / sdd1, 0.0, 1.0),
             _w(f2g > 1.0, torch.clamp((d12 - rd1) / sdd1, 0.0, 1.0), f1g))
    f2g = torch.clamp(f2g, 0.0, 1.0)
    f1_d1 = torch.clamp(-rd1 / sdd1, 0.0, 1.0)
    f2_d2 = torch.clamp(rd2 / sdd2, 0.0, 1.0)
    deg1 = dd1 < eps_sqr
    deg2 = dd2 < eps_sqr
    f1 = _w(deg1 | deg2, _w(~deg1, f1_d1, 0.0), f1g)
    f2 = _w(deg1 | deg2, _w(deg1 & ~deg2, f2_d2, 0.0), f2g)
    c1x, c1y = p1x + f1 * d1x, p1y + f1 * d1y
    c2x, c2y = p2x + f2 * d2x, p2y + f2 * d2y
    ex, ey = c2x - c1x, c2y - c1y
    dsq = ex * ex + ey * ey
    dist = torch.sqrt(torch.clamp(dsq, min=0.0))
    separation = dist - radius
    beyond = speculative & (separation > SPECULATIVE_DISTANCE)

    min_sep = torch.minimum(_w(clip_count > 0, sp0, inf),
                            _w(clip_count > 1, sp1, inf))
    vertex_case = (speculative
                   & (separation + 0.1 * LINEAR_SLOP < min_sep)
                   & ((f1 == 0.0) | (f1 == 1.0))
                   & ((f2 == 0.0) | (f2 == 1.0)))

    va_px = _w(f1 == 0.0, p1x, q1x)
    va_py = _w(f1 == 0.0, p1y, q1y)
    vb_px = _w(f2 == 0.0, p2x, q2x)
    vb_py = _w(f2 == 0.0, p2y, q2y)
    ia = _w(f1 == 0.0, j11, j12)
    ib = _w(f2 == 0.0, j21, j22)
    inv_d = _w(dist != 0.0, 1.0 / _w(dist != 0.0, dist, 1.0), 0.0)
    nvx = (vb_px - va_px) * inv_d
    nvy = (vb_py - va_py) * inv_d
    ca1x = va_px + ra * nvx
    ca1y = va_py + ra * nvy
    cb1x = vb_px - rb * nvx
    cb1y = vb_py - rb * nvy
    av_x = 0.5 * (ca1x + cb1x)
    av_y = 0.5 * (ca1y + cb1y)

    use_vv = vertex_case
    count = _w(use_vv, 1, clip_count)
    nmx = _w(use_vv, nvx, nmx)
    nmy = _w(use_vv, nvy, nmy)
    a0x = _w(use_vv, av_x, pt0x)
    a0y = _w(use_vv, av_y, pt0y)
    a1x = _w(use_vv, 0.0, pt1x)
    a1y = _w(use_vv, 0.0, pt1y)
    s0 = _w(use_vv, separation, sp0)
    s1 = _w(use_vv, 0.0, sp1)
    id0 = _w(use_vv, _make_id(ia, ib), id0)
    id1 = _w(use_vv, 0, id1)

    a0x = a0x + ox
    a0y = a0y + oy
    a1x = a1x + ox
    a1y = a1y + oy
    wa0x = qac * a0x - qas * a0y
    wa0y = qas * a0x + qac * a0y
    wa1x = qac * a1x - qas * a1y
    wa1y = qas * a1x + qac * a1y
    wnx = qac * nmx - qas * nmy
    wny = qas * nmx + qac * nmy
    dpx = p_a[:, 0] - p_b[:, 0]
    dpy = p_a[:, 1] - p_b[:, 1]

    live = in_range & ~beyond
    count = _w(live, count, 0)
    wnx = _w(live, wnx, 0.0)
    wny = _w(live, wny, 0.0)
    wa0x = _w(live, wa0x, 0.0)
    wa0y = _w(live, wa0y, 0.0)
    wa1x = _w(live, wa1x, 0.0)
    wa1y = _w(live, wa1y, 0.0)
    s0 = _w(live, s0, 0.0)
    s1 = _w(live, s1, 0.0)
    id0 = _w(live, id0, 0)
    id1 = _w(live, id1, 0)
    dpx = _w(live, dpx, 0.0)
    dpy = _w(live, dpy, 0.0)
    pax = _w(live, p_a[:, 0], 0.0)
    pay = _w(live, p_a[:, 1], 0.0)

    def two(x0, y0, x1, y1):
        return torch.stack([torch.stack([x0, y0], dim=-1),
                            torch.stack([x1, y1], dim=-1)], dim=1)

    return Manifold(
        normal=torch.stack([wnx, wny], dim=-1),
        point_count=count.to(torch.int32),
        anchor_a=two(wa0x, wa0y, wa1x, wa1y),
        anchor_b=two(wa0x + dpx, wa0y + dpy, wa1x + dpx, wa1y + dpy),
        point=two(wa0x + pax, wa0y + pay, wa1x + pax, wa1y + pay),
        separation=torch.stack([s0, s1], dim=-1),
        ids=torch.stack([id0, id1], dim=-1).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# chain segment family (one-sided), ref: src/Manifold.cs:570-915
# ---------------------------------------------------------------------------


def collide_chain_segment_circle(p1, p2, ghost1, ghost2, p_a, q_a,
                                 center_b, radius_b, p_b, q_b) -> Manifold:
    """ref: src/Manifold.cs:570-618."""
    xp, xq = m.inv_mul_transforms(p_a, q_a, p_b, q_b)
    pb = m.transform_point(xp, xq, center_b)
    e = p2 - p1
    front = m.dot(m.right_perp(e), pb - p1) >= 0.0
    u = m.dot(e, p2 - pb)
    v = m.dot(e, pb - p1)
    # region gating with the ghost vertices
    u_prev = m.dot(p1 - ghost1, pb - p1)
    v_next = m.dot(ghost2 - p2, pb - p2)
    reject = (~front | ((v <= 0.0) & (u_prev <= 0.0))
              | ((v > 0.0) & (u <= 0.0) & (v_next > 0.0)))
    ee = m.dot(e, e)
    pa_mid = _wv(ee > 0.0, (u[:, None] * p1 + v[:, None] * p2)
                 / _w(ee > 0.0, ee, 1.0)[:, None], p1)
    pa = _wv(v <= 0.0, p1, _wv(u <= 0.0, p2, pa_mid))
    normal, dist = m.get_length_and_normalize(pb - pa)
    separation = dist - radius_b
    c_b = m.mul_add(pb, -radius_b, normal)
    return _one_point(normal, 0.5 * (pa + c_b), separation, 0, p_a, q_a, p_b,
                      ~reject & (separation <= SPECULATIVE_DISTANCE))


class _Local(NamedTuple):
    """A manifold in A's local frame, before _manifold finalizes it."""

    normal: torch.Tensor   # (P, 2)
    count: torch.Tensor    # (P,)
    anchor: torch.Tensor   # (P, 2, 2)
    sep: torch.Tensor      # (P, 2)
    ids: torch.Tensor      # (P, 2)


def _lsel(c, a: _Local, b: _Local) -> _Local:
    return _Local(*[torch.where(c.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
                    for x, y in zip(a, b)])


def _lempty(like) -> _Local:
    P, dev = like.shape[0], like.device
    z = torch.zeros((P, 2), dtype=torch.float32, device=dev)
    zi = torch.zeros(P, dtype=torch.int64, device=dev)
    return _Local(z, zi, torch.zeros((P, 2, 2), device=dev), z,
                  torch.zeros((P, 2), dtype=torch.int64, device=dev))


def _clip_segments(a1, a2, b1, b2, normal, ra, rb, id1, id2) -> _Local:
    """ref: src/Manifold.cs:625-658; in A's local frame."""
    tangent = m.left_perp(normal)
    upper1 = m.dot(a2 - a1, tangent)
    upper2 = m.dot(b1 - a1, tangent)
    lower2 = m.dot(b2 - a1, tangent)
    nonoverlap = (upper2 < 0.0) | (upper1 < lower2)
    big = upper2 - lower2 > FLT_EPSILON
    v_lower = _wv((lower2 < 0.0) & big, m.lerp(
        b2, b1, _safe_div(0.0 - lower2, upper2 - lower2)), b2)
    v_upper = _wv((upper2 > upper1) & big, m.lerp(
        b2, b1, _safe_div(upper1 - lower2, upper2 - lower2)), b1)
    sep_lower = m.dot(v_lower - a1, normal)
    sep_upper = m.dot(v_upper - a1, normal)
    v_lower = m.mul_add(v_lower, 0.5 * (ra - rb - sep_lower), normal)
    v_upper = m.mul_add(v_upper, 0.5 * (ra - rb - sep_upper), normal)
    radius = ra + rb
    return _Local(normal, _w(nonoverlap, 0, 2),
                  torch.stack([v_lower, v_upper], dim=1),
                  torch.stack([sep_lower - radius, sep_upper - radius],
                              dim=1),
                  torch.stack([id1, id2], dim=1))


def collide_chain_segment_polygon(p1, p2, ghost1, ghost2, p_a, q_a,
                                  vb, nb, cb, rb, p_b, q_b, active=None,
                                  stats=None) -> Manifold:
    """One-sided chain segment against a rounded polygon or capsule
    (ref: src/Manifold.cs:681-915); vb / nb (P, V, 2). `active` and
    `stats` go to its GJK call (distance.shape_distance)."""
    P, V = vb.shape[0], vb.shape[1]
    dev = vb.device
    lane = torch.arange(V, device=dev)
    cb = cb.long()
    valid_v = lane[None, :] < cb[:, None]
    xp, xq = m.inv_mul_transforms(p_a, q_a, p_b, q_b)
    lvb = m.rot_vec(xq[:, None, :], vb) + xp[:, None, :]
    lnb = m.rot_vec(xq[:, None, :], nb)
    centroid_b = (torch.where(valid_v[..., None], lvb, 0.0).sum(dim=1)
                  / torch.clamp(cb, min=1).float()[:, None])

    edge1 = m.normalize(p2 - p1)
    convex_tol = 0.01
    edge0 = m.normalize(p1 - ghost1)
    edge2 = m.normalize(ghost2 - p2)
    normal0 = m.right_perp(edge0)
    normal2 = m.right_perp(edge2)
    convex1 = m.cross(edge0, edge1) >= convex_tol
    convex2 = m.cross(edge1, edge2) >= convex_tol
    normal1 = m.right_perp(edge1)

    behind1 = m.dot(normal1, centroid_b - p1) < 0.0
    behind0 = _w(convex1, m.dot(normal0, centroid_b - p1) < 0.0, True)
    behind2 = _w(convex2, m.dot(normal2, centroid_b - p2) < 0.0, True)
    fully_behind = behind1 & behind0 & behind2

    # GJK from the segment's proxy to the polygon (ref: :713-721)
    seg_proxy = p1[:, None, :].repeat(1, 8, 1)
    seg_proxy[:, 1] = p2
    zero = torch.zeros_like(p1)
    ident = torch.zeros_like(p1)
    ident[:, 0] = 1.0
    d = shape_distance(seg_proxy, torch.full_like(cb, 2), 0.0, lvb, cb, 0.0,
                       zero, ident, zero, ident, active=active, stats=stats)
    out_of_range = d.distance > rb + SPECULATIVE_DISTANCE
    cia = d.cache_index_a.long()
    cib = d.cache_index_b.long()

    n0 = _wv(convex1, normal0, normal1)
    n2 = _wv(convex2, normal2, normal1)

    def classify(nrm):
        """0 skip, 1 admit, 2 snap (ref: :673-679); nrm (P, 2) or
        (P, V, 2)."""
        x = (lambda t: t[:, None]) if nrm.dim() == 3 else (lambda t: t)
        sin_tol = 0.01
        lower = m.dot(nrm, x(edge1)) <= 0.0
        t_lower = _w(x(convex1), _w(m.cross(nrm, x(normal0)) > sin_tol, 0, 1),
                     2)
        t_upper = _w(x(convex2), _w(m.cross(x(normal2), nrm) > sin_tol, 0, 1),
                     2)
        return _w(lower, t_lower, t_upper)

    def at(x, idx):
        return x[torch.arange(P, device=dev), idx]

    def one_point(normal, anchor, sep, pid) -> _Local:
        zf = torch.zeros_like(sep)
        return _Local(normal, torch.ones_like(pid), torch.stack(
            [anchor, torch.zeros_like(anchor)], dim=1),
            torch.stack([sep, zf], dim=1),
            torch.stack([pid, torch.zeros_like(pid)], dim=1))

    def with_normal(mf, normal):
        return mf._replace(normal=normal)

    empty = _lempty(p1)

    # the separated path, from the GJK cache
    sep_path = ~behind1 & (d.distance > 0.1 * LINEAR_SLOP)
    nrm_vv = m.normalize(d.point_b - d.point_a)
    type_vv = classify(nrm_vv)
    mf_admit_vv = one_point(nrm_vv, d.point_a, d.distance - rb,
                            _make_id(cia[:, 0], cib[:, 0]))

    ia1, ia2 = cia[:, 0], cia[:, 1]
    ib1, ib2 = cib[:, 0], cib[:, 1]
    same_a = ia1 == ia2

    # polygon face reference (A's vertices equal: B has the face)
    nrm_ba = d.point_a - d.point_b
    ibf = _w(m.dot(nrm_ba, at(lnb, ib1)) > m.dot(nrm_ba, at(lnb, ib2)),
             ib1, ib2)
    nrm_bf = at(lnb, ibf)
    type_bf = classify(-nrm_bf)
    ibf2 = _w(ibf < cb - 1, ibf + 1, 0)
    bf1 = at(lvb, ibf)
    bf2 = at(lvb, ibf2)
    smooth_reject_b = _w(
        m.dot(nrm_bf, p1 - bf1) < m.dot(nrm_bf, p2 - bf1),
        m.dot(n0, nrm_bf) < m.dot(normal1, nrm_bf),
        m.dot(n2, nrm_bf) < m.dot(normal1, nrm_bf))
    mf_face_b = with_normal(_clip_segments(
        bf1, bf2, p1, p2, nrm_bf, rb, 0.0, _make_id(ibf, 1),
        _make_id(ibf2, 0)), -nrm_bf)

    # the incident vertex when the segment's face is the reference
    inc_idx_2 = _w(m.dot(normal1, at(lvb, ib1) - p1)
                   < m.dot(normal1, at(lvb, ib2) - p2), ib1, ib2)

    # the behind / deep path
    svals = torch.where(valid_v, m.dot(normal1[:, None], lvb - p1[:, None]),
                        float("inf"))
    edge_sep = svals.min(dim=1).values
    inc_idx_deep = torch.argmin(svals, dim=1)
    s0 = torch.where(valid_v, m.dot(normal0[:, None], lvb - p1[:, None]),
                     float("inf")).min(dim=1).values
    use0 = convex1 & (s0 > edge_sep)
    edge_sep2 = _w(use0, s0, edge_sep)
    s2 = torch.where(valid_v, m.dot(normal2[:, None], lvb - p2[:, None]),
                     float("inf")).min(dim=1).values
    use2 = convex2 & (s2 > edge_sep2)
    edge_sep_f = _w(use2, s2, edge_sep2)
    ghost_best = use0 | use2

    # the polygon's reference faces that smoothness admits (ref: :828-838)
    admit = (classify(-lnb) == 1) & valid_v
    poly_seps = torch.minimum(m.dot(lnb, p2[:, None] - lvb),
                              m.dot(lnb, p1[:, None] - lvb))
    poly_seps = torch.where(admit, poly_seps, float("-inf"))
    poly_sep = poly_seps.max(dim=1).values
    ref_idx = torch.argmax(poly_seps, dim=1)
    use_poly_face = poly_sep > edge_sep_f

    raf1 = at(lvb, ref_idx)
    ra2_idx = _w(ref_idx < cb - 1, ref_idx + 1, 0)
    raf2 = at(lvb, ra2_idx)
    nrf = at(lnb, ref_idx)
    smooth_reject_deep = _w(
        m.dot(nrf, p1 - raf1) < m.dot(nrf, p2 - raf1),
        m.dot(n0, nrf) < m.dot(normal1, nrf),
        m.dot(n2, nrf) < m.dot(normal1, nrf))
    mf_face_deep = with_normal(_clip_segments(
        raf1, raf2, p1, p2, nrf, rb, 0.0, _make_id(ref_idx, 1),
        _make_id(ra2_idx, 0)), -nrf)

    def seg_ref_clip(inc_index, inc_normal=None):
        """The segment as the reference face, clipped against B's incident
        edge around inc_index (or the edge inc_normal names)."""
        if inc_normal is None:
            prev = _w(inc_index > 0, inc_index - 1, cb - 1)
            ib1c = _w(m.dot(normal1, at(lnb, prev))
                      < m.dot(normal1, at(lnb, inc_index)), prev, inc_index)
        else:
            ib1c = inc_normal
        ib2c = _w(ib1c < cb - 1, ib1c + 1, 0)
        # +normal1: upstream Box2D v3 semantics, as the reference keeps
        return _clip_segments(p1, p2, at(lvb, ib1c), at(lvb, ib2c), normal1,
                              0.0, rb, _make_id(0, ib2c), _make_id(1, ib1c))

    # the separated path's selections, by the GJK cache's count
    mf_c1 = _lsel(type_vv == 1, mf_admit_vv,
                  _lsel(type_vv == 0, empty, seg_ref_clip(cib[:, 0])))
    mf_c2a = _lsel((type_bf == 1) & ~smooth_reject_b, mf_face_b,
                   _lsel((type_bf == 0) | ((type_bf == 1) & smooth_reject_b),
                         empty, seg_ref_clip(None, ibf)))
    mf_c2b = seg_ref_clip(inc_idx_2)
    mf_sep = _lsel(d.cache_count == 1, mf_c1, _lsel(same_a, mf_c2a, mf_c2b))

    # the deep path's selections
    mf_deep = _lsel(use_poly_face,
                    _lsel(smooth_reject_deep, empty, mf_face_deep),
                    _lsel(ghost_best, empty, seg_ref_clip(inc_idx_deep)))
    mf = _lsel(sep_path, mf_sep, mf_deep)
    return _manifold(mf.normal, mf.count, mf.anchor, mf.sep, mf.ids, p_a,
                     q_a, p_b, ~fully_behind & ~out_of_range)
