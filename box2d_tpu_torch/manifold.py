"""Contact manifolds for circles, capsules, segments and polygons.

Torch port of box2d_tpu/manifold.py: the `Manifold` record,
`collide_polygons_batched` (:419, ref: src/Manifold.cs:410-562) and the
four classes a scene of circles and capsules adds: `collide_circles`,
`collide_capsule_circle`, `collide_polygon_circle` and `collide_capsules`
(:100-275). The JAX functions take one pair and are vmapped; here every
function takes the pair axis first and is plain tensor code in the same
order of operations. The two chain classes come with the slice that needs
them (ROADMAP.md queue 10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math2d as m
from .constants import FLT_EPSILON, LINEAR_SLOP, SPECULATIVE_DISTANCE


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


def segment_distance(p1, q1, p2, q2):
    """Closest points between two segments (box2d_tpu/distance.py:36, ref:
    src/Distance.cs:20-72); returns (fraction1, fraction2, closest1,
    closest2, distance_squared)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    dd1 = m.dot(d1, d1)
    dd2 = m.dot(d2, d2)
    rd1 = m.dot(r, d1)
    rd2 = m.dot(r, d2)
    eps_sqr = float(torch.tensor(FLT_EPSILON * FLT_EPSILON,
                                 dtype=torch.float32))
    d12 = m.dot(d1, d2)
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
    c1 = m.mul_add(p1, f1, d1)
    c2 = m.mul_add(p2, f2, d2)
    e = c2 - c1
    return f1, f2, c1, c2, m.dot(e, e)


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

    def mk(a, b):
        return (a << 8) | (b & 0xFF)

    # two-point manifold
    n2 = _wv(use_a, normal_a, -normal_b)
    a2_0 = _wv(use_a, pt0_a, pt0_b)
    a2_1 = _wv(use_a, pt1_a, pt1_b)
    s2_0 = _w(use_a, spa, spb) - radius
    s2_1 = _w(use_a, sqa, sqb) - radius
    id2_1 = _w(use_a, mk(0, 1), mk(1, 0))

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
    id1_0 = mk(i1, i2)

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

    def mk(a, b):
        return (a << 8) | (b & 0xFF)

    id0 = _w(flip, mk(i21, i12), mk(i11, i22))
    id1 = _w(flip, mk(i22, i11), mk(i12, i21))
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
    id0 = _w(use_vv, mk(ia, ib), id0)
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
