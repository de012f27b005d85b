"""Host-side shape construction: hulls, polygon factories, mass properties.

NumPy-only copy of the parts of box2d_tpu/geometry.py the ported slices
use (the reference package cannot be imported without jax): the circle,
capsule, box and polygon factories, the hull and mass properties. The hull is the
pure-Python quickhull; the JAX package's optional native fast path is not
carried over.

Runs at scene-build time in NumPy (never inside jit). Produces the *unified
rounded-polygon* representation every shape compiles to:

    verts   (MAX_POLYGON_VERTICES, 2)  local vertices (padded)
    normals (MAX_POLYGON_VERTICES, 2)  outward edge normals (padded)
    count   int                        1=circle, 2=capsule/segment, 3..8=polygon
    radius  float                      external radius (0 for sharp shapes)

This unification is the TPU-first redesign of the reference's five polymorphic
shape records (ref: include/Collision.cs:65-755): a circle is a 1-vertex
rounded polygon, a capsule/segment is a 2-vertex one (the reference itself
converts capsules via Geometry.MakeCapsule, ref: src/Manifold.cs:8-17), so the
whole narrow phase becomes a few vectorized kernels over homogeneous arrays
instead of a 12-way virtual dispatch.

Behavioral parity references:
- quickhull:          ref src/Hull.cs:43-160
- polygon factories:  ref src/Geometry.cs:34-147
- mass properties:    ref include/Collision.cs:82-92 (circle), :205-224
                      (capsule), :431-486 (polygon)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .constants import FLT_EPSILON, LINEAR_SLOP, MAX_POLYGON_VERTICES

# Shape type tags (stable ABI for the device arrays)
CIRCLE = 0
CAPSULE = 1
SEGMENT = 2
POLYGON = 3
CHAIN_SEGMENT = 4


@dataclasses.dataclass
class ShapeGeom:
    """Unified host-side geometry for one shape."""

    type: int
    verts: np.ndarray  # (MAX_POLYGON_VERTICES, 2) f32, padded with last vertex
    normals: np.ndarray  # (MAX_POLYGON_VERTICES, 2) f32
    count: int
    radius: float
    centroid: np.ndarray  # (2,) f32
    ghost1: np.ndarray | None = None  # chain segments only
    ghost2: np.ndarray | None = None

    def __post_init__(self):
        self.verts = np.asarray(self.verts, np.float32)
        self.normals = np.asarray(self.normals, np.float32)
        self.centroid = np.asarray(self.centroid, np.float32)


def _pad(arr: np.ndarray, count: int) -> np.ndarray:
    """Pad vertex/normal arrays to MAX_POLYGON_VERTICES by repeating the last
    row; repeated rows keep masked lane math finite (no NaNs from zeros)."""
    out = np.zeros((MAX_POLYGON_VERTICES, 2), np.float32)
    out[:count] = arr[:count]
    out[count:] = arr[count - 1]
    return out


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def circle(center, radius: float) -> ShapeGeom:
    c = np.asarray(center, np.float32)
    v = np.tile(c, (MAX_POLYGON_VERTICES, 1))
    return ShapeGeom(CIRCLE, v, np.zeros_like(v), 1, float(radius), c)


def capsule(p1, p2, radius: float) -> ShapeGeom:
    """ref: src/Manifold.cs:8-17 MakeCapsule."""
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    d = p2 - p1
    ln = float(np.hypot(*d))
    assert ln * ln > FLT_EPSILON, "degenerate capsule"
    axis = d / ln
    n = np.array([axis[1], -axis[0]], np.float32)  # right perp
    verts = _pad(np.stack([p1, p2]), 2)
    normals = _pad(np.stack([n, -n]), 2)
    return ShapeGeom(CAPSULE, verts, normals, 2, float(radius), 0.5 * (p1 + p2))


def _polygon_centroid(vertices: np.ndarray) -> np.ndarray:
    """ref: src/Geometry.cs ComputePolygonCentroid."""
    origin = vertices[0]
    center = np.zeros(2, np.float64)
    area = 0.0
    for i in range(1, len(vertices) - 1):
        e1 = vertices[i] - origin
        e2 = vertices[i + 1] - origin
        a = 0.5 * float(e1[0] * e2[1] - e1[1] * e2[0])
        center += (a / 3.0) * (e1 + e2)
        area += a
    assert area > FLT_EPSILON, "degenerate polygon"
    return (origin + center / area).astype(np.float32)


def polygon(vertices: Sequence, radius: float = 0.0) -> ShapeGeom:
    """Make a convex polygon from hull points (CCW). ref: src/Geometry.cs:34-57.

    Points are run through compute_hull for validity, matching MakePolygon's
    requirement that data comes from ComputeHull.
    """
    pts = compute_hull(vertices)
    assert len(pts) >= 3, "polygon needs at least 3 hull points"
    n = len(pts)
    normals = np.zeros((n, 2), np.float32)
    for i in range(n):
        edge = pts[(i + 1) % n] - pts[i]
        assert float(edge @ edge) > FLT_EPSILON * FLT_EPSILON
        e = edge / np.hypot(*edge)
        normals[i] = (e[1], -e[0])  # CrossVS(edge, 1) = right perp
    return ShapeGeom(
        POLYGON, _pad(pts, n), _pad(normals, n), n, float(radius), _polygon_centroid(pts)
    )


def box(half_width: float, half_height: float, center=(0.0, 0.0), angle: float = 0.0,
        radius: float = 0.0) -> ShapeGeom:
    """MakeBox / MakeRoundedBox / MakeOffsetBox (ref: src/Geometry.cs:76-136)."""
    hw, hh = float(half_width), float(half_height)
    assert hw > 0 and hh > 0
    c, s = math.cos(angle), math.sin(angle)
    cx, cy = float(center[0]), float(center[1])

    def xf(x, y):
        return (c * x - s * y + cx, s * x + c * y + cy)

    def rot(x, y):
        return (c * x - s * y, s * x + c * y)

    verts = np.array([xf(-hw, -hh), xf(hw, -hh), xf(hw, hh), xf(-hw, hh)], np.float32)
    normals = np.array([rot(0, -1), rot(1, 0), rot(0, 1), rot(-1, 0)], np.float32)
    return ShapeGeom(
        POLYGON, _pad(verts, 4), _pad(normals, 4), 4, float(radius),
        np.array([cx, cy], np.float32),
    )


# ---------------------------------------------------------------------------
# convex hull (quickhull, ref: src/Hull.cs:43-160)
# ---------------------------------------------------------------------------

def compute_hull(points: Sequence) -> np.ndarray:
    """Compute a convex hull (CCW, welded, collinear-merged).

    Behavioral match of the reference quickhull (ref: src/Hull.cs:43-160):
    - points welded within 4 * linearSlop (ref tolSqr = 16 * slop^2 over
      SQUARED distance, Hull.cs:50)
    - collinear points within 2 * linearSlop of a hull edge are removed
    - at most MAX_POLYGON_VERTICES points kept
    """
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return pts.astype(np.float32)

    # weld close points (ref: Hull.cs:50 tolSqr = 16*slop^2 on SQUARED
    # distance => 4*slop on distance)
    tol = 4.0 * LINEAR_SLOP
    unique: list[np.ndarray] = []
    for p in pts:
        if all(np.hypot(*(p - q)) >= tol for q in unique):
            unique.append(p)
    pts = np.array(unique)
    if len(pts) < 3:
        return pts.astype(np.float32)

    def cross2(e, v):
        return e[..., 0] * v[..., 1] - e[..., 1] * v[..., 0]

    # quickhull recursion on points right of directed line p1->p2
    def recurse(p1, p2, candidates):
        if len(candidates) == 0:
            return []
        e = p2 - p1
        dists = cross2(e, candidates - p1)  # negative = right of the line
        right = candidates[dists < 0]
        if len(right) == 0:
            return []
        d_right = cross2(e, right - p1)
        best = right[np.argmin(d_right)]
        return recurse(p1, best, right) + [best] + recurse(best, p2, right)

    order = np.lexsort((pts[:, 1], pts[:, 0]))
    p_lo, p_hi = pts[order[0]], pts[order[-1]]
    hull = [p_lo] + recurse(p_lo, p_hi, pts) + [p_hi] + recurse(p_hi, p_lo, pts)
    # ensure CCW winding (positive signed area)
    area2 = sum(cross2(hull[i], hull[(i + 1) % len(hull)]) for i in range(len(hull)))
    if area2 < 0:
        hull = hull[::-1]

    # merge collinear (ref: Hull.cs searchable collinearity pass)
    tol2 = 2.0 * LINEAR_SLOP
    changed = True
    while changed and len(hull) > 3:
        changed = False
        for i in range(len(hull)):
            a = hull[i - 1]
            b = hull[i]
            c = hull[(i + 1) % len(hull)]
            e = c - a
            ln = np.hypot(*e)
            dev = e[0] * (b - a)[1] - e[1] * (b - a)[0]
            if ln < 1e-12 or abs(dev / ln) < tol2:
                hull.pop(i)
                changed = True
                break

    if len(hull) > MAX_POLYGON_VERTICES:
        # keep the most-area-preserving subset: greedily drop the vertex whose
        # removal loses the least area
        while len(hull) > MAX_POLYGON_VERTICES:
            losses = []
            for i in range(len(hull)):
                a, b, c = hull[i - 1], hull[i], hull[(i + 1) % len(hull)]
                ab, ac = b - a, c - a
                losses.append(abs(ab[0] * ac[1] - ab[1] * ac[0]) * 0.5)
            hull.pop(int(np.argmin(losses)))
    return np.array(hull, np.float32)


# ---------------------------------------------------------------------------
# mass properties
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MassData:
    mass: float
    center: np.ndarray  # (2,)
    rotational_inertia: float  # about center


def compute_mass(geom: ShapeGeom, density: float) -> MassData:
    """Mass properties in shape-local space.

    ref: include/Collision.cs:82-92 (circle), :205-224 (capsule),
    :431-486 (polygon). Segments/chain segments have no mass.
    """
    if geom.type == CIRCLE:
        rr = geom.radius * geom.radius
        mass = density * math.pi * rr
        return MassData(mass, geom.verts[0].copy(), mass * 0.5 * rr)

    if geom.type in (SEGMENT, CHAIN_SEGMENT):
        return MassData(0.0, geom.centroid.copy(), 0.0)

    if geom.type == CAPSULE or (geom.type == POLYGON and geom.count == 2):
        p1, p2 = geom.verts[0].astype(np.float64), geom.verts[1].astype(np.float64)
        radius = geom.radius
        rr = radius * radius
        ll = float((p2 - p1) @ (p2 - p1))
        ln = math.sqrt(ll)
        circle_mass = density * math.pi * rr
        # rectangle area = (2r) * length. The reference port drops the length
        # factor (ref: include/Collision.cs:212 `2 * radius * radius`); we
        # follow upstream Box2D v3's correct formula.
        box_mass = density * 2.0 * radius * ln
        mass = circle_mass + box_mass
        lc = 4.0 * radius / (3.0 * math.pi)
        h = 0.5 * ln
        circle_inertia = circle_mass * (0.5 * rr + h * h + 2.0 * h * lc)
        box_inertia = box_mass * (4.0 * rr + ll) / 12.0
        return MassData(
            mass, (0.5 * (p1 + p2)).astype(np.float32), circle_inertia + box_inertia
        )

    # polygon with count >= 3
    n = geom.count
    verts = geom.verts[:n].astype(np.float64)
    if geom.radius > 0:
        # approximate rounded polygon by pushing vertices out along the
        # corner bisector (ref: Collision.cs:446-455)
        sqrt2 = math.sqrt(2.0)
        pushed = verts.copy()
        for i in range(n):
            j = (i - 1) % n
            mid = geom.normals[j].astype(np.float64) + geom.normals[i].astype(np.float64)
            mid /= np.hypot(*mid)
            pushed[i] = verts[i] + sqrt2 * geom.radius * mid
        verts = pushed
    r = verts[0]
    center = np.zeros(2, np.float64)
    area = 0.0
    inertia = 0.0
    for i in range(1, n - 1):
        e1 = verts[i] - r
        e2 = verts[i + 1] - r
        d = float(e1[0] * e2[1] - e1[1] * e2[0])
        tri_area = 0.5 * d
        area += tri_area
        center += (tri_area / 3.0) * (e1 + e2)
        intx2 = e1[0] * e1[0] + e2[0] * e1[0] + e2[0] * e2[0]
        inty2 = e1[1] * e1[1] + e2[1] * e1[1] + e2[1] * e2[1]
        inertia += 0.25 / 3.0 * d * (intx2 + inty2)
    assert area > FLT_EPSILON
    center /= area
    return MassData(
        density * area,
        (r + center).astype(np.float32),
        density * inertia - density * area * float(center @ center),
    )
