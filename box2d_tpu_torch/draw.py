"""Debug-draw data extraction (ref: include/Types.cs:1007-1061 DebugDraw +
api/World.cs:116-280 WorldAPI.Draw).

Port of box2d_tpu/draw.py. `draw_data` reads the state to the host once
(state.state_to_numpy) and returns plain NumPy arrays a renderer can
consume; colors encode body state like the reference's default palette.
`render_matplotlib` draws them, importing matplotlib when it is called.
"""

from __future__ import annotations

import numpy as np

from . import geometry as g
from .state import KINEMATIC, STATIC, state_to_numpy


def _rot(q, v):
    """Rotate rows v by rotations q ((cos, sin) rows), in float32."""
    c, s = q[..., 0], q[..., 1]
    return np.stack([c * v[..., 0] - s * v[..., 1],
                     s * v[..., 0] + c * v[..., 1]], axis=-1)


def _hue(k):
    # golden-ratio hue walk: distinct colors for any index
    h = (0.618033988749895 * (k + 1)) % 1.0
    i = int(h * 6)
    f = h * 6 - i
    q, t_ = 0.35 + 0.65 * (1 - f), 0.35 + 0.65 * f
    rgb = [(1, t_, .35), (q, 1, .35), (.35, 1, t_),
           (.35, q, 1), (t_, .35, 1), (1, .35, q)][i % 6]
    return (*rgb, 1.0)


def draw_data(state, color_by: str = "state") -> dict:
    """Renderable primitives of the current state (box2d_tpu/draw.py:20).

    color_by: "state" (static/kinematic/dynamic/sleeping palette),
    "island" (per-island hues) or "graph_color" (the highest graph color
    of each body's touching contacts).

    Returns a dict with:
      polygons: list of (verts (k,2), color)
      circles:  list of ((cx, cy), radius, color)
      capsules: list of ((p1, p2), radius, color)
      segments: list of ((p1, p2), color)
      particles: (positions (n,2), colors (n,4)) or None
      joints: list of ((pa, pb), color)
    """
    s = state_to_numpy(state)
    rot = s["bodies.rot"]
    origin = s["bodies.center"] - _rot(rot, s["bodies.local_center"])
    verts = s["shapes.verts"]
    counts = s["shapes.count"]
    radius = s["shapes.radius"]
    stype = s["shapes.type"]
    body = s["shapes.body"]
    enabled = s["shapes.enabled"]
    btype = s["bodies.type"]
    awake = s["bodies.awake"]

    if color_by == "island":
        labels = s["bodies.island_label"]

        def body_color(bi):
            if btype[bi] == STATIC:
                return (0.5, 0.9, 0.5, 1.0)
            if not awake[bi]:
                return (0.6, 0.6, 0.6, 1.0)
            return _hue(int(labels[bi]))
    elif color_by == "graph_color":
        ka = s["contacts.key_a"]
        kb = s["contacts.key_b"]
        col = s["contacts.color"]
        body_gc = np.full(btype.shape[0], -1)
        for slot in np.where((ka >= 0) & s["contacts.touching"]
                             & (col >= 0))[0]:
            for sid in (int(ka[slot]), int(kb[slot])):
                bi = int(body[sid])
                body_gc[bi] = max(body_gc[bi], int(col[slot]))

        def body_color(bi):
            if btype[bi] == STATIC:
                return (0.5, 0.9, 0.5, 1.0)
            if body_gc[bi] < 0:
                return (0.6, 0.6, 0.6, 1.0)
            return _hue(int(body_gc[bi]))
    else:
        def body_color(bi):
            if btype[bi] == STATIC:
                return (0.5, 0.9, 0.5, 1.0)
            if btype[bi] == KINEMATIC:
                return (0.5, 0.5, 0.9, 1.0)
            if not awake[bi]:
                return (0.6, 0.6, 0.6, 1.0)
            return (0.9, 0.7, 0.7, 1.0)

    out = {"polygons": [], "circles": [], "capsules": [], "segments": [],
           "particles": None, "joints": []}
    for i in range(len(stype)):
        if not enabled[i]:
            continue
        bi = body[i]
        c, s_ = rot[bi]
        R = np.array([[c, -s_], [s_, c]], np.float32)
        w = verts[i, : counts[i]] @ R.T + origin[bi]
        col = body_color(bi)
        if stype[i] == g.CIRCLE:
            out["circles"].append((w[0], float(radius[i]), col))
        elif stype[i] == g.CAPSULE:
            out["capsules"].append(((w[0], w[1]), float(radius[i]), col))
        elif stype[i] in (g.SEGMENT, g.CHAIN_SEGMENT):
            out["segments"].append(((w[0], w[1]), col))
        else:
            out["polygons"].append((w, col))

    jtype = s["joints.type"]
    jen = s["joints.enabled"]
    for j in range(len(jtype)):
        if jtype[j] < 0 or not jen[j]:
            continue
        ba, bb = int(s["joints.body_a"][j]), int(s["joints.body_b"][j])
        pa = origin[ba] + _rot(rot[ba], s["joints.frame_a_p"][j])
        pb = origin[bb] + _rot(rot[bb], s["joints.frame_b_p"][j])
        out["joints"].append(((pa, pb), (0.9, 0.8, 0.3, 1.0)))

    if state.particles is not None:
        alive = s["particles.alive"]
        out["particles"] = (s["particles.pos"][alive],
                            s["particles.color"][alive])
    return out


def render_matplotlib(state, ax=None, xlim=None, ylim=None):
    """Optional matplotlib renderer over draw_data (for notebooks)."""
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 6))
    d = draw_data(state)
    for w, col in d["polygons"]:
        ax.add_patch(patches.Polygon(w, closed=True, facecolor=col,
                                     edgecolor="k", linewidth=0.5))
    for c, r, col in d["circles"]:
        ax.add_patch(patches.Circle(c, r, facecolor=col, edgecolor="k",
                                    linewidth=0.5))
    for (p1, p2), r, col in d["capsules"]:
        ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color=col, linewidth=r * 72)
    for (p1, p2), col in d["segments"]:
        ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color="k", linewidth=1.0)
    for (p1, p2), col in d["joints"]:
        ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color=col, linewidth=1.0)
    if d["particles"] is not None:
        pos, cols = d["particles"]
        ax.scatter(pos[:, 0], pos[:, 1], s=2, c=cols)
    ax.set_aspect("equal")
    if xlim:
        ax.set_xlim(*xlim)
    if ylim:
        ax.set_ylim(*ylim)
    return ax
