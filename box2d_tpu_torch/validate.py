"""State-invariant validation: the B2_VALIDATE analog.

Port of box2d_tpu/validate.py (ref: src/World.cs:457-753
ValidateConnectivity / ValidateSolverSets / ValidateContacts). The state
is read to the host once (state.state_to_numpy) and swept for the same
invariants, with the same messages:

- entity cross-references stay in range and point at live lanes;
- mass data is consistent with body type;
- everything is finite and rotations are unit;
- sleeping dynamic bodies hold zero velocity;
- no two same-color live constraints (touching contacts + enabled joints)
  share a dynamic body, the overflow color excepted
  (ref: src/ConstraintGraph.cs per-color body bitsets);
- island labels respect the min-label property (label <= own id);
- the runtime free lists only hold disabled lanes.

`validate_world` returns a list of violation strings (empty == valid).
"""

from __future__ import annotations

import numpy as np

from .state import state_to_numpy


def _check(out, cond, msg):
    if not cond:
        out.append(msg)


def validate_world(world) -> list[str]:
    """Validate a compiled World's state. Returns violations (empty = ok)."""
    s = state_to_numpy(world.state)
    out: list[str] = []

    btype = s["bodies.type"]
    ben = s["bodies.enabled"]
    awake = s["bodies.awake"]
    nb = btype.shape[0]
    center = s["bodies.center"]
    rot = s["bodies.rot"]
    v = s["bodies.v"]
    w_ = s["bodies.w"]
    inv_m = s["bodies.inv_mass"]
    inv_i = s["bodies.inv_inertia"]
    mass = s["bodies.mass"]

    # --- finiteness + unit rotations --------------------------------------
    _check(out, np.all(np.isfinite(center[ben])), "non-finite body center")
    _check(out, np.all(np.isfinite(v[ben])), "non-finite body velocity")
    rn = np.hypot(rot[:, 0], rot[:, 1])
    bad_rot = ben & (np.abs(rn - 1.0) > 1e-3)
    _check(out, not np.any(bad_rot),
           f"non-unit rotation on bodies {np.nonzero(bad_rot)[0][:8]}")

    # --- mass data vs type (ref: src/Body.cs:255-353) ---------------------
    nondyn = ben & (btype != 2)
    _check(out, np.all(inv_m[nondyn] == 0.0),
           "static/kinematic body with nonzero inv_mass")
    _check(out, np.all(inv_i[nondyn] == 0.0),
           "static/kinematic body with nonzero inv_inertia")
    dyn = ben & (btype == 2)
    has_m = dyn & (inv_m > 0)
    _check(out, np.allclose(mass[has_m] * inv_m[has_m], 1.0, atol=1e-4),
           "dynamic body mass * inv_mass != 1")

    # --- sleeping bodies are frozen ---------------------------------------
    asleep = dyn & ~awake
    _check(out, np.all(v[asleep] == 0.0) and np.all(w_[asleep] == 0.0),
           "sleeping dynamic body with nonzero velocity")

    # --- island min-label property ----------------------------------------
    labels = s["bodies.island_label"]
    _check(out, np.all(labels[dyn] <= np.nonzero(dyn)[0])
           if np.any(dyn) else True,
           "island label above its body id (min-label violated)")

    # --- shapes reference valid bodies ------------------------------------
    sbody = s["shapes.body"]
    sen = s["shapes.enabled"]
    _check(out, np.all((sbody[sen] >= 0) & (sbody[sen] < nb)),
           "enabled shape references out-of-range body")
    cnt = s["shapes.count"]
    _check(out, np.all(cnt[sen] >= 1), "enabled shape with zero vertices")

    # --- joints -----------------------------------------------------------
    jen = s["joints.enabled"] & (s["joints.type"] >= 0)
    ja = s["joints.body_a"]
    jb = s["joints.body_b"]
    live_j = jen & (ja >= 0)
    _check(out, np.all((ja[live_j] < nb) & (jb[live_j] >= 0)
                       & (jb[live_j] < nb)),
           "enabled joint references out-of-range body")
    jcol = s["joints.color"]
    max_colors = world.capacity.max_colors
    _check(out, np.all(jcol[live_j] < max_colors),
           "joint color out of range")

    # --- contact store (lane-aligned cache) -------------------------------
    ka = s["contacts.key_a"]
    kb = s["contacts.key_b"]
    touching = s["contacts.touching"]
    S = s["shapes.type"].shape[0]
    live_c = ka >= 0
    _check(out, np.all(ka[live_c] <= kb[live_c]),
           "contact key not canonically ordered (key_a > key_b)")
    _check(out, np.all((kb[live_c] >= 0) & (kb[live_c] < S)),
           "contact key references out-of-range shape")
    _check(out, not np.any(touching & ~live_c),
           "touching contact with invalid key")
    ccol = s["contacts.color"]
    _check(out, np.all(ccol < max_colors), "contact color out of range")

    # --- constraint-graph coloring invariant; the overflow color (last)
    # is solved with mass-splitting relaxation and may conflict ------------
    ovf = max_colors - 1
    seen = {}

    def claim(color, body_lane, what):
        if btype[body_lane] != 2:
            return
        key = (int(color), int(body_lane))
        if key in seen:
            out.append(
                f"color conflict: {what} and {seen[key]} share body "
                f"{body_lane} in color {color}")
        else:
            seen[key] = what

    for i in np.nonzero(touching & (ccol >= 0) & (ccol != ovf))[0]:
        claim(ccol[i], sbody[ka[i]], f"contact[{i}]")
        claim(ccol[i], sbody[kb[i]], f"contact[{i}]")
    for i in np.nonzero(live_j & (jcol >= 0) & (jcol != ovf))[0]:
        claim(jcol[i], ja[i], f"joint[{i}]")
        claim(jcol[i], jb[i], f"joint[{i}]")

    # --- runtime free lists hold only disabled lanes ----------------------
    if getattr(world, "_free_bodies", None) is not None:
        _check(out, all(not ben[i] for i in world._free_bodies),
               "free body lane is enabled")
        _check(out, all(not sen[i] for i in world._free_shapes),
               "free shape lane is enabled")
        _check(out, all(not jen[i] for i in world._free_joints),
               "free joint lane is enabled")

    return out
