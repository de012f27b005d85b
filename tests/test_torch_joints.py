"""The joint modules of the port against the JAX package, module by module.

Two scenes: `joint_farm(2)` (revolute with motor, revolute with limit,
prismatic with limit and motor, distance spring; capsules and circles) and
the all-types scene of tests/test_pallas_solver.py (weld, wheel, motor,
mouse, distance spring with limits and motor; boxes and circles). The same
state goes through the JAX function and its counterpart in the port.
Discrete outputs (pair lanes, colors, ids, counts, labels, event ids) must
match exactly; floats to 1e-6 unless a test says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import broadphase as jbp
from box2d_tpu import geometry as jgeo
from box2d_tpu import manifold as jmf
from box2d_tpu import math2d as jm
from box2d_tpu import scenes as jscenes
from box2d_tpu import types as jtypes_mod
from box2d_tpu.api import World as JWorld
from box2d_tpu.joints import joint_types_present
from box2d_tpu.joints import prepare_joints as jax_prepare_joints
from box2d_tpu.narrowphase import classes_for_shape_types
from box2d_tpu.solver import BodySolverState
from box2d_tpu.solver_pallas import pack_joint_rows as jax_pack_joint_rows
from box2d_tpu.world import _step_work as jax_step_work
from box2d_tpu_torch import broadphase as tbp
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import joints as tjoints
from box2d_tpu_torch import manifold as tmf
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as ttypes_mod
from box2d_tpu_torch.api import World as TWorld
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy
from box2d_tpu_torch.world import StepStats
from box2d_tpu_torch.world import _step_work as torch_step_work
from chip_smoke import all_types_scene
from test_torch_phases import check as phase_check
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

DT = 1 / 60
NSUB = 4
ATOL = 1e-6


def build_scene(name):
    """(JAX world, port world on the CPU) of one of the two scenes."""
    if name == "farm":
        return (jscenes.joint_farm(ragdolls=2),
                tscenes.joint_farm(ragdolls=2, device="cpu"))
    return (all_types_scene(JWorld, jtypes_mod, jgeo),
            all_types_scene(TWorld, ttypes_mod, tgeo, device="cpu"))


def scene_statics(jw):
    classes = classes_for_shape_types(
        s["geom"].type for s in jw.builder._shapes)
    jt = joint_types_present(j["_type"] for j in jw.builder._joints)
    return classes, jt


def check(name, a, b):
    phase_check(name, a, b, ATOL)


SCENES = ["farm", "all_types"]


@pytest.fixture(scope="module")
def worlds():
    """Per scene: the JAX builder state, the port's world at spawn, and the
    state leaves after 8 port steps (warm joint impulses)."""
    out = {}
    for name in SCENES:
        jw, tw = build_scene(name)
        jstate, jcap = jw.builder.build()
        tw.compile()
        spawn = state_to_numpy(tw.state)
        tw.run(8)
        warm = state_to_numpy(tw.state)
        classes, jt = scene_statics(jw)
        out[name] = dict(jw=jw, tw=tw, jstate=jstate, jcap=jcap,
                         spawn=spawn, warm=warm, classes=classes, jt=jt)
    return out


def _torch_until(w, leaves, until):
    tw = w["tw"]
    st = tw._step
    return torch_step_work(state_from_numpy(leaves, "cpu"), DT, tw.capacity,
                           st.classes, NSUB, True, StepStats(), until=until,
                           joint_types=st.joint_types)


@pytest.mark.parametrize("name", SCENES)
def test_builder_leaves_bit_identical(worlds, name):
    w = worlds[name]
    jl, tl = state_to_numpy(w["jstate"]), w["spawn"]
    assert sorted(jl) == sorted(tl)
    for key in jl:
        a, b = jl[key], tl[key]
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert dataclasses.asdict(w["tw"].capacity) == dataclasses.asdict(
        w["jcap"])
    assert w["tw"].capacity.has_joint_exclusions
    assert int((tl["joints.type"] >= 0).sum()) == len(w["jw"].builder._joints)
    assert w["tw"]._step.joint_types == w["jt"]


@pytest.mark.parametrize("name", SCENES)
def test_prepare_and_pack_match_jax(worlds, name):
    """prepare_joints and pack_joint_rows on the warm state, with the
    joint colors the port's own coloring gives."""
    w = worlds[name]
    leaves = w["warm"]
    assert np.abs(leaves["joints.impulse"]).max() > 0
    color = _torch_until(w, leaves, "colors")[1]
    assert int((color >= 0).sum()) > 0
    jstate = to_jax_state(w["jstate"], leaves)
    h = jnp.float32(DT) / NSUB
    inv_h = 1.0 / h
    b = jstate.bodies
    nb = b.center.shape[0]
    bs = BodySolverState(v=b.v, w=b.w, dp=jnp.zeros_like(b.center),
                         dq=jm.rot_identity((nb,)))

    @jax.jit
    def ref_fn(st, col):
        jc = jax_prepare_joints(st, bs, col, h, inv_h, w["jt"])
        return jc, jax_pack_joint_rows(st.joints, jc)

    ref_jc, ref_rows = ref_fn(jstate, jnp.asarray(color.numpy()))
    tstate = state_from_numpy(leaves, "cpu")
    hf = float(np.float32(DT) / np.float32(NSUB))
    jc = tjoints.prepare_joints(tstate, color, hf,
                                float(np.float32(1.0) / np.float32(hf)))
    check("prepare_joints", tuple(ref_jc), tuple(jc))
    rows = tjoints.pack_joint_rows(tstate.joints, jc)
    check("pack_joint_rows", ref_rows, rows)
    # the row tables are the JAX package's own
    from box2d_tpu import solver_pallas as sp
    assert (tjoints._JF, tjoints._JA, tjoints.NFJ) == (sp._JF, sp._JA,
                                                       sp.NFJ)


def test_layout_joint_rows_segments(worlds):
    """The joint region: live lanes sorted by (color, type), dead lanes
    last, offsets bounding each color, jpos the inverse of the sort."""
    w = worlds["all_types"]
    tw = w["tw"]
    args = _torch_until(w, w["warm"], "layout")
    jr = args[10]
    colors = _torch_until(w, w["warm"], "colors")[1].numpy()
    off = jr.offsets.numpy()
    live = jr.idx[0].numpy() >= 0
    n_live = int((colors >= 0).sum())
    assert off[0] == 0 and off[-1] == n_live == live.sum()
    assert live[:n_live].all() and not live[n_live:].any()
    assert len(off) == tw.capacity.max_colors + 1
    ty = w["warm"]["joints.type"]
    key = colors.astype(np.int64) * 8 + ty
    got = sorted(key[colors >= 0].tolist())
    lane_ty = jr.type.numpy()[:n_live]
    lane_col = np.searchsorted(off, np.arange(n_live), side="right") - 1
    assert (lane_col * 8 + lane_ty).tolist() == got


# ---------------------------------------------------------------------------
# manifold classes
# ---------------------------------------------------------------------------

def _poses(rng, n, spread):
    p_a = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    p_b = (p_a + rng.uniform(-spread, spread, (n, 2))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (2, n))
    q = lambda a: np.stack([np.cos(a), np.sin(a)], 1).astype(np.float32)
    return p_a, q(ang[0]), p_b, q(ang[1])


def _capsules(rng, n):
    c = rng.uniform(-0.2, 0.2, (n, 2))
    d = rng.uniform(-0.5, 0.5, (n, 2))
    d = d + np.sign(d) * 0.05
    return ((c - d).astype(np.float32), (c + d).astype(np.float32),
            rng.uniform(0.05, 0.3, n).astype(np.float32))


def _manifold_case(kind, n=512, seed=11):
    rng = np.random.default_rng(seed)
    p_a, q_a, p_b, q_b = _poses(rng, n, 1.2)
    rad = lambda: rng.uniform(0.05, 0.4, n).astype(np.float32)
    cen = lambda: rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    if kind == "circles":
        args = (cen(), rad(), p_a, q_a, cen(), rad(), p_b, q_b)
        return jmf.collide_circles, tmf.collide_circles, args
    if kind == "capsule_circle":
        a1, a2, ra = _capsules(rng, n)
        args = (a1, a2, ra, p_a, q_a, cen(), rad(), p_b, q_b)
        return jmf.collide_capsule_circle, tmf.collide_capsule_circle, args
    if kind == "capsules":
        a1, a2, ra = _capsules(rng, n)
        b1, b2, rb = _capsules(rng, n)
        # a share of exactly parallel, overlapping pairs (two-point case)
        par = np.arange(n) % 3 == 0
        q_b = np.where(par[:, None], q_a, q_b)
        b1 = np.where(par[:, None], a1, b1)
        b2 = np.where(par[:, None], a2, b2)
        off = rng.uniform(0.1, 0.5, n).astype(np.float32)
        p_b = np.where(par[:, None], p_a + np.stack(
            [-q_a[:, 1], q_a[:, 0]], 1) * off[:, None], p_b)
        args = (a1, a2, ra, p_a, q_a, b1, b2, rb,
                p_b.astype(np.float32), q_b.astype(np.float32))
        return jmf.collide_capsules, tmf.collide_capsules, args
    # polygon vs circle: boxes and hexagons of random size
    verts = np.zeros((n, 8, 2), np.float32)
    normals = np.zeros((n, 8, 2), np.float32)
    count = np.zeros(n, np.int32)
    for i in range(n):
        if i % 2:
            geom = jgeo.box(rng.uniform(0.2, 0.6), rng.uniform(0.2, 0.6))
        else:
            r = rng.uniform(0.3, 0.6)
            geom = jgeo.polygon([(r * np.cos(a), r * np.sin(a))
                                 for a in np.arange(6) * np.pi / 3])
        verts[i], normals[i], count[i] = geom.verts, geom.normals, geom.count
    ra = np.where(np.arange(n) % 4 == 0, 0.05, 0.0).astype(np.float32)
    args = (verts, normals, count, ra, p_a, q_a, cen(), rad(), p_b, q_b)
    return jmf.collide_polygon_circle, tmf.collide_polygon_circle, args


@pytest.mark.parametrize("kind", ["circles", "capsule_circle",
                                  "poly_circle", "capsules"])
def test_manifold_class_matches_jax(kind):
    jfn, tfn, args = _manifold_case(kind)
    ref = jax.jit(jax.vmap(jfn))(*[jnp.asarray(a) for a in args])
    out = tfn(*[torch.from_numpy(a) for a in args])
    counts = np.asarray(ref.point_count)
    np.testing.assert_array_equal(out.point_count.numpy(), counts)
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(ref.ids))
    # a one-point normal is a difference of two nearby points divided by
    # its length: where they are under 5 cm apart the rounding of the
    # inputs is amplified past 1e-6 (the two packages fuse differently), so
    # the floats of those few lanes are held to 1e-4 instead
    ra = args[{"circles": 1, "poly_circle": 3}.get(kind, 2)]
    gap = np.asarray(ref.separation)[:, 0] + ra + args[-3]
    close = (counts == 1) & (gap < 0.05)
    assert close.sum() < 0.2 * len(counts)
    assert ((counts > 0) & ~close).sum() > 50 and (counts == 0).sum() > 20
    if kind == "capsules":
        assert (counts == 2).sum() > 50 and (counts == 1).sum() > 30
    for f, a, b in zip(ref._fields, ref, out):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b[~close], a[~close], atol=ATOL,
                                       rtol=0, err_msg=f)
            np.testing.assert_allclose(b[close], a[close], atol=1e-4,
                                       rtol=0, err_msg=f)


# ---------------------------------------------------------------------------
# joint exclusions in the broadphase
# ---------------------------------------------------------------------------

def test_joint_exclusions_full_rebuild(worlds):
    """find_pairs on the jointed farm: the admitted pair set and its lane
    order equal the JAX result, and the exclusion really removes pairs."""
    w = worlds["farm"]
    jstate = to_jax_state(w["jstate"], w["spawn"])
    cap = w["jcap"]
    aabbs = jbp.compute_shape_aabbs(jstate, cap.max_verts)
    ref = jax.jit(lambda st, a: jbp.find_pairs(st, cap, a))(jstate, aabbs)
    tstate = state_from_numpy(w["spawn"], "cpu")
    ta = torch.from_numpy(np.array(aabbs))
    out = tbp.find_pairs(tstate, w["tw"].capacity, ta)
    check("find_pairs", ref, out)
    loose = dataclasses.replace(w["tw"].capacity, has_joint_exclusions=False)
    n_all = int(tbp.find_pairs(tstate, loose, ta).valid.sum())
    assert n_all > int(out.valid.sum())


def test_joint_exclusions_repair_tier(worlds):
    """A ball pushed onto its own torso and a neighbour's arm escapes its
    fat AABB: the repair tier must admit the pair with the other ragdoll's
    body and refuse the pair with its own jointed torso."""
    w = worlds["farm"]
    leaves = {k: v.copy() for k, v in w["warm"].items()}
    # ragdoll 0: bodies 0 anchor, 1 torso, 2 arm, 3 leg, 4 ball; ragdoll 1
    # starts at body 5
    leaves["bodies.center"][4] = leaves["bodies.center"][1] + (0.2, 0.0)
    leaves["bodies.center"][9] = leaves["bodies.center"][2] + (0.3, 0.1)
    jstate = to_jax_state(w["jstate"], leaves)
    ref = jax.jit(lambda st: jax_step_work(
        st, jnp.float32(DT), w["jcap"], w["classes"], NSUB, w["jt"], (),
        True, None, 0, until="pairs"))(jstate)
    out = _torch_until(w, leaves, "pairs")
    kind = _torch_until(w, leaves, "tail")[-1][4]
    assert int(kind) == 1
    check("pairs", ref, out)
    valid = out[0].valid.numpy()
    sa = out[0].shape_a.numpy()[valid]
    sb = out[0].shape_b.numpy()[valid]
    body = leaves["shapes.body"]
    pairs = {tuple(sorted((int(body[a]), int(body[b]))))
             for a, b in zip(sa, sb)}
    assert (1, 4) not in pairs          # jointed: excluded
    assert (2, 9) in pairs              # another ragdoll's ball: admitted


# ---------------------------------------------------------------------------
# coloring, joint events and the sleep pass with joint edges
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def farm_step(worlds):
    """joint_farm(2), warm, with the force threshold of joints 0, 2 and 5
    and the torque threshold of joint 6 at zero, so exactly those raise a
    joint event; and the island labels marked dirty so that the label pass
    runs over the joint edges."""
    w = worlds["farm"]
    leaves = {k: v.copy() for k, v in w["warm"].items()}
    leaves["joints.force_threshold"][[0, 2, 5]] = 0.0
    leaves["joints.torque_threshold"][6] = 0.0
    leaves["bodies.island_dirty"] = np.asarray(True)
    nb = leaves["bodies.island_label"].shape[0]
    leaves["bodies.island_label"] = np.arange(nb, dtype=np.int32)
    leaves["bodies.island_fresh"] = np.arange(nb, dtype=np.int32)
    jstate = to_jax_state(w["jstate"], leaves)
    fns = {u: jax.jit(lambda st, u=u: jax_step_work(
        st, jnp.float32(DT), w["jcap"], w["classes"], NSUB, w["jt"], (),
        True, None, 0, until=u)) for u in ("colors", "sleep")}
    return w, leaves, jstate, fns


def test_joint_colors_match_jax(farm_step):
    w, leaves, jstate, fns = farm_step
    ref = fns["colors"](jstate)
    out = _torch_until(w, leaves, "colors")
    check("colors", ref, out)
    jcol = out[1].numpy()
    assert (jcol >= 0).sum() == 8
    # joints sharing a dynamic body never share a color
    ja, jb = leaves["joints.body_a"], leaves["joints.body_b"]
    dyn = leaves["bodies.type"] == 2
    for i in range(8):
        for k in range(i + 1, 8):
            shared = {ja[i], jb[i]} & {ja[k], jb[k]}
            if any(dyn[s] for s in shared):
                assert jcol[i] != jcol[k]


def test_joint_events_and_sleep_match_jax(farm_step):
    """until="sleep" returns the awake flags, the island labels and the
    events: the joint events hold exactly the joints whose threshold was
    zeroed, in lane order, and each ragdoll's four dynamic bodies share one
    island label through their joint edges."""
    w, leaves, jstate, fns = farm_step
    ref = fns["sleep"](jstate)
    out = _torch_until(w, leaves, "sleep")
    check("awake", ref[0], out[0])
    check("labels", ref[1], out[1])
    ev_ref, ev = ref[2], out[2]
    assert int(ev.joint_force_count) == 4
    assert ev.joint_force[:4].tolist() == [0, 2, 5, 6]
    check("joint_force", ev_ref.joint_force, ev.joint_force)
    check("joint_force_count", ev_ref.joint_force_count,
          ev.joint_force_count)
    labels = out[1].numpy()
    assert labels[1:5].tolist() == [1, 1, 1, 1]
    assert labels[6:10].tolist() == [6, 6, 6, 6]
