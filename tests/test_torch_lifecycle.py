"""Runtime create and destroy: the port's World against the JAX package's.

pyramid-4 (without its continuous pass, which halves the JAX compile)
is compiled in both packages with spare lanes and 8-vertex shape rows
(the JAX package's chain manifold needs them). One scripted sequence then
runs on both worlds: spawned bodies and shapes of three classes, a
runtime chain, revolute joints, destroyed shapes, joints and bodies (a
body's shapes and joints go with it), recycled lanes whose generation
bumps, body type flips and a filter change on generation-0 lanes. The
chain and the round shapes are gone before the last spawn, which sets
the step's classes to polygons alone: that keeps the one JAX step's
compile small. After each
call the handles, generations, free lists, shape records, joint types,
sensors, the filter tier and every state leaf (mass data, extents, dirty
flags included) must equal the JAX World's: exactly for integers and
flags, floats to 1e-5. A stale handle raises in both. Then one step of
each (the one JAX step compile of this file; positions to 1e-4, the
bound tests/test_torch_step.py holds the XLA path to).

The JAX World wakes a body through its handle-decoding wake_body with a
raw lane in set_body_type and _set_joint (box2d_tpu/api.py:893-895,
:1742), which raises on a recycled lane after the state was written
(ROADMAP.md §3); the port wakes the lane itself. That path is driven in
the port only, after the comparison. Last, the overflow tail's width
after a runtime joint is the JAX package's choice: the solver path fixed
at compile, with the new joint types.
"""

import dataclasses

import numpy as np
import pytest
import torch

from box2d_tpu import scenes as jscenes
from box2d_tpu import state as jstate
from box2d_tpu import types as jt
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as tt
from box2d_tpu_torch.contact_solver import tail_window
from box2d_tpu_torch.joints import solvable_joint_types
from box2d_tpu_torch.state import state_to_numpy
from box2d_tpu import geometry as jg
from test_torch_contact_solver import _jax_tail_width

torch.set_num_threads(1)

ATOL = 1e-5
SPARE = 8


def _pair():
    tw = tscenes.pyramid(rows=4, device="cpu")
    jw = jscenes.pyramid(rows=4)
    cap = tw.builder.default_capacity()
    cap = dataclasses.replace(cap, max_bodies=cap.max_bodies + SPARE,
                              max_shapes=cap.max_shapes + SPARE,
                              max_joints=cap.max_joints + 2,
                              max_verts=8)
    for w in (tw, jw):
        w.builder.def_.enable_continuous = False
    tw.compile(cap)
    jw.compile(jstate.Capacity(**dataclasses.asdict(cap)))
    return tw, jw


def same_world(tw, jw, name):
    for k in ("_body_gen", "_shape_gen", "_joint_gen"):
        np.testing.assert_array_equal(getattr(tw, k), getattr(jw, k),
                                      err_msg=f"{name}: {k}")
    for k in ("_free_bodies", "_free_shapes", "_free_joints", "_jtypes",
              "_sensors", "_classes"):
        assert getattr(tw, k) == getattr(jw, k), (name, k)
    assert tw.capacity.has_filters == jw.capacity.has_filters, name
    assert ({k: (r["body"], r["density"], r["geom"].type)
             for k, r in tw._shape_recs.items()}
            == {k: (r["body"], r["density"], r["geom"].type)
                for k, r in jw._shape_recs.items()}), name
    a = state_to_numpy(tw.state)
    b = state_to_numpy(jw.state)
    assert set(a) == set(b), name
    for k in a:
        if a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}: {k}")
        else:
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0,
                                       err_msg=f"{name}: {k}")


def _script(t, g):
    """(name, call) pairs of the lifecycle sequence; each call takes the
    world and the handles made so far (a dict it adds to)."""
    chain = t.ChainDef(points=[(22.0, 2.0), (19.0, 0.6), (16.5, 0.05),
                               (14.0, 0.05), (11.0, 0.4)])

    def spawn_body(w, h):
        h["b"] = w.create_body(t.BodyDef(type=2, position=(-3.0, 6.0),
                                         angle=0.3, angular_velocity=1.0))
        return h["b"]

    steps = [
        ("spawn body", spawn_body),
        ("spawn box", lambda w, h: h.setdefault("box", w.create_polygon_shape(
            h["b"], t.ShapeDef(density=2.0), g.box(0.3, 0.2)))),
        ("spawn circle", lambda w, h: h.setdefault(
            "circle", w.create_circle_shape(h["b"], t.ShapeDef(),
                                            (0.2, 0.0), 0.25))),
        ("spawn second body", lambda w, h: h.setdefault("c", w.create_body(
            t.BodyDef(type=2, position=(3.0, 6.0))))),
        ("spawn its capsule", lambda w, h: h.setdefault(
            "capsule", w.create_capsule_shape(h["c"], t.ShapeDef(),
                                              (-0.3, 0.0), (0.3, 0.0),
                                              0.2))),
        ("spawn static body", lambda w, h: h.setdefault("s", w.create_body(
            t.BodyDef(type=0, position=(0.0, 0.0))))),
        ("runtime chain", lambda w, h: w.create_chain(h["s"], chain)),
        ("spawn joint", lambda w, h: h.setdefault("j", w.create_joint(
            t.RevoluteJointDef(body_a=h["b"], body_b=h["c"],
                               local_anchor_a=(3.0, 0.0),
                               local_anchor_b=(-3.0, 0.0))))),
        ("destroy circle", lambda w, h: w.destroy_shape(h["circle"])),
        ("destroy joint", lambda w, h: w.destroy_joint(h["j"])),
        ("joint into a recycled lane", lambda w, h: h.setdefault(
            "j2", w.create_joint(t.RevoluteJointDef(
                body_a=0, body_b=h["c"], local_anchor_a=(3.0, 7.0),
                local_anchor_b=(0.0, 1.0))))),
        ("second joint on b", lambda w, h: w.create_joint(
            t.RevoluteJointDef(body_a=h["b"], body_b=h["c"],
                               local_anchor_a=(2.0, 0.0),
                               local_anchor_b=(-4.0, 0.0)))),
        ("destroy body b", lambda w, h: w.destroy_body(h["b"])),
        ("destroy the chain's body", lambda w, h: w.destroy_body(h["s"])),
        ("destroy the capsule", lambda w, h: w.destroy_shape(h["capsule"])),
        ("body into a recycled lane", lambda w, h: h.setdefault(
            "b2", w.create_body(t.BodyDef(type=2, position=(-1.0, 7.0))))),
        ("shape into a recycled lane", lambda w, h: w.create_polygon_shape(
            h["b2"], t.ShapeDef(), g.box(0.25, 0.25))),
        ("kinematic", lambda w, h: w.set_body_type(1, 1)),
        ("velocity", lambda w, h: w.set_linear_velocity(1, (0.5, 0.0))),
        ("static", lambda w, h: w.set_body_type(2, 0)),
        ("dynamic again", lambda w, h: w.set_body_type(2, 2)),
        ("filter", lambda w, h: w.set_filter(3, t.Filter(group_index=-1))),
        ("motor", lambda w, h: w.set_joint_motor_speed(h["j2"], 1.5)),
    ]
    return steps


def test_lifecycle_matches_jax():
    tw, jw = _pair()
    ht, hj = {}, {}
    same_world(tw, jw, "compile")
    for (name, ct), (_, cj) in zip(_script(tt, tg), _script(jt, jg)):
        rt, rj = ct(tw, ht), cj(jw, hj)
        assert rt == rj, (name, rt, rj)
        same_world(tw, jw, name)
    # the recycled lanes carry generation 1 in both packages
    assert ht["b2"] == ht["s"] | (1 << 20) and ht["b2"] == hj["b2"]
    assert ht["j2"] >> 20 == 1
    for w in (tw, jw):
        for getter in ("body_position", "body_linear_velocity",
                       "body_angle"):
            with pytest.raises(ValueError, match="stale"):
                getattr(w, getter)(ht["b"])
        with pytest.raises(ValueError, match="stale"):
            w.destroy_shape(ht["circle"])
        with pytest.raises(ValueError, match="stale"):
            w.set_joint_motor_speed(ht["j"], 1.0)
    assert tw.validate() == []
    # the second joint went with b; the next spawn left only polygons
    assert tw.counters()["joint_count"] == 1
    assert tw._classes == jw._classes == frozenset({"polys"})

    # one step of each
    tw.step()
    jw.step()
    a, b = state_to_numpy(tw.state), state_to_numpy(jw.state)
    np.testing.assert_allclose(a["bodies.center"], b["bodies.center"],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(a["bodies.awake"], b["bodies.awake"])
    assert int(a["profile.pair_count"]) == int(b["profile.pair_count"])

    # the port wakes a recycled lane where the JAX World raises
    b2 = ht["b2"]
    lane = b2 & ((1 << 20) - 1)
    tw.step()
    tw.set_body_type(b2, 1)
    tw.set_body_type(b2, 2)
    jn = tw.create_joint(tt.RevoluteJointDef(body_a=b2, body_b=ht["c"]))
    tw.set_joint_motor_speed(jn, 2.0)
    assert bool(tw.state.bodies.awake[lane])
    assert tw.body_is_awake(b2) and int(tw.state.bodies.type[lane]) == 2
    with pytest.raises(ValueError, match="stale or invalid body handle"):
        jw.set_body_type(b2, 1)


@pytest.mark.parametrize("scene", ["pyramid-8", "joint_farm-2"])
def test_tail_width_after_a_runtime_joint(scene):
    """A joint spawned after compile keeps the solver path fixed at
    compile (box2d_tpu/api.py:1527-1529). pyramid-8 compiles joint-free
    in mode 1; with a joint the JAX package takes the XLA path
    (box2d_tpu/world.py:383), which sweeps the whole tail as one window,
    where a choice made afresh from the new joint set would give the
    jointed tiled width. joint_farm compiles in mode 2 and keeps it."""
    if scene == "pyramid-8":
        w = tscenes.pyramid(rows=8, device="cpu")
    else:
        w = tscenes.joint_farm(2, device="cpu")
    cap = w.builder.default_capacity()
    w.compile(dataclasses.replace(cap, max_joints=cap.max_joints + 1))
    compiled = solvable_joint_types(w._jtypes)
    mode, _ = _jax_tail_width(w.capacity, compiled)
    w.create_joint(tt.WeldJointDef(body_a=1, body_b=2))
    now = solvable_joint_types(w._jtypes)
    assert now != compiled
    _, fresh = _jax_tail_width(w.capacity, now)
    # world.py:383: the kernel runs if mode and (no joints or mode >= 2)
    if mode == "1":
        ovf = tail_window(w.capacity, frozenset(), 0)
        assert w._step.tail_w == ovf != fresh
    else:
        assert w._step.tail_w == fresh
    assert w._step.mode == {"1": 1, "2": 2, "2 jointed": 2, "3": 3,
                            "xla": 0}[mode]
