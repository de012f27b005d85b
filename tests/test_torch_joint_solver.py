"""The joint sweep's plain-PyTorch twin against the Pallas tiled kernel,
and the jointed slice as a whole against the JAX step.

Twin vs kernel: the JAX step packs a warm jointed state
(`_step_work(..., use_pallas=2, until="layout")`) and runs the tiled kernel
with its joint windows in Pallas interpret mode (`until="kernel"`), as
tests/test_pallas_solver.py runs it. The JAX-packed contact and joint
columns are re-arranged into the port's layout (contacts as they are, the
joint lanes sorted by color and type) and go through `contact_solve` on CPU
tensors, which takes the twin. Bounds: atol 1e-5, rtol 1e-4 on bodies,
contact accumulators and joint accumulators. No loosening was needed: the
Pallas `_atan2` is a polynomial within 1e-7 rad of `torch.atan2`, and the
angles only enter through softness-scaled biases.

The hub scene (port_fixtures.hub_scene: 24 joints of three types on one
dynamic hub) overflows its joint colors: the overflow color's segment is
swept as kind-pure Jacobi windows, as the tiled kernel sweeps it. It is
warmed by the port alone, 2 steps (no JAX trajectory), and held to the
same bounds.

All three scenes are built at one capacity (CAP, the largest of their
own) and the JAX functions are traced with the union of their shape
classes and joint types, so that the JAX step compiles once for both
trajectories and the layout and the kernel functions once for the three
kernel cases. A class or joint type that a scene does not hold adds no
lane: both packages see the same state, and the port steps with its own
classes and types.

Whole slice: both scenes stepped 6 times from spawn through the port on the
CPU and through the JAX step on its XLA path (`use_pallas=0`); bounds are
those of tests/test_pallas_solver.py:178-185: centres 1e-4, velocities
2e-3, joint impulses 5e-3. The JAX step is traced without its continuous
pass, which is the identity while the CCD gate stays shut; the port steps
with its own (the farm's on) and the test asserts that its gate never
opened, on the same states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from box2d_tpu import geometry as jgeo
from box2d_tpu import types as jtypes_mod
from box2d_tpu.api import World as JWorld
from box2d_tpu.state import Capacity
from box2d_tpu.world import _step as jax_step
from box2d_tpu.world import _step_work as jax_step_work
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import types as ttypes_mod
from box2d_tpu_torch.api import World as TWorld
from box2d_tpu_torch.contact_solver import (NA, NF, contact_solve,
                                            window_table)
from box2d_tpu_torch.joints import NFJ, JointRows
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy
from box2d_tpu_torch.world import StepStats
from box2d_tpu_torch.world import _step_work as torch_step_work
from port_fixtures import hub_scene
from test_torch_joints import SCENES, build_scene, scene_statics
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

DT = 1 / 60
NSUB = 4
ATOL, RTOL = 1e-5, 1e-4
STEPS = 6
# the largest of the three scenes' own capacities (the hub's, with the
# others' max_verts)
CAP = Capacity(max_bodies=26, max_shapes=26, max_joints=24,
               max_contact_pairs=104, max_verts=4, big_shape_cap=16,
               fast_cap=26, has_filters=False)
# the union of the scenes' shape classes and joint types
CLASSES = frozenset({"circles", "capsules", "capsule_circle", "poly_circle",
                     "polys"})
JTYPES = frozenset({0, 1, 2, 3, 4, 5, 7})

_jax_step = jax.jit(lambda s: jax_step(
    s, jnp.float32(DT), CAP, CLASSES, NSUB, JTYPES, (), False, None, 0))
# the JAX tiled kernel's layout and its outputs, each compiled once; the
# layout's program holds no Pallas call, so the persistent compilation
# cache keeps it (a program with an interpreted kernel is never cached)
_jax_layout, _jax_kernel = (jax.jit(lambda s, u=u: jax_step_work(
    s, jnp.float32(DT), CAP, CLASSES, NSUB, JTYPES, (), True, None, 2,
    until=u)) for u in ("layout", "kernel"))


def _build(jw, tw):
    """The JAX state and capacity of `jw` at CAP, and `tw` compiled at it."""
    jstate, jcap = jw.builder.build(CAP)
    assert jcap == CAP
    tw.compile(jcap)
    classes, jt = scene_statics(jw)
    assert classes <= CLASSES and jt <= JTYPES
    return jstate, jcap


@pytest.fixture(scope="module")
def scenes():
    """Per scene: the worlds, the JAX trajectory of STEPS steps on the XLA
    path, and the port's state after each step."""
    out = {}
    for name in SCENES:
        jw, tw = build_scene(name)
        jstate, jcap = _build(jw, tw)
        jtraj, ttraj = [], []
        s = jstate
        for _ in range(STEPS):
            s = _jax_step(s)
            tw.step(DT)
            jtraj.append(state_to_numpy(s))
            ttraj.append(state_to_numpy(tw.state))
        out[name] = dict(jw=jw, tw=tw, jstate=jstate, jcap=jcap,
                         jtraj=jtraj, ttraj=ttraj)
    return out


@pytest.fixture(scope="module")
def hub():
    """The hub scene after 2 port steps on the CPU, while its joint impulses
    still grow, in the shape of one entry of `scenes` (its trajectory holds
    only the last state)."""
    jw = hub_scene(JWorld, jtypes_mod, jgeo)
    tw = hub_scene(TWorld, ttypes_mod, tgeo, device="cpu")
    jstate, jcap = _build(jw, tw)
    for _ in range(2):
        tw.step(DT)
    return dict(jw=jw, tw=tw, jstate=jstate, jcap=jcap,
                ttraj=[state_to_numpy(tw.state)])


@pytest.mark.parametrize("name", SCENES)
def test_jointed_slice_matches_jax_step(scenes, name):
    sc = scenes[name]
    for i, (a, b) in enumerate(zip(sc["jtraj"], sc["ttraj"])):
        np.testing.assert_allclose(b["bodies.center"], a["bodies.center"],
                                   atol=1e-4, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(b["bodies.v"], a["bodies.v"], atol=2e-3,
                                   rtol=0, err_msg=f"step {i}")
        for key in ("impulse", "motor_impulse", "spring_impulse",
                    "lower_impulse", "upper_impulse", "angular_impulse",
                    "spring_impulse2"):
            np.testing.assert_allclose(
                b[f"joints.{key}"], a[f"joints.{key}"], atol=5e-3, rtol=0,
                err_msg=f"step {i} {key}")
        np.testing.assert_array_equal(b["joints.color"], a["joints.color"])
        np.testing.assert_array_equal(b["bodies.awake"], a["bodies.awake"])
        assert b["profile.pair_count"] == a["profile.pair_count"], i
    last = sc["ttraj"][-1]
    assert np.abs(last["joints.impulse"]).max() > 1e-3
    assert last["profile.overflow_pairs"] == 0
    assert last["profile.events_dropped"] == 0
    assert sc["tw"].stats.ccd_gate_openings == 0


def _port_layout_from_jax(sc, leaves, data, acc, idx):
    """The JAX tiled-kernel layout (data (39, Lk), acc (9, Lk), idx (2, Lk):
    contact buckets and tail, then the joint windows) re-arranged into the
    port's kernel arguments. Contact lanes are taken as they are; the live
    joint lanes are sorted by (color, type), the color and type of a lane
    found through its (body_a, body_b) pair, which no two joints of these
    scenes share. Returns (kernel args, lanes): lanes[k] is the JAX layout
    lane of the port's joint lane k."""
    tw = sc["tw"]
    st = tw._step
    targs = torch_step_work(state_from_numpy(leaves, "cpu"), DT, tw.capacity,
                            st.classes, NSUB, True, StepStats(),
                            until="layout", joint_types=st.joint_types)
    (scalars, tidx, tdata, tacc, body, params, nsub, chunk, l0, ncol, tail_w,
     tjr) = targs
    L = tidx.shape[1]
    # the contact part of the two layouts is the same array
    np.testing.assert_array_equal(idx[:, :L], tidx.numpy())
    np.testing.assert_allclose(data[:NF, :L], tdata.numpy(), atol=1e-6)
    jlanes = L + np.nonzero(idx[0, L:] >= 0)[0]
    ja, jb = leaves["joints.body_a"], leaves["joints.body_b"]
    pair_to_joint = {(int(a), int(b)): i for i, (a, b) in
                     enumerate(zip(ja, jb)) if a >= 0}
    assert len(pair_to_joint) == int((ja >= 0).sum())
    jid = np.array([pair_to_joint[(int(idx[0, l]), int(idx[1, l]))]
                    for l in jlanes])
    colors = torch_step_work(
        state_from_numpy(leaves, "cpu"), DT, tw.capacity, st.classes, NSUB,
        True, StepStats(), until="colors",
        joint_types=st.joint_types)[1].numpy()
    ty = leaves["joints.type"]
    order = np.argsort(colors[jid].astype(np.int64) * 8 + ty[jid],
                       kind="stable")
    lanes = jlanes[order]
    col_sorted = colors[jid][order]
    offsets = np.searchsorted(col_sorted, np.arange(ncol + 1)).astype(
        np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    jr = JointRows(idx=t(idx[:, lanes]), data=t(data[:NFJ, lanes]),
                   acc=t(acc[:, lanes]),
                   type=t(ty[jid][order].astype(np.int32)),
                   offsets=t(offsets), overflow=tjr.overflow)
    # the port's own joint region holds the same columns
    np.testing.assert_array_equal(jr.idx.numpy(),
                                  tjr.idx.numpy()[:, :len(lanes)])
    np.testing.assert_allclose(jr.data.numpy(),
                               tjr.data.numpy()[:, :len(lanes)], atol=1e-6)
    args = (scalars, t(idx[:, :L]), t(data[:NF, :L]), t(acc[:NA, :L]), body,
            params, nsub, chunk, l0, ncol, tail_w, jr)
    return args, lanes


@pytest.mark.parametrize("name", SCENES + ["hub"])
def test_joint_twin_matches_pallas_tiled_kernel(request, name):
    sc = (request.getfixturevalue("hub") if name == "hub"
          else request.getfixturevalue("scenes")[name])
    leaves = sc["ttraj"][-1]            # warm: 6 steps from spawn
    jstate = to_jax_state(sc["jstate"], leaves)
    lay = _jax_layout(jstate)
    with pltpu.force_tpu_interpret_mode():
        ker = _jax_kernel(jstate)
    data, acc, idx = (np.asarray(x) for x in lay)
    ref_body, ref_acc = (np.asarray(x) for x in ker)
    ref_body = ref_body.copy()
    ref_body[5] += 1.0       # the tiled layout stores dq.c shifted by -1

    args, lanes = _port_layout_from_jax(sc, leaves, data, acc, idx)
    jr = args[11]
    n_types = len(set(jr.type.tolist()))
    assert len(lanes) == len(sc["jw"].builder._joints)
    assert n_types == {"farm": 3, "all_types": 5, "hub": 3}[name]
    if name == "hub":
        # the overflow color's segment: kind-pure windows sharing the hub
        assert jr.overflow
        kinds = [k for k, _, _, _ in window_table(args[1], *args[7:12])]
        assert kinds.count("joint_jacobi") >= 2
    assert np.abs(jr.acc.numpy()).max() > 1e-4     # warm joint impulses
    body, cacc, jacc = (x.numpy() for x in contact_solve(*args))
    L = args[1].shape[1]
    np.testing.assert_allclose(body, ref_body[:, :body.shape[1]], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cacc, ref_acc[:, :L], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(jacc, ref_acc[:, lanes], atol=ATOL, rtol=RTOL)
    # the solve moved something
    assert np.abs(body[0:3] - args[4].numpy()[0:3]).max() > 1e-3
    assert np.abs(jacc - jr.acc.numpy()).max() > 1e-5


@pytest.mark.slow
def test_joint_farm_trajectory_matches_jax_world():
    """joint_farm(4) for 60 steps through both World APIs."""
    from box2d_tpu import scenes as jscenes
    from box2d_tpu_torch import scenes as tscenes

    jw = jscenes.joint_farm(ragdolls=4)
    jw.compile()
    tw = tscenes.joint_farm(ragdolls=4, device="cpu")
    tw.compile()
    for i in range(60):
        jw.step(DT)
        tw.step(DT)
        a, b = state_to_numpy(jw.state), state_to_numpy(tw.state)
        np.testing.assert_allclose(b["bodies.center"], a["bodies.center"],
                                   atol=1e-3, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(b["bodies.v"], a["bodies.v"], atol=2e-2,
                                   rtol=0, err_msg=f"step {i}")
