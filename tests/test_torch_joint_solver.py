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

Whole slice: both scenes stepped 6 times from spawn through the port on the
CPU and through the JAX step on its XLA path (`use_pallas=0`); bounds are
those of tests/test_pallas_solver.py:178-185: centres 1e-4, velocities
2e-3, joint impulses 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from box2d_tpu.world import _step as jax_step
from box2d_tpu.world import _step_work as jax_step_work
from box2d_tpu_torch.contact_solver import NA, NF, contact_solve
from box2d_tpu_torch.joints import NFJ, JointRows
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy
from box2d_tpu_torch.world import StepStats
from box2d_tpu_torch.world import _step_work as torch_step_work
from test_torch_joints import SCENES, build_scene, scene_statics
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

DT = 1 / 60
NSUB = 4
ATOL, RTOL = 1e-5, 1e-4
STEPS = 6


@pytest.fixture(scope="module")
def scenes():
    """Per scene: the worlds, the JAX trajectory of STEPS steps on the XLA
    path, and the port's state after each step."""
    out = {}
    for name in SCENES:
        jw, tw = build_scene(name)
        jstate, jcap = jw.builder.build()
        classes, jt = scene_statics(jw)
        tw.compile()
        step = jax.jit(lambda s, c=jcap, k=classes, j=jt: jax_step(
            s, jnp.float32(DT), c, k, NSUB, j, (), True, None, 0))
        jtraj, ttraj = [], []
        s = jstate
        for _ in range(STEPS):
            s = step(s)
            tw.step(DT)
            jtraj.append(state_to_numpy(s))
            ttraj.append(state_to_numpy(tw.state))
        out[name] = dict(jw=jw, tw=tw, jstate=jstate, jcap=jcap,
                         classes=classes, jt=jt, jtraj=jtraj, ttraj=ttraj)
    return out


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
    scalars, tidx, tdata, tacc, body, params, nsub, chunk, l0, ncol, tjr = \
        targs
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
                   offsets=t(offsets))
    # the port's own joint region holds the same columns
    np.testing.assert_array_equal(jr.idx.numpy(),
                                  tjr.idx.numpy()[:, :len(lanes)])
    np.testing.assert_allclose(jr.data.numpy(),
                               tjr.data.numpy()[:, :len(lanes)], atol=1e-6)
    args = (scalars, t(idx[:, :L]), t(data[:NF, :L]), t(acc[:NA, :L]), body,
            params, nsub, chunk, l0, ncol, jr)
    return args, lanes


@pytest.mark.parametrize("name", SCENES)
def test_joint_twin_matches_pallas_tiled_kernel(scenes, name):
    sc = scenes[name]
    leaves = sc["ttraj"][-1]            # warm: 6 steps from spawn
    jstate = to_jax_state(sc["jstate"], leaves)
    fns = {u: jax.jit(lambda s, u=u: jax_step_work(
        s, jnp.float32(DT), sc["jcap"], sc["classes"], NSUB, sc["jt"], (),
        True, None, 2, until=u)) for u in ("layout", "kernel")}
    data, acc, idx = (np.asarray(x) for x in fns["layout"](jstate))
    with pltpu.force_tpu_interpret_mode():
        ref_body, ref_acc = (np.asarray(x) for x in fns["kernel"](jstate))
    ref_body = ref_body.copy()
    ref_body[5] += 1.0       # the tiled layout stores dq.c shifted by -1

    args, lanes = _port_layout_from_jax(sc, leaves, data, acc, idx)
    jr = args[10]
    n_types = len(set(jr.type.tolist()))
    assert len(lanes) == len(sc["jw"].builder._joints)
    assert n_types == (3 if name == "farm" else 5)
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
