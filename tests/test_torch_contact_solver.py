"""The contact solver's plain-PyTorch twin against the JAX Pallas kernels.

The solver inputs are a real pyramid-8 color-bucket layout, taken from the
JAX step itself (`_step_work(..., use_pallas=1, until="layout")`) on a
state 15 steps from spawn (stepped by the port, which is quicker here than
compiling the JAX step), so the buckets are full and the warm impulses
non-zero. The same arrays go through `run_solver_kernel` (mode 1, `_solver_kernel`) and
`run_solver_kernel_tiled` (mode 2, `_tiled_kernel`), both in Pallas
interpret mode as tests/test_pallas_solver.py runs them, and through
`contact_solve` on CPU tensors (the twin). Bound: 1e-5 absolute.

The "tail" case moves the lanes of the first three color buckets into the
overflow tail, so tail lanes share bodies and the window is a true Jacobi
window. Mode 1 sweeps the tail as chunk-wide windows in sequence, so the
case keeps every tail lane inside the tail's first chunk (asserted).

`test_colored_windows_share_no_dynamic_body` checks, on layouts the port
packs itself (no JAX compile), what the kernel's one-barrier window rests
on: within a color bucket, a joint segment of a color that did not
overflow, and the two together, no dynamic endpoint appears twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from box2d_tpu import math2d as jm
from box2d_tpu import scenes as jscenes
from box2d_tpu.narrowphase import classes_for_shape_types
from box2d_tpu.solver import BodySolverState
from box2d_tpu.solver_pallas import (max_active_windows, pack_bodies,
                                     pack_bodies_tiled, run_solver_kernel,
                                     run_solver_kernel_tiled,
                                     window_metadata, window_width)
from box2d_tpu.state import auto_chunk
from box2d_tpu.world import _step_work
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as ttypes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.api import World as TWorld
from box2d_tpu_torch.contact_solver import _F, contact_solve, window_table
from box2d_tpu_torch.joints import _JF
from box2d_tpu_torch.state import state_to_numpy
from chip_smoke import all_types_scene
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

NSUB = 4
DT = 1 / 60
ATOL = 1e-5


@pytest.fixture(scope="module")
def layout():
    w = jscenes.pyramid(rows=8)
    state, cap = w.builder.build()
    classes = classes_for_shape_types(
        s["geom"].type for s in w.builder._shapes)
    tw = tscenes.pyramid(rows=8, device="cpu")
    tw.compile()
    tw.run(15)
    state = to_jax_state(state, state_to_numpy(tw.state))
    lay = jax.jit(lambda s: _step_work(
        s, jnp.float32(DT), cap, classes, NSUB, frozenset(), (), True, None,
        1, until="layout"))
    data, acc, idx = (np.asarray(x) for x in lay(state))

    dt = jnp.float32(DT)
    h = dt / NSUB
    inv_h = 1.0 / h
    inv_dt = 1.0 / dt
    b = state.bodies
    tn = state.tuning
    nb = b.center.shape[0]
    bs = BodySolverState(v=b.v, w=b.w, dp=jnp.zeros_like(b.center),
                         dq=jm.rot_identity((nb,)))
    body, params = (np.asarray(x) for x in pack_bodies(b, bs, tn, h, inv_dt))
    body_t = np.asarray(pack_bodies_tiled(b, bs, tn, h, inv_dt)[0])
    scalars = np.asarray(jnp.stack([
        h, inv_h, tn.contact_speed, tn.restitution_threshold,
        tn.max_linear_speed, 0.0, 0.0, 0.0]).astype(jnp.float32))[None, :]
    chunk = cap.color_chunk or auto_chunk(cap.max_contact_pairs)
    return dict(data=data, acc=acc, idx=idx, body=body, body_tiled=body_t,
                params=params, scalars=scalars, chunk=chunk,
                max_colors=cap.max_colors, l0=cap.max_colors * chunk,
                p_cap=cap.max_contact_pairs,
                nonstatic=np.asarray(b.type) != 0)


def _move_buckets_to_tail(lay, n_buckets):
    """A copy of the layout with the live lanes of the first n_buckets
    color buckets moved, in order, to the start of the overflow tail."""
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in lay.items()}
    chunk, l0 = lay["chunk"], lay["l0"]
    src = np.nonzero(lay["idx"][0, :n_buckets * chunk] >= 0)[0]
    dst = l0 + np.arange(src.size)
    for key, fill in (("data", 0.0), ("acc", 0.0), ("idx", -1)):
        out[key][:, dst] = lay[key][:, src]
        out[key][:, src] = fill
    return out


def _run_twin(lay):
    t = lambda a: torch.from_numpy(np.array(a))
    body, acc = contact_solve(
        t(lay["scalars"]), t(lay["idx"]), t(lay["data"]), t(lay["acc"]),
        t(lay["body"]), t(lay["params"]), NSUB, lay["chunk"], lay["l0"],
        lay["max_colors"])
    return body.numpy(), acc.numpy()


_mode1 = jax.jit(run_solver_kernel, static_argnums=(0, 1, 2, 3))
_mode2 = jax.jit(run_solver_kernel_tiled, static_argnums=(0, 1),
                 static_argnames=("w", "grid_windows"))


def _run_mode1(lay):
    with pltpu.force_tpu_interpret_mode():
        body, acc = _mode1(
            NSUB, lay["max_colors"], lay["chunk"], lay["l0"],
            *(jnp.asarray(lay[k]) for k in ("scalars", "idx", "data", "acc",
                                            "body", "params")))
    return np.asarray(body), np.asarray(acc)


def _run_mode2(lay):
    """The tiled kernel with world.py's window bookkeeping (:527-554) for a
    contact-only layout: one w-wide window per grid step."""
    idx, data = lay["idx"], lay["data"]
    L = data.shape[1]
    w_k = window_width(lay["chunk"])
    live = idx[0] >= 0
    ba = np.maximum(idx[0], 0)
    bb = np.maximum(idx[1], 0)
    ns = lay["nonstatic"]
    wl, tlo, thi, nact, wrest, kinds = window_metadata(
        jnp.asarray(live), jnp.asarray(ba), jnp.asarray(bb),
        jnp.asarray(ns[ba] & live), jnp.asarray(ns[bb] & live), L, w_k,
        restitution=jnp.asarray(data[3]))
    ovf_cap = L - lay["l0"]
    with pltpu.force_tpu_interpret_mode():
        body, acc = _mode2(
            NSUB, lay["chunk"], jnp.asarray(lay["scalars"]), jnp.asarray(idx),
            jnp.asarray(data), jnp.asarray(lay["acc"]),
            jnp.asarray(lay["body_tiled"]), jnp.asarray(lay["params"]),
            wl, tlo, thi, nact, wrest, kinds=kinds, w=w_k,
            grid_windows=max_active_windows(L // w_k, lay["p_cap"],
                                            lay["max_colors"], ovf_cap, w_k))
    body = np.asarray(body).copy()
    body[5] += 1.0           # the tiled layout stores dq.c shifted by -1
    return body, np.asarray(acc)


@pytest.mark.parametrize("case", ["buckets", "tail"])
@pytest.mark.parametrize("mode", [1, 2])
def test_twin_matches_pallas_kernel(layout, case, mode):
    lay = layout if case == "buckets" else _move_buckets_to_tail(layout, 3)
    idx, chunk, l0 = lay["idx"], lay["chunk"], lay["l0"]
    live = idx[0] >= 0
    assert live.sum() > 0 and (lay["acc"][0:2][:, live] != 0).any()
    tail = int(live[l0:].sum())
    assert not live[l0 + chunk:].any(), "tail lanes beyond the first chunk"
    if case == "tail":
        ends = idx[:, l0:l0 + tail].ravel()
        shared = np.bincount(ends[lay["nonstatic"][ends]]).max()
        assert tail > 0 and shared > 1   # lanes share a dynamic body
    ref_body, ref_acc = _run_mode1(lay) if mode == 1 else _run_mode2(lay)
    body, acc = _run_twin(lay)
    np.testing.assert_allclose(body, ref_body, atol=ATOL, rtol=0)
    np.testing.assert_allclose(acc, ref_acc, atol=ATOL, rtol=0)
    # the solve moved something: velocities and impulses changed
    assert np.abs(body[0:3] - lay["body"][0:3]).max() > 1e-3
    assert np.abs(acc - lay["acc"]).max() > 1e-4


def _port_layout(name):
    """The solver inputs the port's own step packs (on the CPU): pyramid-20
    after 5 steps, joint_farm(8) after 30 and the all-types scene after 30,
    when their first bodies have reached the ground, so that joint segments
    and contact buckets of one color ride one window."""
    if name == "pyramid-20":
        w, steps = tscenes.pyramid(rows=20, device="cpu"), 5
    elif name == "joint_farm-8":
        w, steps = tscenes.joint_farm(8, device="cpu"), 30
    else:
        w, steps = all_types_scene(TWorld, ttypes, tgeo, device="cpu"), 30
    w.compile()
    w.run(steps)
    st = w._step
    return tworld._step_work(w.state, DT, w.capacity, st.classes, NSUB,
                             st.continuous, tworld.StepStats(),
                             until="layout", joint_types=st.joint_types)


@pytest.mark.parametrize("name", ["pyramid-20", "joint_farm-8", "all_types"])
def test_colored_windows_share_no_dynamic_body(name):
    """No dynamic endpoint twice in a colored window (a color bucket, a
    joint segment of a color that did not overflow, and the two together,
    which the kernel sweeps as one window behind one barrier). "Dynamic"
    is the kernel's test, from the data rows: inverse mass or inverse
    inertia above 0. Also: the window table covers every live lane once."""
    args = _port_layout(name)
    idx, data, chunk, l0, n_colors, jr = (args[1].numpy(), args[2].numpy(),
                                          args[7], args[8], args[9],
                                          args[10])
    table = window_table(args[1], chunk, l0, n_colors, jr)
    ends = {}
    for kind, c, lo, hi in table:
        if kind == "joint_jacobi":
            continue
        if kind in ("contact", "tail"):
            lanes = np.arange(lo, hi)[idx[0, lo:hi] >= 0]
            ia, ib = idx[0, lanes], idx[1, lanes]
            d = data[:, lanes]
            f = _F
        else:
            ji, jd = jr.idx.numpy(), jr.data.numpy()
            lanes = np.arange(lo, hi)[ji[0, lo:hi] >= 0]
            ia, ib = ji[0, lanes], ji[1, lanes]
            d = jd[:, lanes]
            f = _JF
        dyn_a = (d[f["inv_ma"]] > 0) | (d[f["inv_ia"]] > 0)
        dyn_b = (d[f["inv_mb"]] > 0) | (d[f["inv_ib"]] > 0)
        if kind != "tail":
            ends.setdefault(c, []).append(
                np.concatenate([ia[dyn_a], ib[dyn_b]]))
    colored = [np.concatenate(e) for e in ends.values()]
    assert sum(e.size for e in colored) > 0
    for c, e in zip(ends, colored):
        uniq, count = np.unique(e, return_counts=True)
        assert count.max(initial=1) == 1, (
            f"color {c}: bodies {uniq[count > 1]} appear twice")
    if jr is not None:
        # joints and contacts share the window of some color
        assert any(len(e) == 2 for e in ends.values())
        assert not jr.overflow
    # every live contact lane lies in exactly one window of the table
    cover = np.zeros(idx.shape[1], np.int64)
    for kind, _, lo, hi in table:
        if kind in ("contact", "tail"):
            cover[lo:hi] += 1
    live = idx[0] >= 0
    assert (cover[live] == 1).all() and live.sum() > 0
