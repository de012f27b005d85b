"""The contact solver's plain-PyTorch twin against the JAX Pallas kernels.

The solver inputs are the color-bucket layout the port's own step packs
for pyramid-20 after 30 steps from spawn (`_step_work(..., until="layout")`;
tests/test_torch_phases.py holds that layout to the JAX step's), so the
buckets are full and the warm impulses non-zero. The same arrays go
through `run_solver_kernel` (mode 1, `_solver_kernel`, chunk-wide windows)
and `run_solver_kernel_tiled` (`_tiled_kernel` at the window width w_k
and the `halves` that box2d_tpu/world.py:503-525 picks for a contact-only
layout), both in Pallas interpret mode as tests/test_pallas_solver.py
runs them, and through `contact_solve` on CPU tensors (the twin). Bound:
1e-5 absolute.

The two packages round differently on the CPU: XLA's CPU backend
contracts a multiply and an add into one fused multiply-add, which the
twin (and the CUDA kernel, built with -fmad=false) never does, and its
rsqrt differs from torch's in the last bit. At 30 steps that leaves the
twin within 1e-5 of the Pallas kernels. The "landing" layout, 15 steps
from spawn while the stack is still landing, amplifies it: resting
contacts sit at the speculative switch (separation within 1e-7 of 0, bias
sep/h against 0), and the reference moves by 6e-4 between the two
roundings of its own. `test_twin_matches_the_reference_rounded_alike`
shows it: in a process whose XLA backend may not fuse (no FMA
instructions), mode 1 equals the twin with the reference's rsqrt bit for
bit on the landing layout, and the reference with fusion differs from the
reference without by more than ten times the bound.

Every case drops the empty color buckets above the last one in use (the
kernels sweep them as no-ops) and grows the overflow tail by one chunk of
dead lanes, so all but "wide_chunk" share one shape, each Pallas kernel
compiles once for them and sweeps 12 windows a stage. "buckets" is the
layout as packed. "tail" moves three small color buckets into the tail
(port_fixtures.move_buckets_to_tail): its lanes share bodies, so it is a
true Jacobi window, and they fit in the tail's first window. "long_tail" moves
the three largest buckets, whose lanes fill three or more of the tail's
windows, which the twin sweeps in sequence as the Pallas kernels do.
"wide_chunk" spreads the long_tail layout over 256-lane color buckets
(each bucket's lanes in the first half of its chunk), for which world.py
gives the tiled kernel w_k = 256 in two halves: the branch that
pyramid-140's 2,560-lane windows (20 halves) take.

`test_tail_window_matches_the_jax_pallas_path` holds the port's choice of
the tail's window width to the JAX package's own VMEM budgets (mode 1,
the tiled kernel with and without joints, the streamed kernel, the XLA
path). `test_colored_windows_share_no_dynamic_body` checks, on layouts the
port packs itself (no JAX compile), what the kernel's one-barrier window
rests on: within a color bucket, a joint segment of a color that did not
overflow, and the two together, no dynamic endpoint appears twice.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from box2d_tpu.solver_pallas import (fits_kernel, fits_tiled,
                                     fits_tiled_streamed, max_active_windows,
                                     run_solver_kernel,
                                     run_solver_kernel_tiled,
                                     window_metadata, window_width)
from box2d_tpu.state import auto_chunk
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as ttypes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.api import World as TWorld
from box2d_tpu_torch.contact_solver import (_F, contact_solve, tail_window,
                                            window_table)
from box2d_tpu_torch.joints import _JF
from box2d_tpu_torch.state import Capacity
from port_fixtures import all_types_scene, move_buckets_to_tail

torch.set_num_threads(1)

NSUB = 4
DT = 1 / 60
ATOL = 1e-5
GROW = 1   # chunks of dead lanes added to the tail of every case
STEPS = 30     # steps from spawn of the solver inputs
LANDING = 15   # ... of the "landing" layout
# case: (steps from spawn, color buckets moved into the tail)
CASES = {"buckets": (STEPS, ()), "tail": (STEPS, (6, 7, 8)),
         "long_tail": (STEPS, (0, 1, 2)), "landing": (LANDING, ()),
         "wide_chunk": (STEPS, (0, 1, 2))}


@functools.lru_cache(maxsize=None)
def _port_layouts(name):
    """The solver inputs the port's own step packs (on the CPU) after
    LANDING and STEPS steps: pyramid-20, joint_farm(8) and the all-types
    scene, whose first bodies have reached the ground by STEPS, so that
    joint segments and contact buckets of one color ride one window.
    Returns ({steps: kernel arguments}, world)."""
    if name == "pyramid-20":
        w = tscenes.pyramid(rows=20, device="cpu")
    elif name == "joint_farm-8":
        w = tscenes.joint_farm(8, device="cpu")
    else:
        w = all_types_scene(TWorld, ttypes, tgeo, device="cpu")
    w.compile()
    st = w._step
    out = {}
    for steps in (LANDING, STEPS):
        w.run(steps - w.stats.steps)
        out[steps] = tworld._step_work(
            w.state, DT, w.capacity, st.classes, NSUB, st.continuous,
            tworld.StepStats(), until="layout", joint_types=st.joint_types)
    return out, w


def _port_layout(name):
    """(kernel arguments after STEPS steps, world)."""
    layouts, w = _port_layouts(name)
    return layouts[STEPS], w


def _used_colors(args):
    idx, chunk = args[1], args[7]
    return 1 + max(c for c in range(args[9])
                   if (idx[0, c * chunk:(c + 1) * chunk] >= 0).any())


def _widen(args, chunk):
    """The layout with each color bucket's lanes at the start of a
    `chunk`-lane bucket and the tail behind the last; tail windows of
    `chunk` lanes, grown by dead lanes to a whole number of chunks."""
    scalars, idx, data, acc, body, params, nsub, c0, l0, ncol, _, jr = args
    L = ncol * chunk + -(-(idx.shape[1] - l0) // chunk) * chunk
    src = torch.cat([torch.arange(ncol * c0), torch.arange(l0, idx.shape[1])])
    dst = torch.cat([(torch.arange(ncol * c0) // c0) * chunk
                     + torch.arange(ncol * c0) % c0,
                     ncol * chunk + torch.arange(idx.shape[1] - l0)])
    out = []
    for t, fill in ((idx, -1), (data, 0.0), (acc, 0.0)):
        wide = torch.full((t.shape[0], L), fill, dtype=t.dtype)
        wide[:, dst] = t[:, src]
        out.append(wide)
    return (scalars, *out, body, params, nsub, chunk, ncol * chunk, ncol,
            chunk, jr)


@functools.lru_cache(maxsize=None)
def _layout(case):
    """The pyramid-20 layout of `case` as numpy arrays: its color buckets
    up to the last one in use (by any of the cases), then the overflow
    tail grown by GROW chunks."""
    layouts, w = _port_layouts("pyramid-20")
    steps, buckets = CASES[case]
    args = layouts[steps]
    idx, chunk, l0 = args[1], args[7], args[8]
    used = max(_used_colors(a) for a in layouts.values())
    keep = torch.cat([torch.arange(used * chunk),
                      torch.arange(l0, idx.shape[1])])
    args = (args[0], *(a[:, keep].contiguous() for a in args[1:4]),
            *args[4:8], used * chunk, used, *args[10:])
    args = move_buckets_to_tail(args, buckets, GROW * chunk)
    if case == "wide_chunk":
        args = _widen(args, 2 * chunk)
    scalars, idx, data, acc, body, params, _, chunk, l0, ncol, tail_w, _ = \
        args
    body_t = body.clone()
    body_t[5] -= 1.0          # the tiled layout stores dq.c shifted by -1
    n = lambda t: t.numpy().copy()
    return dict(scalars=n(scalars), idx=n(idx), data=n(data), acc=n(acc),
                body=n(body), body_tiled=n(body_t), params=n(params),
                chunk=chunk, l0=l0, max_colors=ncol, tail_w=tail_w,
                p_cap=w.capacity.max_contact_pairs,
                nonstatic=w.state.bodies.type.numpy() != 0)


def _run_twin(lay):
    t = lambda a: torch.from_numpy(np.array(a))
    body, acc = contact_solve(
        t(lay["scalars"]), t(lay["idx"]), t(lay["data"]), t(lay["acc"]),
        t(lay["body"]), t(lay["params"]), NSUB, lay["chunk"], lay["l0"],
        lay["max_colors"], lay["tail_w"])
    return body.numpy(), acc.numpy()


_mode1 = jax.jit(run_solver_kernel, static_argnums=(0, 1, 2, 3))
_mode2 = jax.jit(run_solver_kernel_tiled, static_argnums=(0, 1),
                 static_argnames=("w", "grid_windows", "halves"))


def _run_mode1(lay):
    with pltpu.force_tpu_interpret_mode():
        body, acc = _mode1(
            NSUB, lay["max_colors"], lay["chunk"], lay["l0"],
            *(jnp.asarray(lay[k]) for k in ("scalars", "idx", "data", "acc",
                                            "body", "params")))
    return np.asarray(body), np.asarray(acc)


def _tiled_width(chunk, nb, layout_len):
    """(w_k, halves) as box2d_tpu/world.py:503-525 picks them for a
    contact-only layout with a resident accumulator."""
    w_win = window_width(chunk)
    for cand in (chunk // w_win, 20, 10, 5, 4, 2):
        if (cand > 1 and chunk % (cand * w_win) == 0
                and fits_tiled(nb, layout_len, cand * w_win, halves=cand)):
            return cand * w_win, cand
    return w_win, 1


def _run_mode2(lay):
    """The tiled kernel with world.py's window bookkeeping (:527-554) for a
    contact-only layout: one w_k-wide window per grid step."""
    idx, data = lay["idx"], lay["data"]
    L = data.shape[1]
    w_k, halves = _tiled_width(lay["chunk"], lay["body"].shape[1], L)
    live = idx[0] >= 0
    ba = np.maximum(idx[0], 0)
    bb = np.maximum(idx[1], 0)
    ns = lay["nonstatic"]
    wl, tlo, thi, nact, wrest, kinds = window_metadata(
        jnp.asarray(live), jnp.asarray(ba), jnp.asarray(bb),
        jnp.asarray(ns[ba] & live), jnp.asarray(ns[bb] & live), L, w_k,
        restitution=jnp.asarray(data[3]), halves=halves)
    ovf_cap = L - lay["l0"]
    with pltpu.force_tpu_interpret_mode():
        body, acc = _mode2(
            NSUB, lay["chunk"], jnp.asarray(lay["scalars"]), jnp.asarray(idx),
            jnp.asarray(data), jnp.asarray(lay["acc"]),
            jnp.asarray(lay["body_tiled"]), jnp.asarray(lay["params"]),
            wl, tlo, thi, nact, wrest, kinds=kinds, w=w_k,
            grid_windows=max_active_windows(L // w_k, lay["p_cap"],
                                            lay["max_colors"], ovf_cap, w_k),
            halves=halves)
    body = np.asarray(body).copy()
    body[5] += 1.0           # the tiled layout stores dq.c shifted by -1
    return body, np.asarray(acc), w_k, halves


def _tail_windows(lay, tail_w):
    return [(lo, hi) for kind, _, lo, hi in window_table(
        torch.from_numpy(lay["idx"]), lay["chunk"], lay["l0"],
        lay["max_colors"], tail_w) if kind == "tail"]


@pytest.mark.parametrize("mode,case", [
    (1, "buckets"), (1, "tail"), (1, "long_tail"),
    (2, "buckets"), (2, "tail"), (2, "long_tail"), (2, "wide_chunk")])
def test_twin_matches_pallas_kernel(mode, case):
    lay = _layout(case)
    idx, chunk, l0 = lay["idx"], lay["chunk"], lay["l0"]
    live = idx[0] >= 0
    assert live.sum() > 0 and (lay["acc"][0:2][:, live] != 0).any()
    tail = int(live[l0:].sum())
    if case in ("buckets", "tail"):
        assert not live[l0 + chunk:].any(), "tail lanes beyond the first chunk"
    if case != "buckets":
        ends = idx[:, l0:l0 + tail].ravel()
        shared = np.bincount(ends[lay["nonstatic"][ends]]).max()
        assert tail > 0 and shared > 1   # lanes share a dynamic body
    if mode == 1:
        ref_body, ref_acc = _run_mode1(lay)
        width, halves = chunk, 1
    else:
        ref_body, ref_acc, width, halves = _run_mode2(lay)
    # the twin sweeps the tail at the width of the kernel it is held to
    assert lay["tail_w"] == chunk == width
    if case == "long_tail":
        assert len(_tail_windows(lay, width)) >= 3
    if case == "wide_chunk":
        assert (chunk, halves) == (256, 2)
        assert len(_tail_windows(lay, width)) >= 2
    body, acc = _run_twin(lay)
    np.testing.assert_allclose(body, ref_body, atol=ATOL, rtol=0)
    np.testing.assert_allclose(acc, ref_acc, atol=ATOL, rtol=0)
    # the solve moved something: velocities and impulses changed
    assert np.abs(body[0:3] - lay["body"][0:3]).max() > 1e-3
    assert np.abs(acc - lay["acc"]).max() > 1e-4


# Run in a process of its own on the layout in argv[1]: mode 1 (interpret
# mode), and the twin with torch.rsqrt replaced by the JAX CPU backend's
# (this process runs nothing else); writes argv[2].
_UNFUSED = """
import sys
import jax
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu
from box2d_tpu.solver_pallas import run_solver_kernel
from box2d_tpu_torch.contact_solver import contact_solve_reference
lay = dict(np.load(sys.argv[1]))
nsub, chunk, l0, ncol, tail_w = (int(lay[k]) for k in (
    "nsub", "chunk", "l0", "max_colors", "tail_w"))
arrays = [lay[k] for k in ("scalars", "idx", "data", "acc", "body", "params")]
with pltpu.force_tpu_interpret_mode():
    body, acc = jax.jit(run_solver_kernel, static_argnums=(0, 1, 2, 3))(
        nsub, ncol, chunk, l0, *arrays)
rsqrt = jax.jit(jax.lax.rsqrt)
torch.rsqrt = lambda x: torch.from_numpy(np.asarray(rsqrt(x.numpy())).copy())
twin = contact_solve_reference(
    *(torch.from_numpy(a) for a in arrays), nsub, chunk, l0, ncol, tail_w)
np.savez(sys.argv[2], body=np.asarray(body), acc=np.asarray(acc),
         twin_body=twin[0].numpy(), twin_acc=twin[1].numpy())
"""


def _unfused_reference(lay, tmp):
    """Mode 1 on `lay`, and the twin with the JAX CPU backend's rsqrt,
    computed in a process whose XLA backend emits no FMA instructions
    (--xla_cpu_max_isa=AVX), so that it rounds every multiply and add
    apart as the twin does."""
    src, out = tmp / "layout.npz", tmp / "out.npz"
    np.savez(src, nsub=NSUB,
             **{k: v for k, v in lay.items() if k != "nonstatic"})
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _UNFUSED, str(src), str(out)],
                   env=env, cwd=here, check=True, timeout=600)
    return dict(np.load(out))


def test_twin_matches_the_reference_rounded_alike(tmp_path):
    """The twin against mode 1 on the landing layout, where both round
    alike: in a process whose XLA backend does not fuse multiply-adds,
    mode 1 equals the twin with the reference's rsqrt bit for bit, and the
    twin as it ships (torch's rsqrt) within the bound. The reference's own
    two roundings differ by more than ten times the bound there: the gap
    between the twin and mode 1 as XLA's CPU backend compiles it by
    default is the reference's rounding, not the port's semantics."""
    lay = _layout("landing")
    ref = _unfused_reference(lay, tmp_path)
    np.testing.assert_array_equal(ref["twin_body"], ref["body"])
    np.testing.assert_array_equal(ref["twin_acc"], ref["acc"])
    body, acc = _run_twin(lay)
    np.testing.assert_allclose(body, ref["body"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(acc, ref["acc"], atol=ATOL, rtol=0)
    assert np.abs(body[0:3] - lay["body"][0:3]).max() > 1e-3
    fused_body, fused_acc = _run_mode1(lay)
    gap = max(np.abs(fused_body - ref["body"]).max(),
              np.abs(fused_acc - ref["acc"]).max())
    assert gap > 10 * ATOL, gap


@pytest.mark.parametrize("tail_w", [64, 128, 1000])
def test_tail_windows_cover_each_live_lane_once(tail_w):
    """window_table cuts the live tail into consecutive windows of tail_w
    lanes from l0, each holding a live lane, the last one ending at the
    last live lane, and covers every live tail lane exactly once."""
    lay = _layout("long_tail")
    l0 = lay["l0"]
    live = lay["idx"][0] >= 0
    windows = _tail_windows(lay, tail_w)
    last = l0 + int(np.nonzero(live[l0:])[0][-1]) + 1
    assert len(windows) == -(-(last - l0) // tail_w)
    for k, (lo, hi) in enumerate(windows):
        assert lo == l0 + k * tail_w
        assert hi == min(lo + tail_w, last) and live[lo:hi].any()
    cover = np.zeros(live.shape[0], np.int64)
    for lo, hi in windows:
        cover[lo:hi] += 1
    assert (cover[l0:][live[l0:]] == 1).all() and not cover[:l0].any()


def _jax_tail_width(cap, solvable):
    """The tail's window width along the JAX package's own Pallas choice:
    box2d_tpu/api.py:252-279 (which mode) and world.py:503-525 (w_k), with
    its fits_* budgets; returns (mode, width)."""
    chunk = cap.color_chunk or auto_chunk(cap.max_contact_pairs)
    nb = cap.max_bodies
    l0 = cap.max_colors * chunk
    ovf = ((min(cap.max_contact_pairs, 2 * chunk) + chunk - 1)
           // chunk) * chunk
    w_win = window_width(chunk)
    jl = 0
    if solvable:
        mj = cap.max_joints
        jl = ((-(-mj // w_win)) * w_win
              + min(cap.max_colors * len(solvable), mj) * w_win)
    if not solvable and fits_kernel(nb, l0 + ovf, chunk):
        return "1", chunk
    if fits_tiled(nb, l0 + ovf + jl, w_win):
        if solvable:
            return "2 jointed", w_win
        return "2", _tiled_width(chunk, nb, l0 + ovf)[0]
    if fits_tiled_streamed(nb, w_win):
        return "3", w_win
    return "xla", ovf


TAIL_CAPS = {
    # name: (max_bodies, max_contact_pairs, max_joints, joint types)
    "pyramid-20": (211, 844, 1, ()),
    "pyramid-140": (9871, 39484, 1, ()),
    "chunk-512": (3000, 8000, 1, ()),
    "joint_farm-1000": (5000, 16000, 4000, (1, 3, 5)),
    "streamed": (60000, 200000, 40000, (3,)),
    "xla": (200000, 400000, 1, ()),
}


@pytest.mark.parametrize("name", list(TAIL_CAPS))
def test_tail_window_matches_the_jax_pallas_path(name):
    nb, pairs, joints, jtypes = TAIL_CAPS[name]
    cap = Capacity(max_bodies=nb, max_shapes=nb, max_joints=joints,
                   max_contact_pairs=pairs)
    mode, width = _jax_tail_width(cap, jtypes)
    assert mode == {"pyramid-20": "1", "pyramid-140": "2", "chunk-512": "2",
                    "joint_farm-1000": "2 jointed", "streamed": "3",
                    "xla": "xla"}[name]
    assert tail_window(cap, frozenset(jtypes)) == width


@pytest.mark.parametrize("name", ["pyramid-20", "joint_farm-8", "all_types"])
def test_colored_windows_share_no_dynamic_body(name):
    """No dynamic endpoint twice in a colored window (a color bucket, a
    joint segment of a color that did not overflow, and the two together,
    which the kernel sweeps as one window behind one barrier). "Dynamic"
    is the kernel's test, from the data rows: inverse mass or inverse
    inertia above 0. Also: the window table covers every live lane once."""
    args, _ = _port_layout(name)
    idx, data, chunk, l0, n_colors, tail_w, jr = (
        args[1].numpy(), args[2].numpy(), *args[7:12])
    table = window_table(args[1], chunk, l0, n_colors, tail_w, jr)
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
