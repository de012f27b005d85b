"""The solver kernel (CUDA) and its plain-PyTorch twin.

`contact_solve` runs the whole TGS-soft substep pipeline of one world in
one launch of csrc/contact_solver.cu. It replaces the Pallas TPU kernels
that compute this pipeline: `solver_pallas._solver_kernel` (mode 1), the
contact branch of `solver_pallas._tiled_kernel` (mode 2) and, when the
call carries a joint region, the joint sweep `solver_pallas._joint_sweep`
(csrc/joint_sweep.cuh). The source files' headers say what bounds them on
the card and what their design does about it.

The arrays at the boundary are mode 1's own layout, so the same tensors can
feed box2d_tpu.solver_pallas.run_solver_kernel in the tests:
  scalars (1, 8) f32  [h, inv_h, contact_speed, restitution_threshold,
                       max_linear_speed, 0, 0, 0]
  idx (2, L) i32 (-1 = dead lane), data (NF, L), acc (NA, L) f32
  body (8, Nb) f32 (unshifted dq), params (12, Nb) f32
  nsub substeps; color bucket c owns lanes [c*chunk, (c+1)*chunk) for
  c < n_colors; lanes [l0, L) are the overflow tail, swept as consecutive
  Jacobi windows of tail_w lanes (tail_window). Buckets at or above
  n_colors must be empty.
  joints (optional): joints.JointRows, the joint region. Its lanes are
  sorted by color, then type; color c owns lanes [offsets[c],
  offsets[c + 1]) and is swept just ahead of contact bucket c in every
  stage but restitution.
`window_table` lists the windows of a stage in visit order; empty ones are
left out. A window is a Jacobi window: its lanes read the body state at
the window's start, then the velocity deltas of dynamic endpoints are
summed in. Within a color bucket or joint segment no two lanes share a
dynamic body (the coloring sees to it), so there this equals a Gauss-Seidel
sweep and the kernel writes each lane's bodies straight away; the
overflow tail and the overflow color's joint segment, whose lanes do share
bodies, are true Jacobi windows. There the kernel sums each body's deltas
in fixed point (int64, units of 2^-32), so its result does not depend on
the order its lanes add in; the twin adds them as floats with index_add_,
and the two differ by rounding. The overflow color's joints are swept as
the tiled Pallas kernel sweeps them: one window per type, cut into
windows of at most JOINT_WINDOW lanes. The contact tail is cut as the
Pallas path the JAX package would take for the same world cuts it
(tail_window): the width of a Jacobi window changes the physics.

`contact_solve` takes the twin for CPU tensors only. For CUDA tensors it
launches the kernel or raises; there is no fallback.

`contact_solve_batched` is the same pipeline for W worlds of one capacity
in one launch (the counterpart of the mode-1 Pallas kernel under
jax.vmap, whose grid gains a batch axis): every array gains a leading
world axis, and world w of the result is what `contact_solve` returns
for world w's arrays. `batched_plan` picks its kernel from the capacity:
the small-world kernel (a group of warps a world, several worlds an SM,
body rows in shared memory) for worlds whose every pass fits in 1,024
lanes, else the cluster kernel, a cluster a world. Its twin,
`contact_solve_batched_reference`, sweeps all worlds' lanes of a window
together: no two worlds share a body, so that is each world's own sweep.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import NamedTuple

import torch

from .counters import bump
from .cuda_build import HERE, nvcc_build, twin
from .joints import (NAJ, NFJ, JointRows, joint_window, joint_window_inputs,
                     solvable_joint_types)
from .state import Capacity, auto_chunk

NF = 33
NA = 9
_F = dict(
    nx=0, ny=1, friction=2, restitution=3, tangent_speed=4,
    rolling_resistance=5, rolling_mass=6, soft_bias=7, soft_mass=8,
    soft_imp=9,
    ax0=10, ay0=11, bx0=12, by0=13,
    ax1=14, ay1=15, bx1=16, by1=17,
    sep0=18, sep1=19, nmass0=20, nmass1=21, tmass0=22, tmass1=23,
    relv0=24, relv1=25, mask0=26, mask1=27,
    inv_ma=28, inv_mb=29, inv_ia=30, inv_ib=31,
    relax=32,
)

# the colors the kernel's window table holds (the coloring's masks hold 32)
MAX_COLORS = 32
# the most lanes of a window of the overflow color's joints: the tiled
# Pallas kernel's window width (box2d_tpu/solver_pallas.py:619-628; its
# window_width gives 128 for every color chunk at the default target)
JOINT_WINDOW = 128

# the JAX package's default window of its tiled kernel
# (box2d_tpu/solver_pallas.py:619, DEFAULT_WINDOW) and its body tile
# (:620, DEFAULT_BODY_TILE), which its VMEM budgets are reckoned at
TILED_WINDOW = 128
TILED_BODY_TILE = 512

# kernel launches made by contact_solve (the twin does not count), and how
# many of them carried a joint region (the joint sweep ran on the card);
# launches made by contact_solve_batched, and how many of them carried
# joint regions; exact under threads (counters.bump)
LAUNCHES = 0
JOINT_LAUNCHES = 0
BATCHED_LAUNCHES = 0
BATCHED_JOINT_LAUNCHES = 0
# batched launches that took the small-world kernel (batched_plan)
SMALL_LAUNCHES = 0

SOURCE = os.path.join(HERE, "csrc", "contact_solver.cu")
JOINT_SOURCE = os.path.join(HERE, "csrc", "joint_sweep.cuh")
_LIB = None
BUILD_SECONDS = None   # wall time of this process's nvcc build
_SHAPES = {}           # launch_shape's answers, by device and instance
# held by the first build and the first query of each _SHAPES entry, so
# threads that first touch the card together build and ask once
_LOCK = threading.RLock()


def build() -> ctypes.CDLL:
    """Compile csrc/contact_solver.cu (which includes joint_sweep.cuh) for
    sm_90a into _build/ (once per process, whichever thread asks first)
    and load it (cuda_build.py). Raises if nvcc fails."""
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _build()
    return _LIB


def _build():
    global _LIB, BUILD_SECONDS
    lib, log, BUILD_SECONDS = nvcc_build(SOURCE, "contact_solver")
    fn = lib.b2t_contact_solve
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fnj = lib.b2t_contact_solve_joints
    fnj.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fnj.restype = ctypes.c_int
    fnb = lib.b2t_contact_solve_batched
    fnb.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fnb.restype = ctypes.c_int
    fnjb = lib.b2t_contact_solve_joints_batched
    fnjb.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    fnjb.restype = ctypes.c_int
    lib.b2t_launch_shape.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.b2t_launch_shape.restype = ctypes.c_int
    lib.b2t_small_shape.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.b2t_small_shape.restype = ctypes.c_int
    lib.ptxas_log = log
    _LIB = lib


def launch_shape(joints: bool, batched: bool = False,
                 plan: BatchedPlan | None = None) -> dict:
    """The kernel's launch on the current card: `cluster` CTAs of `threads`
    threads, one cluster a launch (a world, in a batched launch), and
    `max_active_clusters`, how many such clusters the card can hold at
    once (cudaOccupancyMaxActiveClusters). Raises if the cluster does not
    fit. For a batched plan on the small-world path: `threads_per_world`,
    `worlds_per_cta`, `threads` a CTA, `smem_per_cta`, `ctas_per_sm` the
    card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    `sms`, `resident_ctas` and `resident_worlds`, and the kernel
    instance's `registers` and `local_bytes` a thread (spills land in
    local memory). Raises if no such CTA fits. Asked once per process,
    device and instance (joints, batched, plan): the card answers for its
    current device."""
    dev = torch.cuda.current_device()
    if plan is not None and plan.path == "small":
        return _asked_once((dev, bool(joints), plan),
                           lambda: _small_shape(bool(joints), plan))
    kind = (3 if joints else 2) if batched else int(bool(joints))
    return _asked_once((dev, kind), lambda: _cluster_shape(kind))


def _asked_once(key, ask) -> dict:
    """_SHAPES[key], from ask() the first time (one thread asks)."""
    shape = _SHAPES.get(key)
    if shape is None:
        with _LOCK:
            shape = _SHAPES.get(key)
            if shape is None:
                shape = _SHAPES[key] = ask()
    return shape


def _cluster_shape(kind: int) -> dict:
    out = (ctypes.c_int * 3)()
    rc = build().b2t_launch_shape(kind, ctypes.addressof(out))
    if rc != 0 or out[2] < 1:
        raise RuntimeError(f"contact_solve: a cluster of {out[0]} CTAs "
                           f"of {out[1]} threads does not fit on this "
                           f"card (cudaError {rc}, {out[2]} clusters)")
    return dict(cluster=out[0], threads=out[1], max_active_clusters=out[2])


def _small_shape(joints: bool, plan: BatchedPlan) -> dict:
    out = (ctypes.c_int * 5)()
    threads = plan.threads_per_world * plan.worlds_per_cta
    rc = build().b2t_small_shape(int(joints), plan.threads_per_world,
                                 plan.worlds_per_cta, plan.nb,
                                 ctypes.addressof(out))
    if rc != 0 or out[0] < 1:
        raise RuntimeError(
            f"contact_solve_batched: a small-world CTA of {threads} "
            f"threads and {out[4]} bytes of shared memory does not fit "
            f"on this card (cudaError {rc}, {out[0]} CTAs an SM)")
    return dict(
        threads_per_world=plan.threads_per_world,
        worlds_per_cta=plan.worlds_per_cta, threads=threads,
        smem_per_cta=out[4], ctas_per_sm=out[0], sms=out[1],
        resident_ctas=out[0] * out[1],
        resident_worlds=out[0] * out[1] * plan.worlds_per_cta,
        registers=out[2], local_bytes=out[3])


# ---------------------------------------------------------------------------
# which kernel a batched launch takes
# ---------------------------------------------------------------------------
# The small-world kernel (csrc/contact_solver.cu, solve_small_kernel) and
# the figures its plan is reckoned with.
# the widest pass the small kernel takes: at 4 worlds it is faster than
# the cluster kernel up to 821 lanes (pyramid-40) and slower from 1,584
# lanes on (joint_farm(300); time_solver.py --paths); more worlds favour
# it, as the cluster kernel holds 15 worlds at once
SMALL_LANES = 1024
GROUP_MAX = 128            # kGroupMax: the small kernel's launch bound
CTA_THREADS = 128          # a CTA's threads, where a world takes fewer


class BatchedPlan(NamedTuple):
    path: str                # "small" or "cluster"
    nb: int                  # bodies a world
    bound: int               # lanes of the capacity's widest pass
    threads_per_world: int   # the world's group (0 on the cluster path)
    worlds_per_cta: int


@functools.lru_cache(maxsize=None)
def batched_plan(nb: int, chunk: int, tail_w: int, lj: int = 0) -> BatchedPlan:
    """The kernel of a batched launch for worlds of this capacity: nb
    bodies, color chunk `chunk`, tail windows of tail_w lanes and, with
    joint regions, lj joint lanes (the capacity's max_joints). The bound
    of the capacity's widest pass is max(nb, chunk + lj, tail_w) (the
    bodies; a color's bucket and joint segment, one window; a tail
    window). Where it is at most SMALL_LANES, the small-world kernel,
    the faster there: a group of threads_per_world threads a world, nb
    rounded up to a warp (at most GROUP_MAX): a colored window holds at
    most one live lane a dynamic body, so its lanes and the bodies'
    passes take one round; worlds_per_cta groups fill a CTA of
    CTA_THREADS. Its shared memory (the kernel's small_world_bytes: 64
    bytes a body and a window table, about 66 KB a CTA at nb 1,024) then
    fits the card's 227 KB opt-in; launch_shape gives it. Else the
    cluster kernel. Decided once for each capacity."""
    bound = max(nb, chunk + lj, tail_w)
    if bound > SMALL_LANES:
        return BatchedPlan("cluster", nb, bound, 0, 0)
    group = min(GROUP_MAX, max(32, -(-nb // 32) * 32))
    return BatchedPlan("small", nb, bound, group, CTA_THREADS // group)


def plan_for(args) -> BatchedPlan:
    """The plan contact_solve_batched takes for its arguments `args`
    (scalars, idx, data, acc, body, params, nsub, chunk, l0, n_colors,
    tail_w[, jrows]): batched_plan of their capacity."""
    jrows = args[11] if len(args) > 11 else None
    lj = 0 if jrows is None else jrows.data.shape[2]
    return batched_plan(args[4].shape[2], args[7], args[10], lj)


def _check(scalars, idx, data, acc, body, params, chunk, l0, n_colors,
           tail_w, joints=None):
    dev = body.device
    L = data.shape[1]
    nb = body.shape[1]
    want = [(scalars, (1, 8), torch.float32), (idx, (2, L), torch.int32),
            (data, (NF, L), torch.float32), (acc, (NA, L), torch.float32),
            (body, (8, nb), torch.float32), (params, (12, nb), torch.float32)]
    if joints is not None:
        lj = joints.data.shape[1]
        want += [(joints.idx, (2, lj), torch.int32),
                 (joints.data, (NFJ, lj), torch.float32),
                 (joints.acc, (NAJ, lj), torch.float32),
                 (joints.type, (lj,), torch.int32),
                 (joints.offsets, (n_colors + 1,), torch.int32)]
    for t, shape, dtype in want:
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("contact_solve needs contiguous tensors")
    if not (0 <= n_colors * chunk <= l0 <= L):
        raise ValueError(f"bad layout: n_colors={n_colors} chunk={chunk} "
                         f"l0={l0} L={L}")
    if n_colors > MAX_COLORS:
        raise ValueError(f"n_colors={n_colors}: the kernel's window table "
                         f"holds {MAX_COLORS} colors")
    if tail_w < 1:
        raise ValueError(f"tail window of {tail_w} lanes")


def contact_solve(scalars, idx, data, acc, body, params, nsub: int,
                  chunk: int, l0: int, n_colors: int, tail_w: int,
                  joints: JointRows | None = None):
    """Run the solver pipeline; returns (body (8, Nb), acc (NA, L)), and
    the joint accumulators (NAJ, LJ) as a third value when `joints` is
    given. tail_w: the width of the overflow tail's Jacobi windows
    (tail_window)."""
    _check(scalars, idx, data, acc, body, params, chunk, l0, n_colors,
           tail_w, joints)
    if body.device.type == "cpu":
        return contact_solve_reference(scalars, idx, data, acc, body,
                                       params, nsub, chunk, l0, n_colors,
                                       tail_w, joints)
    if body.device.type != "cuda":
        raise ValueError(f"contact_solve: unsupported device {body.device}")
    lib = build()
    L = data.shape[1]
    nb = body.shape[1]
    out_body = torch.empty_like(body)
    out_acc = torch.empty_like(acc)
    jsum = torch.empty((4, nb), dtype=torch.int64, device=body.device)
    with torch.cuda.device(body.device):
        launch_shape(joints is not None)
        stream = torch.cuda.current_stream(body.device).cuda_stream
        if joints is None:
            rc = lib.b2t_contact_solve(
                scalars.data_ptr(), idx.data_ptr(), data.data_ptr(),
                acc.data_ptr(), body.data_ptr(), params.data_ptr(),
                out_body.data_ptr(), out_acc.data_ptr(), jsum.data_ptr(),
                nb, L, chunk, l0, n_colors, nsub, tail_w, stream)
        else:
            out_jacc = torch.empty_like(joints.acc)
            rc = lib.b2t_contact_solve_joints(
                scalars.data_ptr(), idx.data_ptr(), data.data_ptr(),
                acc.data_ptr(), body.data_ptr(), params.data_ptr(),
                out_body.data_ptr(), out_acc.data_ptr(), jsum.data_ptr(),
                joints.idx.data_ptr(), joints.data.data_ptr(),
                joints.acc.data_ptr(), joints.type.data_ptr(),
                joints.offsets.data_ptr(), out_jacc.data_ptr(),
                nb, L, chunk, l0, n_colors, nsub, tail_w,
                joints.data.shape[1], int(joints.overflow), JOINT_WINDOW,
                stream)
    if rc != 0:
        raise RuntimeError(f"contact_solve kernel launch failed: "
                           f"cudaError {rc}")
    if joints is None:
        bump(globals(), "LAUNCHES")
        return out_body, out_acc
    bump(globals(), "LAUNCHES", "JOINT_LAUNCHES")
    return out_body, out_acc, out_jacc


def contact_solve_batched(scalars, idx, data, acc, body, params, nsub: int,
                          chunk: int, l0: int, n_colors: int, tail_w: int,
                          jrows: JointRows | None = None):
    """The pipeline of W worlds in one launch: scalars (W, 1, 8), idx (W,
    2, L), data (W, NF, L), acc (W, NA, L), body (W, 8, Nb), params (W,
    12, Nb), the rest as contact_solve. Returns (body (W, 8, Nb), acc (W,
    NA, L)), and the joint accumulators (W, NAJ, LJ) as a third value when
    `jrows` is given: each world's joint region (JointRows with a leading
    world axis on every array, its `overflow` a (W,) int32 tensor of each
    world's flag). World w is contact_solve of world w's arrays; the
    kernel is batched_plan's for the arrays' capacity (on the cluster
    path, each world on a cluster of its own)."""
    if idx.dim() != 3 or body.dim() != 3:
        raise ValueError("contact_solve_batched takes a leading world axis")
    n_w = body.shape[0]
    arrays = (scalars, idx, data, acc, body, params)
    j0 = None
    if jrows is not None:
        arrays += tuple(jrows[:5]) + (jrows.overflow,)
        j0 = JointRows(*(x[0] for x in jrows[:5]))
        if jrows.overflow.dtype != torch.int32:
            raise ValueError("the worlds' overflow flags must be int32")
    for t in arrays:
        if t.shape[0] != n_w:
            raise ValueError(f"world axes differ: {t.shape[0]} and {n_w}")
        if t.device != body.device:
            raise ValueError(f"all tensors must be on {body.device}, got "
                             f"{t.device}")
    _check(scalars[0], idx[0], data[0], acc[0], body[0], params[0], chunk,
           l0, n_colors, tail_w, j0)
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError("contact_solve_batched needs contiguous tensors")
    if body.device.type == "cpu":
        return contact_solve_batched_reference(
            scalars, idx, data, acc, body, params, nsub, chunk, l0,
            n_colors, tail_w, jrows)
    if body.device.type != "cuda":
        raise ValueError(f"contact_solve_batched: unsupported device "
                         f"{body.device}")
    args = (scalars, idx, data, acc, body, params, nsub, chunk, l0,
            n_colors, tail_w, jrows)
    return _launch_batched(args, plan_for(args))


def _launch_batched(args, plan: BatchedPlan):
    """contact_solve_batched's launch of CUDA tensors `args` by `plan`."""
    (scalars, idx, data, acc, body, params, nsub, chunk, l0, n_colors,
     tail_w, jrows) = args
    lib = build()
    n_w, _, L = data.shape
    nb = body.shape[2]
    small = plan.path == "small"
    out_body = torch.empty_like(body)
    out_acc = torch.empty_like(acc)
    # the cluster kernel's Jacobi sums; the small one keeps them in shared
    # memory
    jsum = None if small else torch.empty((n_w, 4, nb), dtype=torch.int64,
                                          device=body.device)
    shape = (plan.threads_per_world, plan.worlds_per_cta)
    with torch.cuda.device(body.device):
        launch_shape(jrows is not None, batched=True, plan=plan)
        stream = torch.cuda.current_stream(body.device).cuda_stream
        common = (scalars.data_ptr(), idx.data_ptr(), data.data_ptr(),
                  acc.data_ptr(), body.data_ptr(), params.data_ptr(),
                  out_body.data_ptr(), out_acc.data_ptr(),
                  None if small else jsum.data_ptr())
        if jrows is None:
            rc = lib.b2t_contact_solve_batched(
                *common, n_w, nb, L, chunk, l0, n_colors, nsub, tail_w,
                *shape, stream)
        else:
            out_jacc = torch.empty_like(jrows.acc)
            rc = lib.b2t_contact_solve_joints_batched(
                *common, jrows.idx.data_ptr(), jrows.data.data_ptr(),
                jrows.acc.data_ptr(), jrows.type.data_ptr(),
                jrows.offsets.data_ptr(), out_jacc.data_ptr(),
                jrows.overflow.data_ptr(), n_w, nb, L, chunk, l0, n_colors,
                nsub, tail_w, jrows.data.shape[2], JOINT_WINDOW, *shape,
                stream)
    if rc != 0:
        raise RuntimeError(f"contact_solve_batched kernel launch failed: "
                           f"cudaError {rc}")
    names = ("BATCHED_LAUNCHES",) + (("SMALL_LAUNCHES",) if small else ())
    if jrows is None:
        bump(globals(), *names)
        return out_body, out_acc
    bump(globals(), *names, "BATCHED_JOINT_LAUNCHES")
    return out_body, out_acc, out_jacc


# ---------------------------------------------------------------------------
# the width of the overflow tail's windows
# ---------------------------------------------------------------------------
# The one piece of the JAX package's VMEM budgeting (fits_kernel,
# fits_tiled, fits_tiled_streamed and the `halves` choice) that the port
# keeps: which Pallas path a world takes there decides how wide the Jacobi
# windows of its overflow tail are, and the width of a Jacobi window
# changes the physics. Jax-free copies of box2d_tpu/solver_pallas.py:86-94
# and :623-662, box2d_tpu/api.py:252-279 and box2d_tpu/world.py:503-525.

def window_width(chunk: int, target: int = TILED_WINDOW) -> int:
    """Largest multiple of 128 <= target that divides the color chunk
    (solver_pallas.window_width)."""
    w = min(chunk, target)
    while w > 128 and chunk % w != 0:
        w -= 128
    return max(w, 128) if chunk % max(w, 128) == 0 else 128


def _fits_kernel(nb: int, layout_len: int, chunk: int) -> bool:
    if layout_len % chunk != 0:
        return False
    budget = 12 * 1024 * 1024 / 4
    return (6 * nb * chunk + (NF + 2 * NA + 8) * layout_len + 48 * nb) < budget


def _fits_tiled(nb: int, layout_len: int, w: int, halves: int = 1) -> bool:
    tb = TILED_BODY_TILE
    nb_pad = ((max(nb, 128) + tb - 1) // tb) * tb
    words = (28 * nb_pad + (2 * NA + 2) * layout_len + 3 * NF * w
             + 4 * tb * (w // halves) + 48 * w + 65536)
    return words * 4 < 12 * 1024 * 1024


def _fits_tiled_streamed(nb: int, w: int) -> bool:
    tb = TILED_BODY_TILE
    nb_pad = ((max(nb, 128) + tb - 1) // tb) * tb
    words = (28 * nb_pad + 3 * (NFJ + NA + 2) * w + 4 * tb * w + 48 * w
             + 65536)
    return words * 4 < 12 * 1024 * 1024


def _layout(cap: Capacity, joint_types):
    """(chunk, l0, ovf, w_win, solvable joint types, joint region length)
    of the JAX package's solver layout for this capacity."""
    chunk = cap.color_chunk or auto_chunk(cap.max_contact_pairs)
    l0 = cap.max_colors * chunk
    ovf = ((min(cap.max_contact_pairs, 2 * chunk) + chunk - 1)
           // chunk) * chunk
    w_win = window_width(chunk)
    solvable = solvable_joint_types(joint_types)
    jl = 0
    if solvable:
        n_groups = cap.max_colors * len(solvable)
        mj = cap.max_joints
        jl = (-(-mj // w_win)) * w_win + min(n_groups, mj) * w_win
    return chunk, l0, ovf, w_win, solvable, jl


@functools.lru_cache(maxsize=None)
def kernel_mode(cap: Capacity, joint_types=frozenset()) -> int:
    """The JAX package's choice of solver path for a world compiled with
    these joint types (box2d_tpu/api.py:250-279): 1 the resident kernel
    (joint-free layouts that fit it), 2 the tiled kernel, 3 the tiled
    kernel streaming its accumulators, 0 the XLA path. Fixed at compile:
    box2d_tpu.api.World keeps it when a runtime joint remakes the step."""
    chunk, l0, ovf, w_win, solvable, jl = _layout(cap, joint_types)
    nb = cap.max_bodies
    if not solvable and _fits_kernel(nb, l0 + ovf, chunk):
        return 1
    if _fits_tiled(nb, l0 + ovf + jl, w_win):
        return 2
    if _fits_tiled_streamed(nb, w_win):
        return 3
    return 0


@functools.lru_cache(maxsize=None)
def tail_window(cap: Capacity, joint_types=frozenset(),
                mode: int | None = None) -> int:
    """The width of the overflow tail's Jacobi windows for a world of this
    capacity and these joint types: the width the JAX package sweeps it
    at. `mode` is the solver path fixed when the world was compiled
    (kernel_mode of the compile-time joint types; by default that of
    `joint_types`). Mode 1 sweeps chunk-wide windows; a jointed world in
    mode 1 takes the XLA path (box2d_tpu/world.py:383), as does mode 0,
    and the XLA path sweeps the whole tail as one window; the tiled
    kernel sweeps w_k-wide ones, where w_k is window_width(chunk) widened
    by `halves` for a contact-only resident layout, and window_width(chunk)
    for a jointed or streamed one. Computed once per (capacity, joint
    types, mode), when the world's step is made (world.Step)."""
    chunk, l0, ovf, w_win, solvable, _ = _layout(cap, joint_types)
    if mode is None:
        mode = kernel_mode(cap, joint_types)
    if mode == 0 or (mode == 1 and solvable):
        return ovf
    if mode == 1:
        return chunk
    if mode == 2 and not solvable:
        for cand in (chunk // w_win, 20, 10, 5, 4, 2):
            if (cand > 1 and chunk % (cand * w_win) == 0
                    and _fits_tiled(cap.max_bodies, l0 + ovf, cand * w_win,
                                    halves=cand)):
                return cand * w_win
    return w_win


# ---------------------------------------------------------------------------
# the windows of a stage
# ---------------------------------------------------------------------------

def window_table(idx, chunk: int, l0: int, n_colors: int, tail_w: int,
                 joints: JointRows | None = None):
    """The non-empty windows of one stage in visit order, as (kind, color,
    lo, hi) lane ranges: for each color c, its joint segment ("joint") or,
    if it is the overflow color's, that segment's kind-pure Jacobi windows
    of at most JOINT_WINDOW lanes ("joint_jacobi"), then contact
    bucket c up to its last live lane ("contact"); then the overflow tail
    up to its last live lane, cut every tail_w lanes from l0 ("tail",
    color n_colors). Joint windows take no part in the restitution stage.
    The kernel builds the same table on the card (its prologue): when the
    coloring overflowed (joints.overflow), the overflow color, the highest
    in use, owns the last non-empty joint segment; cutting a segment
    without shared bodies into windows changes nothing. Reads the layout
    back to the host."""
    L = idx.shape[1]
    live = (idx[0] >= 0).cpu()
    ends = []
    for lo, hi in [(c * chunk, (c + 1) * chunk) for c in range(n_colors)] \
            + [(l0, L)]:
        nz = torch.nonzero(live[lo:hi])
        ends.append(lo + int(nz[-1]) + 1 if nz.numel() else lo)
    joff = [0] * (n_colors + 1) if joints is None else joints.offsets.tolist()
    split = -1
    if joints is not None and joints.overflow:
        split = max((c for c in range(n_colors) if joff[c + 1] > joff[c]),
                    default=-1)
    table = []
    for c in range(n_colors):
        jlo, jhi = joff[c], joff[c + 1]
        if c == split:
            types = joints.type[jlo:jhi].tolist()
            s = jlo
            while s < jhi:
                e = min(s + JOINT_WINDOW, jhi)
                e = next((k for k in range(s + 1, e)
                          if types[k - jlo] != types[s - jlo]), e)
                table.append(("joint_jacobi", c, s, e))
                s = e
        elif jhi > jlo:
            table.append(("joint", c, jlo, jhi))
        if ends[c] > c * chunk:
            table.append(("contact", c, c * chunk, ends[c]))
    for lo in range(l0, ends[n_colors], tail_w):
        hi = min(lo + tail_w, ends[n_colors])
        if live[lo:hi].any():
            table.append(("tail", n_colors, lo, hi))
    return table


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------

@twin
def contact_solve_reference(scalars, idx, data, acc, body, params,
                            nsub: int, chunk: int, l0: int, n_colors: int,
                            tail_w: int, joints: JointRows | None = None):
    """The kernel's semantics in plain PyTorch on any device: the same
    stages, windows (window_table) and arithmetic (mode 1's contact_sweep
    and the joint sweep, operation by operation for every lane; the terms
    that read only a window's rows are computed once a solve), with each
    window's deltas added by index_add_."""
    out_body = body.clone()   # updated in place below
    out_acc = acc.clone()
    s = scalars.reshape(-1)
    h, inv_h, contact_speed, rthresh, max_lin = s[0], s[1], s[2], s[3], s[4]
    live = idx[0] >= 0
    if joints is not None:
        out_jacc = joints.acc.clone()
        jlive = joints.idx[0] >= 0
    # (is_joint, live lanes, the window's stage-independent inputs) in
    # visit order
    windows = []
    for kind, _, lo, hi in window_table(idx, chunk, l0, n_colors, tail_w,
                                        joints):
        is_joint = kind.startswith("joint")
        lanes = torch.nonzero((jlive if is_joint else live)[lo:hi])
        lanes = lanes.squeeze(1) + lo
        windows.append((is_joint, lanes, joint_window_inputs(
            joints, lanes, h, inv_h) if is_joint else _window_inputs(
                data, idx, lanes, inv_h, contact_speed, rthresh)))
    for k in range(3 * nsub + 1):
        p = 3 if k == 3 * nsub else k % 3
        if p == 0:
            _integrate_velocities(out_body, params, max_lin)
        elif p == 2:
            _integrate_positions(out_body, h)
        for is_joint, lanes, win in windows:
            if not is_joint:
                _window(out_body, out_acc, win, lanes, p)
            elif p != 3:
                joint_window(out_body, out_jacc, win, lanes, p)
    if joints is None:
        return out_body, out_acc
    return out_body, out_acc, out_jacc


def _integrate_velocities(body, prm, max_lin):
    active = prm[11] > 0
    vx = prm[2] + prm[5] * body[0]
    vy = prm[3] + prm[5] * body[1]
    w = prm[4] + prm[6] * body[2]
    vv = vx * vx + vy * vy
    scale = torch.where(vv > max_lin * max_lin,
                        max_lin * torch.rsqrt(torch.clamp(vv, min=1e-12)),
                        1.0)
    vx = vx * scale
    vy = vy * scale
    w = torch.minimum(torch.maximum(w, -prm[10]), prm[10])
    vx = vx * (1.0 - prm[7])
    vy = vy * (1.0 - prm[8])
    w = w * (1.0 - prm[9])
    body[0] = torch.where(active, vx, body[0])
    body[1] = torch.where(active, vy, body[1])
    body[2] = torch.where(active, w, body[2])


def _integrate_positions(body, h):
    active = body[7] > 0
    dpx = body[3] + h * body[0]
    dpy = body[4] + h * body[1]
    da = h * body[2]
    c0, s0 = body[5], body[6]
    c1 = c0 - da * s0
    s1 = s0 + da * c0
    inv = torch.rsqrt(torch.clamp(c1 * c1 + s1 * s1, min=1e-12))
    body[3] = torch.where(active, dpx, body[3])
    body[4] = torch.where(active, dpy, body[4])
    body[5] = torch.where(active, c1 * inv, c0)
    body[6] = torch.where(active, s1 * inv, s0)


def _window_inputs(data, idx, lanes, inv_h, contact_speed, rthresh):
    """What a contact window reads that no stage changes, built once a
    solve so that every stage runs only its arithmetic: its lanes' body
    ids, their constraint rows by name, the lanes whose body a / b is
    dynamic with those bodies' ids (the lanes the deltas are added from),
    and the terms of _window's arithmetic that read only these rows and
    the scalars (inv_h, contact_speed, rthresh: 0-d, or one value a
    lane), each computed as _window would compute it. The anchors and
    separations of the two points are stacked (2, lanes)."""
    ia = idx[0, lanes].long()
    ib = idx[1, lanes].long()
    rows = data[:, lanes].unbind(0)
    c = {k: rows[i] for k, i in _F.items()}
    dyn_a = torch.nonzero((c["inv_ma"] > 0.0)
                          | (c["inv_ia"] > 0.0)).squeeze(1)
    dyn_b = torch.nonzero((c["inv_mb"] > 0.0)
                          | (c["inv_ib"] > 0.0)).squeeze(1)
    two = lambda name: torch.stack([c[name + "0"], c[name + "1"]])  # noqa
    c.update(
        inv_h=inv_h, neg_nx=-c["nx"], neg_speed=-contact_speed,
        sm_sb=c["soft_mass"] * c["soft_bias"],
        ax2=two("ax"), ay2=two("ay"), bx2=two("bx"), by2=two("by"),
        sep2=two("sep"))
    for bias_f in (0.0, 1.0):
        c["mscale", bias_f] = 1.0 + bias_f * (c["soft_mass"] - 1.0)
        c["iscale", bias_f] = bias_f * c["soft_imp"]
    neg_rthresh = -rthresh
    for jj in (0, 1):
        c["neg_nmass", jj] = -c[f"nmass{jj}"]
        c["rest_relv", jj] = c["restitution"] * c[f"relv{jj}"]
        c["rest_ok", jj] = ((c["restitution"] != 0.0)
                            & (c[f"relv{jj}"] < neg_rthresh))
    return ia, ib, c, dyn_a, ia[dyn_a], dyn_b, ib[dyn_b]


def _window(body, acc, win, lanes, p):
    """One Jacobi window of stage p over the live `lanes`, whose
    stage-independent inputs are `win` (_window_inputs)."""
    ia, ib, c, dyn_a, ia_dyn, dyn_b, ib_dyn = win
    a = acc[:, lanes].unbind(0)
    r = c.__getitem__
    nx, ny = r("nx"), r("ny")
    tx, ty = ny, r("neg_nx")
    inv_ma, inv_mb = r("inv_ma"), r("inv_mb")
    inv_ia, inv_ib = r("inv_ia"), r("inv_ib")
    ni = [a[0], a[1]]
    ti = [a[2], a[3]]
    tni = [a[4], a[5]]
    roll = a[6]

    if p == 0:
        zero = torch.zeros_like(nx)
        dvax = dvay = dwa = dvbx = dvby = dwb = zero
        for j in (0, 1):
            mask = r(f"mask{j}")
            pn = ni[j] * mask
            pt = ti[j] * mask
            px = pn * nx + pt * tx
            py = pn * ny + pt * ty
            rax, ray = r(f"ax{j}"), r(f"ay{j}")
            rbx, rby = r(f"bx{j}"), r(f"by{j}")
            dvax = dvax - inv_ma * px
            dvay = dvay - inv_ma * py
            dwa = dwa - inv_ia * (rax * py - ray * px)
            dvbx = dvbx + inv_mb * px
            dvby = dvby + inv_mb * py
            dwb = dwb + inv_ib * (rbx * py - rby * px)
        dwa = dwa - inv_ia * roll
        dwb = dwb + inv_ib * roll
        dva = torch.stack([dvax, dvay, dwa])
        dvb = torch.stack([dvbx, dvby, dwb])
    else:
        bias_f = 1.0 if p == 1 else 0.0
        rest_f = 1.0 if p == 3 else 0.0
        solve_f = 1.0 - rest_f
        st_a = body[:, ia].unbind(0)
        st_b = body[:, ib].unbind(0)
        dpx = st_b[3] - st_a[3]
        dpy = st_b[4] - st_a[4]
        dqca, dqsa = st_a[5], st_a[6]
        dqcb, dqsb = st_b[5], st_b[6]
        vax, vay, wa = st_a[0], st_a[1], st_a[2]
        vbx, vby, wb = st_b[0], st_b[1], st_b[2]
        relaxv = r("relax")
        # both points' separations at the window's start, (2, lanes): the
        # anchors rotate with the start poses, which the points share
        ax2, ay2, bx2, by2 = r("ax2"), r("ay2"), r("bx2"), r("by2")
        rrx_a = dqca * ax2 - dqsa * ay2
        rry_a = dqsa * ax2 + dqca * ay2
        rrx_b = dqcb * bx2 - dqsb * by2
        rry_b = dqsb * bx2 + dqcb * by2
        dsx = dpx + rrx_b - rrx_a
        dsy = dpy + rry_b - rry_a
        sep = r("sep2") + dsx * nx + dsy * ny
        speculative = sep > 0.0
        bias2 = torch.where(
            speculative, sep * r("inv_h"),
            bias_f * torch.maximum(r("sm_sb") * sep, r("neg_speed")))
        mscale2 = torch.where(speculative, 1.0, c["mscale", bias_f])
        iscale2 = torch.where(speculative, 0.0, c["iscale", bias_f])
        total_normal = torch.zeros_like(roll)
        for j in (0, 1):
            rax, ray = r(f"ax{j}"), r(f"ay{j}")
            rbx, rby = r(f"bx{j}"), r(f"by{j}")
            mask = r(f"mask{j}")
            neg_nmass = c["neg_nmass", j]
            vrx = (vbx - wb * rby) - (vax - wa * ray)
            vry = (vby + wb * rbx) - (vay + wa * rax)
            vn = vrx * nx + vry * ny
            imp_s = (neg_nmass * (mscale2[j] * vn + bias2[j])
                     - iscale2[j] * ni[j]) * relaxv
            new_s = torch.clamp(ni[j] + imp_s, min=0.0) * mask
            d_s = new_s - ni[j]
            apply_r = (c["rest_ok", j] & (tni[j] > 0.0)) * mask
            imp_r = neg_nmass * (vn + c["rest_relv", j])
            new_r = torch.clamp(ni[j] + imp_r, min=0.0)
            d_r = (new_r - ni[j]) * apply_r
            impulse = solve_f * d_s + rest_f * d_r
            ni[j] = ni[j] + impulse
            tni[j] = tni[j] + solve_f * new_s + rest_f * d_r
            total_normal = total_normal + new_s
            px = impulse * nx
            py = impulse * ny
            vax = vax - inv_ma * px
            vay = vay - inv_ma * py
            wa = wa - inv_ia * (rax * py - ray * px)
            vbx = vbx + inv_mb * px
            vby = vby + inv_mb * py
            wb = wb + inv_ib * (rbx * py - rby * px)
        friction, tangent_speed = r("friction"), r("tangent_speed")
        for j in (0, 1):
            rax, ray = r(f"ax{j}"), r(f"ay{j}")
            rbx, rby = r(f"bx{j}"), r(f"by{j}")
            mask = r(f"mask{j}")
            tmass = r(f"tmass{j}")
            vrx = (vbx - wb * rby) - (vax - wa * ray)
            vry = (vby + wb * rbx) - (vay + wa * rax)
            vt = vrx * tx + vry * ty - tangent_speed
            max_f = friction * ni[j]
            new_t = torch.minimum(torch.maximum(
                ti[j] - tmass * vt * relaxv, -max_f), max_f) * mask
            impulse = solve_f * (new_t - ti[j])
            ti[j] = ti[j] + impulse
            px = impulse * tx
            py = impulse * ty
            vax = vax - inv_ma * px
            vay = vay - inv_ma * py
            wa = wa - inv_ia * (rax * py - ray * px)
            vbx = vbx + inv_mb * px
            vby = vby + inv_mb * py
            wb = wb + inv_ib * (rbx * py - rby * px)
        max_l = r("rolling_resistance") * total_normal
        new_roll = torch.minimum(torch.maximum(
            roll - r("rolling_mass") * (wb - wa) * relaxv, -max_l), max_l)
        dl = solve_f * (new_roll - roll)
        wa = wa - inv_ia * dl
        wb = wb + inv_ib * dl
        acc[0:7, lanes] = torch.stack(
            [ni[0], ni[1], ti[0], ti[1], tni[0], tni[1], roll + dl])
        dva = torch.stack([vax - st_a[0], vay - st_a[1], wa - st_a[2]])
        dvb = torch.stack([vbx - st_b[0], vby - st_b[1], wb - st_b[2]])

    vel = body[0:3]   # a view: index_add_ writes into body
    vel.index_add_(1, ia_dyn, dva.index_select(1, dyn_a))
    vel.index_add_(1, ib_dyn, dvb.index_select(1, dyn_b))


def _batched_windows(idx, chunk: int, l0: int, n_colors: int, tail_w: int,
                     joints: JointRows | None = None):
    """The windows of a stage for W stacked worlds, in visit order, as
    (is_joint, lanes of the flattened (W * L) contact lane axis, or of the
    (W * LJ) joint lane axis): each of a world's windows (window_table of
    its arrays) joins the windows of the same color's joint segment (the
    same kind-pure window of it, by rank), the same color bucket, or the
    same tail window, of the other worlds. A world's own windows keep
    their order, and within a window each world's lanes keep theirs."""
    n_w, _, L = idx.shape
    keyed: dict = {}
    for w in range(n_w):
        live = idx[w, 0] >= 0
        jr = None
        if joints is not None:
            jr = JointRows(joints.idx[w], joints.data[w], joints.acc[w],
                           joints.type[w], joints.offsets[w],
                           bool(joints.overflow[w]))
            jlive = jr.idx[0] >= 0
            lj = jr.idx.shape[1]
        rank = {}
        for kind, c, lo, hi in window_table(idx[w], chunk, l0, n_colors,
                                            tail_w, jr):
            if kind.startswith("joint"):
                k = rank[c] = rank.get(c, -1) + 1
                key = (0, c, 0, k)
                lanes = torch.nonzero(jlive[lo:hi]).squeeze(1) + (lo + w * lj)
            else:
                key = (0, c, 1, 0) if kind == "contact" else (1, lo, 0, 0)
                lanes = torch.nonzero(live[lo:hi]).squeeze(1) + (lo + w * L)
            keyed.setdefault(key, []).append(lanes)
    return [(k[0] == 0 and k[2] == 0, torch.cat(keyed[k]))
            for k in sorted(keyed)]


@twin
def contact_solve_batched_reference(scalars, idx, data, acc, body, params,
                                    nsub: int, chunk: int, l0: int,
                                    n_colors: int, tail_w: int,
                                    joints: JointRows | None = None):
    """contact_solve_batched in plain PyTorch: the worlds side by side on
    one lane axis and one body axis (world w's bodies at w * Nb), every
    window of a stage taking all worlds' lanes of that window, each world
    with its own scalars; joint windows run joints.joint_window on the
    worlds' joint regions laid side by side the same way. The arithmetic
    is contact_solve_reference's, operation by operation."""
    n_w, _, L = idx.shape
    nb = body.shape[2]
    dev = body.device
    flat = lambda t: t.permute(1, 0, 2).reshape(t.shape[1], -1)  # noqa
    off = (torch.arange(n_w, dtype=idx.dtype, device=dev) * nb)[:, None,
                                                                 None]
    idx_f = flat(torch.where(idx >= 0, idx + off, idx))
    out_body = flat(body).clone()
    out_acc = flat(acc).clone()
    data_f = flat(data)
    prm_f = flat(params)
    s = scalars.reshape(n_w, 8)
    per_body = lambda col: s[:, col].repeat_interleave(nb)  # noqa: E731
    h_b, max_lin_b = per_body(0), per_body(4)
    windows = _batched_windows(idx, chunk, l0, n_colors, tail_w, joints)
    if joints is not None:
        lj = joints.idx.shape[2]
        jr_f = JointRows(
            idx=flat(torch.where(joints.idx >= 0, joints.idx + off,
                                 joints.idx)),
            data=flat(joints.data), acc=None,
            type=joints.type.reshape(-1), offsets=None)
        out_jacc = flat(joints.acc).clone()
    lane_s = [(s[lanes // (lj if is_joint else L), 0],
               s[lanes // (lj if is_joint else L), 1],
               s[lanes // (lj if is_joint else L), 2],
               s[lanes // (lj if is_joint else L), 3])
              for is_joint, lanes in windows]
    wins = [joint_window_inputs(jr_f, lanes, h, inv_h) if is_joint
            else _window_inputs(data_f, idx_f, lanes, inv_h, speed, rthresh)
            for (is_joint, lanes), (h, inv_h, speed, rthresh) in zip(
                windows, lane_s)]
    for k in range(3 * nsub + 1):
        p = 3 if k == 3 * nsub else k % 3
        if p == 0:
            _integrate_velocities(out_body, prm_f, max_lin_b)
        elif p == 2:
            _integrate_positions(out_body, h_b)
        for (is_joint, lanes), win in zip(windows, wins):
            if not is_joint:
                _window(out_body, out_acc, win, lanes, p)
            elif p != 3:
                joint_window(out_body, out_jacc, win, lanes, p)
    unflat = lambda t, r: t.reshape(r, n_w, -1).permute(1, 0, 2)  # noqa
    out = (unflat(out_body, 8).contiguous(),
           unflat(out_acc, acc.shape[1]).contiguous())
    if joints is None:
        return out
    return out + (unflat(out_jacc, NAJ).contiguous(),)
