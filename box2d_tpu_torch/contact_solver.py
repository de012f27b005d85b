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
  c < n_colors; lanes [l0, L) are the overflow tail. Buckets at or above
  n_colors must be empty.
  joints (optional): joints.JointRows, the joint region. Its lanes are
  sorted by color; color c owns lanes [offsets[c], offsets[c + 1]) and is
  swept just ahead of contact bucket c in every stage but restitution.
Every window (bucket, joint segment or tail) is a Jacobi window: its lanes read the body
state at the window's start, then the velocity deltas of dynamic endpoints
are summed in. Mode 1 sweeps the tail as chunk-wide windows in sequence, so
it agrees with this when the live tail lanes fit in the first chunk.

`contact_solve` takes the twin for CPU tensors only. For CUDA tensors it
launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .cuda_build import HERE, nvcc_build
from .joints import NAJ, NFJ, JointRows, joint_window

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

# kernel launches made by contact_solve (the twin does not count), and how
# many of them carried a joint region (the joint sweep ran on the card)
LAUNCHES = 0
JOINT_LAUNCHES = 0

SOURCE = os.path.join(HERE, "csrc", "contact_solver.cu")
JOINT_SOURCE = os.path.join(HERE, "csrc", "joint_sweep.cuh")
_LIB = None
BUILD_SECONDS = None   # wall time of this process's nvcc build


def build() -> ctypes.CDLL:
    """Compile csrc/contact_solver.cu (which includes joint_sweep.cuh) for
    sm_90a into _build/ (once per process) and load it (cuda_build.py).
    Raises if nvcc fails."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    lib, log, BUILD_SECONDS = nvcc_build(SOURCE, "contact_solver")
    fn = lib.b2t_contact_solve
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fnj = lib.b2t_contact_solve_joints
    fnj.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fnj.restype = ctypes.c_int
    lib.ptxas_log = log
    _LIB = lib
    return lib


def _check(scalars, idx, data, acc, body, params, chunk, l0, n_colors,
           joints=None):
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


def contact_solve(scalars, idx, data, acc, body, params, nsub: int,
                  chunk: int, l0: int, n_colors: int,
                  joints: JointRows | None = None):
    """Run the solver pipeline; returns (body (8, Nb), acc (NA, L)), and
    the joint accumulators (NAJ, LJ) as a third value when `joints` is
    given."""
    _check(scalars, idx, data, acc, body, params, chunk, l0, n_colors,
           joints)
    if body.device.type == "cpu":
        return contact_solve_reference(scalars, idx, data, acc, body,
                                       params, nsub, chunk, l0, n_colors,
                                       joints)
    if body.device.type != "cuda":
        raise ValueError(f"contact_solve: unsupported device {body.device}")
    global LAUNCHES, JOINT_LAUNCHES
    lib = build()
    L = data.shape[1]
    nb = body.shape[1]
    lj = 0 if joints is None else joints.data.shape[1]
    scratch_w = max(chunk, L - l0, lj, 1)
    out_body = torch.empty_like(body)
    out_acc = torch.empty_like(acc)
    scratch = torch.empty((6, scratch_w), dtype=torch.float32,
                          device=body.device)
    with torch.cuda.device(body.device):
        stream = torch.cuda.current_stream(body.device).cuda_stream
        if joints is None:
            rc = lib.b2t_contact_solve(
                scalars.data_ptr(), idx.data_ptr(), data.data_ptr(),
                acc.data_ptr(), body.data_ptr(), params.data_ptr(),
                out_body.data_ptr(), out_acc.data_ptr(), scratch.data_ptr(),
                nb, L, chunk, l0, n_colors, nsub, scratch_w, stream)
        else:
            out_jacc = torch.empty_like(joints.acc)
            rc = lib.b2t_contact_solve_joints(
                scalars.data_ptr(), idx.data_ptr(), data.data_ptr(),
                acc.data_ptr(), body.data_ptr(), params.data_ptr(),
                out_body.data_ptr(), out_acc.data_ptr(), scratch.data_ptr(),
                joints.idx.data_ptr(), joints.data.data_ptr(),
                joints.acc.data_ptr(), joints.type.data_ptr(),
                joints.offsets.data_ptr(), out_jacc.data_ptr(),
                nb, L, chunk, l0, n_colors, nsub, scratch_w, lj, stream)
    if rc != 0:
        raise RuntimeError(f"contact_solve kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    if joints is None:
        return out_body, out_acc
    JOINT_LAUNCHES += 1
    return out_body, out_acc, out_jacc


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------

def contact_solve_reference(scalars, idx, data, acc, body, params,
                            nsub: int, chunk: int, l0: int, n_colors: int,
                            joints: JointRows | None = None):
    """The kernel's semantics in plain PyTorch on any device: the same
    stages, windows and arithmetic (mode 1's contact_sweep and the joint
    sweep, operation by operation), with each window's deltas added by
    index_add_."""
    L = data.shape[1]
    out_body = body.clone()   # updated in place below
    out_acc = acc.clone()
    s = scalars.reshape(-1)
    h, inv_h, contact_speed, rthresh, max_lin = s[0], s[1], s[2], s[3], s[4]
    live = idx[0] >= 0
    bounds = [(c * chunk, (c + 1) * chunk) for c in range(n_colors)]
    bounds.append((l0, L))
    if joints is not None:
        out_jacc = joints.acc.clone()
        jlive = joints.idx[0] >= 0
        joff = joints.offsets.tolist()
    # (is_joint, lanes) in visit order: joints of color c, contacts of
    # color c, ..., then the overflow tail
    windows = []
    for c, (lo, hi) in enumerate(bounds):
        if joints is not None and c < n_colors and joff[c + 1] > joff[c]:
            jl = torch.nonzero(jlive[joff[c]:joff[c + 1]]).squeeze(1) + joff[c]
            if jl.numel():
                windows.append((True, jl))
        lanes = torch.nonzero(live[lo:hi]).squeeze(1) + lo
        if lanes.numel():
            windows.append((False, lanes))
    for k in range(3 * nsub + 1):
        p = 3 if k == 3 * nsub else k % 3
        if p == 0:
            _integrate_velocities(out_body, params, max_lin)
        elif p == 2:
            _integrate_positions(out_body, h)
        for is_joint, lanes in windows:
            if not is_joint:
                _window(out_body, out_acc, data, idx, lanes, p, inv_h,
                        contact_speed, rthresh)
            elif p != 3:
                joint_window(out_body, joints, out_jacc, lanes, p, h, inv_h)
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


def _window(body, acc, data, idx, lanes, p, inv_h, contact_speed, rthresh):
    """One Jacobi window of stage p over the live `lanes`."""
    ia = idx[0, lanes].long()
    ib = idx[1, lanes].long()
    d = data[:, lanes]
    a = acc[:, lanes]
    r = lambda name: d[_F[name]]
    nx, ny = r("nx"), r("ny")
    tx, ty = ny, -nx
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
        st_a = body[:, ia]
        st_b = body[:, ib]
        dpx = st_b[3] - st_a[3]
        dpy = st_b[4] - st_a[4]
        dqca, dqsa = st_a[5], st_a[6]
        dqcb, dqsb = st_b[5], st_b[6]
        vax, vay, wa = st_a[0], st_a[1], st_a[2]
        vbx, vby, wb = st_b[0], st_b[1], st_b[2]
        restitution = r("restitution")
        soft_bias, soft_mass = r("soft_bias"), r("soft_mass")
        soft_imp, relaxv = r("soft_imp"), r("relax")
        total_normal = torch.zeros_like(roll)
        for j in (0, 1):
            rax, ray = r(f"ax{j}"), r(f"ay{j}")
            rbx, rby = r(f"bx{j}"), r(f"by{j}")
            mask = r(f"mask{j}")
            nmass = r(f"nmass{j}")
            vrx = (vbx - wb * rby) - (vax - wa * ray)
            vry = (vby + wb * rbx) - (vay + wa * rax)
            vn = vrx * nx + vry * ny
            rrx_a = dqca * rax - dqsa * ray
            rry_a = dqsa * rax + dqca * ray
            rrx_b = dqcb * rbx - dqsb * rby
            rry_b = dqsb * rbx + dqcb * rby
            dsx = dpx + rrx_b - rrx_a
            dsy = dpy + rry_b - rry_a
            sep = r(f"sep{j}") + dsx * nx + dsy * ny
            speculative = sep > 0.0
            bias = torch.where(
                speculative, sep * inv_h,
                bias_f * torch.maximum(soft_mass * soft_bias * sep,
                                       -contact_speed))
            mscale = torch.where(speculative, 1.0,
                                 1.0 + bias_f * (soft_mass - 1.0))
            iscale = torch.where(speculative, 0.0, bias_f * soft_imp)
            imp_s = (-nmass * (mscale * vn + bias) - iscale * ni[j]) * relaxv
            new_s = torch.clamp(ni[j] + imp_s, min=0.0) * mask
            d_s = new_s - ni[j]
            relv = r(f"relv{j}")
            apply_r = ((restitution != 0.0) & (relv < -rthresh)
                       & (tni[j] > 0.0)) * mask
            imp_r = -nmass * (vn + restitution * relv)
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

    dyn_a = (inv_ma > 0.0) | (inv_ia > 0.0)
    dyn_b = (inv_mb > 0.0) | (inv_ib > 0.0)
    vel = body[0:3]   # a view: index_add_ writes into body
    vel.index_add_(1, ia[dyn_a], dva[:, dyn_a])
    vel.index_add_(1, ib[dyn_b], dvb[:, dyn_b])
