"""Joints: preparation, the solver's row packing and the joint sweep's twin.

Torch port of box2d_tpu/joints.py `prepare_joints` (:63-122) and of the
joint half of box2d_tpu/solver_pallas.py: `pack_joint_rows` /
`unpack_joint_acc` (:1832-1943) with the row tables `_JF` / `_JA` / `NFJ`
unchanged, so a joint matrix packed by either package feeds the other, and
`joint_window`, the plain-PyTorch twin of the joint sweep `_joint_sweep`
(:681-1240) that csrc/contact_solver.cu runs on the card. The per-color XLA
functions of box2d_tpu/joints.py (`warm_start_joints_color`,
`solve_joints_color`) are the same math in lane form; the port keeps one
plain version, the twin.

`joint_window` differs from the Pallas sweep in two primitives only: the
relative angle is `torch.atan2` (the TPU kernel carries a polynomial
stand-in), and a window may mix joint types (each lane takes its own
type's branch; the TPU windows are kind-pure).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math2d as m
from .state import (JOINT_DISTANCE, JOINT_FILTER, JOINT_MOTOR, JOINT_MOUSE,
                    JOINT_PRISMATIC, JOINT_REVOLUTE, JOINT_WELD, JOINT_WHEEL,
                    WorldState)

# static-field rows of the packed joint matrix. Rows 24-27 hold
# type-resolved predicate flags (pack_joint_rows), so the sweep's per-type
# branches read plain 0/1 rows.
_JF = dict(
    inv_ma=0, inv_mb=1, inv_ia=2, inv_ib=3,
    fapx=4, fapy=5, faqc=6, faqs=7,
    fbpx=8, fbpy=9, fbqc=10, fbqs=11,
    dcx=12, dcy=13, axial_mass=14,
    sb=15, sm=16, si=17,          # spring softness (bias, mass, imp)
    ab=18, am_=19, ai=20,         # angular softness
    cb=21, cm=22, ci=23,          # constraint softness
    f_spring=24, f_motor=25, f_limit=26, f_aux=27,
    lower=28, upper=29, target=30, speed=31,
    max1=32, max2=33, max3=34, lvx=35, lvy=36, max4=37, jrelax=38,
)
NFJ = 39
# joint accumulator rows
_JA = dict(ix=0, iy=1, spring=2, motor=3, lower=4, upper=5, angular=6,
           s2x=7, s2y=8)
NAJ = 9


class JointConstraints(NamedTuple):
    color: torch.Tensor
    active: torch.Tensor
    type: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    # world-oriented frames relative to each COM (ref: RevoluteJoint.cs:88-91)
    fa_p: torch.Tensor   # (J, 2)
    fa_q: torch.Tensor
    fb_p: torch.Tensor
    fb_q: torch.Tensor
    delta_center: torch.Tensor
    inv_mass_a: torch.Tensor
    inv_mass_b: torch.Tensor
    inv_i_a: torch.Tensor
    inv_i_b: torch.Tensor
    axial_mass: torch.Tensor
    spring_soft: torch.Tensor      # (J, 3) bias/mass/impulse scales
    angular_soft: torch.Tensor
    constraint_soft: torch.Tensor
    impulse: torch.Tensor
    spring_impulse: torch.Tensor
    spring_impulse2: torch.Tensor
    motor_impulse: torch.Tensor
    lower_impulse: torch.Tensor
    upper_impulse: torch.Tensor
    angular_impulse: torch.Tensor


class JointRows(NamedTuple):
    """The joint region of the solver's layout: lanes sorted by (color,
    type); color c owns lanes [offsets[c], offsets[c + 1])."""

    idx: torch.Tensor       # (2, LJ) i32, -1 = dead lane
    data: torch.Tensor      # (NFJ, LJ) f32
    acc: torch.Tensor       # (NAJ, LJ) f32
    type: torch.Tensor      # (LJ,) i32
    offsets: torch.Tensor   # (n_colors + 1,) i32


def joint_types_present(types) -> frozenset:
    return frozenset(int(t) for t in types if int(t) >= 0)


def solvable_joint_types(joint_types) -> tuple:
    """The joint types the solver sweeps (a filter joint has no
    constraint), ascending."""
    return tuple(sorted(int(t) for t in joint_types
                        if int(t) != JOINT_FILTER))


def _safe_recip(k):
    pos = k > 0
    return torch.where(pos, 1.0 / torch.where(pos, k, 1.0), 0.0)


def prepare_joints(state: WorldState, color, h: float,
                   inv_h: float) -> JointConstraints:
    """ref: src/Joint.cs:125-129 + per-type Prepare. h and inv_h are
    float32 values held in Python floats."""
    jn = state.joints
    b = state.bodies
    ba = torch.clamp(jn.body_a, min=0)
    bb = torch.clamp(jn.body_b, min=0)
    la, lb = ba.long(), bb.long()
    active = jn.enabled & (jn.body_a >= 0) & (jn.type >= 0)

    rot_a = b.rot[la]
    rot_b = b.rot[lb]
    fa_q = m.rot_mul(rot_a, jn.frame_a_q)
    fa_p = m.rot_vec(rot_a, jn.frame_a_p - b.local_center[la])
    fb_q = m.rot_mul(rot_b, jn.frame_b_q)
    fb_p = m.rot_vec(rot_b, jn.frame_b_p - b.local_center[lb])
    delta_center = b.center[lb] - b.center[la]

    ma, mb = b.inv_mass[la], b.inv_mass[lb]
    ia, ib = b.inv_inertia[la], b.inv_inertia[lb]

    axial_ang = _safe_recip(ia + ib)
    sep = fb_p - fa_p + delta_center
    axis = m.normalize(sep)
    cr_a = m.cross(fa_p, axis)
    cr_b = m.cross(fb_p, axis)
    k_dist = ma + mb + ia * cr_a ** 2 + ib * cr_b ** 2
    axial_mass = torch.where(jn.type == JOINT_DISTANCE, _safe_recip(k_dist),
                             axial_ang)

    spring_soft = torch.stack(m.softness(jn.hertz, jn.damping_ratio, h),
                              dim=-1)
    c_hertz = torch.clamp(jn.constraint_hertz, max=0.25 * inv_h)
    constraint_soft = torch.stack(
        m.softness(c_hertz, jn.constraint_damping_ratio, h), dim=-1)
    ang_soft = torch.stack(
        m.softness(jn.angular_hertz, jn.angular_damping_ratio, h), dim=-1)
    is_weld = jn.type == JOINT_WELD
    spring_soft = torch.where((is_weld & (jn.hertz == 0.0))[:, None],
                              constraint_soft, spring_soft)
    ang_soft = torch.where((is_weld & (jn.angular_hertz == 0.0))[:, None],
                           constraint_soft, ang_soft)

    warm = torch.where(state.tuning.enable_warm_starting, 1.0, 0.0)
    return JointConstraints(
        color=color, active=active, type=jn.type, body_a=ba, body_b=bb,
        fa_p=fa_p, fa_q=fa_q, fb_p=fb_p, fb_q=fb_q, delta_center=delta_center,
        inv_mass_a=ma, inv_mass_b=mb, inv_i_a=ia, inv_i_b=ib,
        axial_mass=axial_mass, spring_soft=spring_soft, angular_soft=ang_soft,
        constraint_soft=constraint_soft,
        impulse=warm * jn.impulse,
        spring_impulse=warm * jn.spring_impulse,
        spring_impulse2=warm * jn.spring_impulse2,
        motor_impulse=warm * jn.motor_impulse,
        lower_impulse=warm * jn.lower_impulse,
        upper_impulse=warm * jn.upper_impulse,
        angular_impulse=warm * jn.angular_impulse,
    )


def pack_joint_rows(jn, jc: JointConstraints):
    """Joints state + prepared JointConstraints -> ((J, NFJ) data, (J, NAJ)
    acc, (J, 2) idx) in joint-lane order, columns per _JF / _JA. The
    per-type predicate flags are resolved here; dead lanes (color < 0) get
    zero inverse masses and index -1."""
    ty = jn.type
    f1 = lambda c: c.float()
    fixed_rot = (jc.inv_i_a + jc.inv_i_b) == 0.0
    spring_mode_d = jn.enable_spring & ((jn.lower < jn.upper)
                                        | ~jn.enable_limit)
    z = torch.zeros_like(jn.hertz)

    def bytype(dist, mot, pris, rev, weld, wheel, mouse=None):
        out = torch.where(ty == JOINT_DISTANCE, dist,
              torch.where(ty == JOINT_MOTOR, mot,
              torch.where(ty == JOINT_PRISMATIC, pris,
              torch.where(ty == JOINT_REVOLUTE, rev,
              torch.where(ty == JOINT_WELD, weld,
              torch.where(ty == JOINT_WHEEL, wheel, z))))))
        if mouse is not None:
            out = torch.where(ty == JOINT_MOUSE, mouse, out)
        return out

    f_spring = bytype(
        f1(spring_mode_d),
        f1((jn.max_spring_torque > 0.0) & (jn.angular_hertz > 0.0)),
        f1(jn.enable_spring),
        f1(jn.enable_spring & ~fixed_rot),
        f1(jn.hertz > 0.0),
        f1(jn.enable_spring))
    f_motor = bytype(
        f1(spring_mode_d & jn.enable_motor),
        f1(jn.max_velocity_torque > 0.0),
        f1(jn.enable_motor),
        f1(jn.enable_motor & ~fixed_rot),
        f1(jn.angular_hertz > 0.0),
        f1(jn.enable_motor & ~fixed_rot))
    f_limit = bytype(
        f1(spring_mode_d & jn.enable_limit),
        f1((jn.max_spring_force > 0.0) & (jn.hertz > 0.0)),
        f1(jn.enable_limit),
        f1(jn.enable_limit & ~fixed_rot),
        z,
        f1(jn.enable_limit))
    f_aux = bytype(f1(jn.hertz > 0.0), f1(jn.max_velocity_force > 0.0),
                   z, z, z, z)
    target = bytype(jn.length, z, jn.spring_target, jn.spring_target, z, z)
    speed = bytype(jn.motor_speed, jn.angular_velocity, jn.motor_speed,
                   jn.motor_speed, z, jn.motor_speed)
    max1 = bytype(jn.max_motor_force, jn.max_velocity_torque,
                  jn.max_motor_force, jn.max_motor_force, z,
                  jn.max_motor_force, mouse=jn.max_velocity_force)
    max2 = bytype(jn.lower_spring_force, jn.max_spring_torque, z, z, z, z)
    max3 = bytype(jn.upper_spring_force, jn.max_spring_force, z, z, z, z)
    max4 = bytype(z, jn.max_velocity_force, z, z, z, z)

    live = jc.color >= 0
    livef = live.float()
    data = torch.stack([
        jc.inv_mass_a * livef, jc.inv_mass_b * livef,
        jc.inv_i_a * livef, jc.inv_i_b * livef,
        jc.fa_p[:, 0], jc.fa_p[:, 1], jc.fa_q[:, 0], jc.fa_q[:, 1],
        jc.fb_p[:, 0], jc.fb_p[:, 1], jc.fb_q[:, 0], jc.fb_q[:, 1],
        jc.delta_center[:, 0], jc.delta_center[:, 1], jc.axial_mass,
        jc.spring_soft[:, 0], jc.spring_soft[:, 1], jc.spring_soft[:, 2],
        jc.angular_soft[:, 0], jc.angular_soft[:, 1], jc.angular_soft[:, 2],
        jc.constraint_soft[:, 0], jc.constraint_soft[:, 1],
        jc.constraint_soft[:, 2],
        f_spring, f_motor, f_limit, f_aux,
        jn.lower, jn.upper, target, speed,
        max1, max2, max3,
        jn.linear_velocity[:, 0], jn.linear_velocity[:, 1], max4,
        torch.ones_like(z),   # jrelax (reserved for overflow mass-splitting)
    ], dim=1)
    acc = torch.stack([
        jc.impulse[:, 0], jc.impulse[:, 1],
        jc.spring_impulse, jc.motor_impulse,
        jc.lower_impulse, jc.upper_impulse, jc.angular_impulse,
        jc.spring_impulse2[:, 0], jc.spring_impulse2[:, 1],
    ], dim=1)
    idx = torch.stack([torch.where(live, jc.body_a, -1),
                       torch.where(live, jc.body_b, -1)], dim=1)
    return data, acc, idx.to(torch.int32)


def unpack_joint_acc(jc: JointConstraints, jacc, active) -> JointConstraints:
    """Write solved joint accumulators (J, NAJ) back into JointConstraints."""
    def sel(new, old):
        mask = active[:, None] if old.dim() == 2 else active
        return torch.where(mask, new, old)

    return jc._replace(
        impulse=sel(jacc[:, 0:2], jc.impulse),
        spring_impulse=sel(jacc[:, _JA["spring"]], jc.spring_impulse),
        motor_impulse=sel(jacc[:, _JA["motor"]], jc.motor_impulse),
        lower_impulse=sel(jacc[:, _JA["lower"]], jc.lower_impulse),
        upper_impulse=sel(jacc[:, _JA["upper"]], jc.upper_impulse),
        angular_impulse=sel(jacc[:, _JA["angular"]], jc.angular_impulse),
        spring_impulse2=sel(jacc[:, _JA["s2x"]:_JA["s2y"] + 1],
                            jc.spring_impulse2),
    )


def layout_joint_rows(jn, jc: JointConstraints, n_colors: int):
    """Sort the packed joint rows into the solver's joint region: live lanes
    first, by (color, type), so that each color is one contiguous segment
    and each warp of a segment mostly runs one type's branch. Returns
    (JointRows, jpos) where jpos (J,) is each joint's lane."""
    data, acc, idx = pack_joint_rows(jn, jc)
    J = idx.shape[0]
    dev = idx.device
    live = jc.color >= 0
    key = torch.where(live, jc.color.long() * 8 + jn.type.long(),
                      n_colors * 8 + 8)
    skey, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_colors + 1, device=dev) * 8
    offsets = torch.searchsorted(skey, bounds).to(torch.int32)
    jpos = torch.empty(J, dtype=torch.int64, device=dev)
    jpos[order] = torch.arange(J, device=dev)
    rows = JointRows(idx=idx[order].T.contiguous(),
                     data=data[order].T.contiguous(),
                     acc=acc[order].T.contiguous(),
                     type=jn.type[order].to(torch.int32).contiguous(),
                     offsets=offsets)
    return rows, jpos


# ---------------------------------------------------------------------------
# plain PyTorch twin of the joint sweep
# ---------------------------------------------------------------------------

def _unwind(angle):
    """Map angle into [-pi, pi) (floor-based, as the TPU kernel does)."""
    two_pi = 6.283185307179586
    x = (angle + 3.141592653589793) / two_pi
    return (x - torch.floor(x)) * two_pi - 3.141592653589793


def _recip_pos(k):
    return torch.where(k > 0.0, 1.0 / torch.where(k > 0.0, k, 1.0), 0.0)


def _recip_nz(k):
    return torch.where(k != 0.0, 1.0 / torch.where(k != 0.0, k, 1.0), 0.0)


def joint_lanes(jtype: int, p: int, d, a, st_a, st_b, h, inv_h):
    """One sweep of stage p (0 warm start, 1 solve with bias, 2 relax) over
    n joint lanes of one type: d (NFJ, n) rows, a (NAJ, n) accumulators,
    st_a / st_b (8, n) the gathered body rows of both endpoints. Returns
    (dva (3, n), dvb (3, n), acc_new (NAJ, n)). Operation by operation the
    arithmetic of solver_pallas._joint_sweep."""
    R = lambda name: d[_JF[name]]
    bias_f = 1.0 if p == 1 else 0.0
    warm = p == 0

    ma, mb = R("inv_ma"), R("inv_mb")
    ia, ib = R("inv_ia"), R("inv_ib")
    vax0, vay0, wa0 = st_a[0], st_a[1], st_a[2]
    vbx0, vby0, wb0 = st_b[0], st_b[1], st_b[2]
    dpax, dpay = st_a[3], st_a[4]
    dpbx, dpby = st_b[3], st_b[4]
    dqca, dqsa = st_a[5], st_a[6]
    dqcb, dqsb = st_b[5], st_b[6]

    def rotv(qc, qs, x, y):
        return qc * x - qs * y, qs * x + qc * y

    def cross(ax_, ay_, bx_, by_):
        return ax_ * by_ - ay_ * bx_

    rax, ray = rotv(dqca, dqsa, R("fapx"), R("fapy"))
    rbx, rby = rotv(dqcb, dqsb, R("fbpx"), R("fbpy"))
    dx = dpbx - dpax + R("dcx") + rbx - rax
    dy = dpby - dpay + R("dcy") + rby - ray

    axial = R("axial_mass")
    acc = {k: a[v] for k, v in _JA.items()}
    imp_x, imp_y = acc["ix"], acc["iy"]
    spr_i, mot_i = acc["spring"], acc["motor"]
    low_i, up_i, ang_i = acc["lower"], acc["upper"], acc["angular"]
    s2x, s2y = acc["s2x"], acc["s2y"]

    qac, qas = rotv(dqca, dqsa, R("faqc"), R("faqs"))
    qbc, qbs = rotv(dqcb, dqsb, R("fbqc"), R("fbqs"))
    relc = qac * qbc + qas * qbs
    rels = qac * qbs - qas * qbc

    def soft_limit(c, cdot, mass, old):
        bias = torch.where(c > 0.0, c * inv_h, bias_f * R("cb") * c)
        msc = torch.where(c > 0.0, 1.0, 1.0 + bias_f * (R("cm") - 1.0))
        isc = torch.where(c > 0.0, 0.0, bias_f * R("ci"))
        impulse = -msc * mass * (cdot + bias) - isc * old
        new = torch.clamp(old + impulse, min=0.0)
        return new, new - old

    st = {"vax": vax0, "vay": vay0, "wa": wa0,
          "vbx": vbx0, "vby": vby0, "wb": wb0}

    def apply_lin(px, py, la, lb):
        st["vax"] = st["vax"] - ma * px
        st["vay"] = st["vay"] - ma * py
        st["wa"] = st["wa"] - ia * la
        st["vbx"] = st["vbx"] + mb * px
        st["vby"] = st["vby"] + mb * py
        st["wb"] = st["wb"] + ib * lb

    def apply_ang(l):
        st["wa"] = st["wa"] - ia * l
        st["wb"] = st["wb"] + ib * l

    def vr_dot(ux, uy):
        vrx = (st["vbx"] - st["wb"] * rby) - (st["vax"] - st["wa"] * ray)
        vry = (st["vby"] + st["wb"] * rbx) - (st["vay"] + st["wa"] * rax)
        return vrx * ux + vry * uy

    def point_rel():
        cdx = (st["vbx"] - st["wb"] * rby) - (st["vax"] - st["wa"] * ray)
        cdy = (st["vby"] + st["wb"] * rbx) - (st["vay"] + st["wa"] * rax)
        return cdx, cdy

    def k_point():
        k11 = ma + mb + ray * ray * ia + rby * rby * ib
        k12 = -ray * rax * ia - rby * rbx * ib
        k22 = ma + mb + rax * rax * ia + rbx * rbx * ib
        return k11, k12, k22, _recip_nz(k11 * k22 - k12 * k12)

    def clamp(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def gate(flag, new, old):
        return torch.where(flag > 0, new, old)

    def cap_length(nx_, ny_, max_i, need_pos=False):
        ln = torch.sqrt(nx_ * nx_ + ny_ * ny_)
        over = ln > max_i
        if need_pos:
            over = over & (max_i > 0)
        scale = torch.where(over, max_i / torch.where(ln > 0.0, ln, 1.0),
                            1.0)
        return nx_ * scale, ny_ * scale

    if jtype == JOINT_DISTANCE:
        ln = torch.sqrt(dx * dx + dy * dy)
        inv = _recip_pos(ln)
        axx, axy = dx * inv, dy * inv

        def axial_impulse(di):
            px, py = di * axx, di * axy
            apply_lin(px, py, cross(rax, ray, px, py),
                      cross(rbx, rby, px, py))

        if warm:
            axial_impulse(imp_x + low_i - up_i + mot_i)
        else:
            cdot = vr_dot(axx, axy)
            c = ln - R("target")
            bias = bias_f * R("cb") * c
            msc = 1.0 + bias_f * (R("cm") - 1.0)
            isc = bias_f * R("ci")
            dimp_r = -msc * axial * (cdot + bias) - isc * imp_x
            dimp_s = (-R("sm") * axial * (cdot + R("sb") * c)
                      - R("si") * imp_x) * R("f_aux")
            imp_spring = clamp(imp_x + dimp_s, R("max2") * h, R("max3") * h)
            dimp = torch.where(R("f_spring") > 0, imp_spring - imp_x, dimp_r)
            acc["ix"] = imp_x + dimp
            axial_impulse(dimp)

            lim = R("f_limit")
            new_low, dlow = soft_limit(ln - R("lower"), vr_dot(axx, axy),
                                       axial, low_i)
            dlow = dlow * lim
            acc["lower"] = gate(lim, new_low, low_i)
            axial_impulse(dlow)
            new_up, dup = soft_limit(R("upper") - ln, -vr_dot(axx, axy),
                                     axial, up_i)
            dup = dup * lim
            acc["upper"] = gate(lim, new_up, up_i)
            axial_impulse(-dup)

            mot = R("f_motor")
            dimp_m = axial * (R("speed") - vr_dot(axx, axy))
            max_i = h * R("max1")
            new_mot = clamp(mot_i + dimp_m, -max_i, max_i)
            dimp_m = (new_mot - mot_i) * mot
            acc["motor"] = gate(mot, new_mot, mot_i)
            axial_impulse(dimp_m)

    elif jtype == JOINT_REVOLUTE:
        if warm:
            axl = spr_i + mot_i + low_i - up_i
            apply_lin(imp_x, imp_y, cross(rax, ray, imp_x, imp_y) + axl,
                      cross(rbx, rby, imp_x, imp_y) + axl)
        else:
            rel_angle = torch.atan2(rels, relc)
            spr = R("f_spring")
            cspr = _unwind(rel_angle - R("target"))
            dimp = (-R("sm") * axial * ((st["wb"] - st["wa"])
                                        + R("sb") * cspr)
                    - R("si") * spr_i) * spr
            acc["spring"] = spr_i + dimp
            apply_ang(dimp)

            mot = R("f_motor")
            dimp = -axial * (st["wb"] - st["wa"] - R("speed"))
            max_i = h * R("max1")
            new_mot = clamp(mot_i + dimp, -max_i, max_i)
            dimp = (new_mot - mot_i) * mot
            acc["motor"] = gate(mot, new_mot, mot_i)
            apply_ang(dimp)

            lim = R("f_limit")
            new_low, dlow = soft_limit(rel_angle - R("lower"),
                                       st["wb"] - st["wa"], axial, low_i)
            dlow = dlow * lim
            acc["lower"] = gate(lim, new_low, low_i)
            apply_ang(dlow)
            new_up, dup = soft_limit(R("upper") - rel_angle,
                                     st["wa"] - st["wb"], axial, up_i)
            dup = dup * lim
            acc["upper"] = gate(lim, new_up, up_i)
            apply_ang(-dup)

            cdx, cdy = point_rel()
            sepx = dpbx - dpax + (rbx - rax) + R("dcx")
            sepy = dpby - dpay + (rby - ray) + R("dcy")
            bx_ = cdx + bias_f * R("cb") * sepx
            by_ = cdy + bias_f * R("cb") * sepy
            msc = 1.0 + bias_f * (R("cm") - 1.0)
            isc = bias_f * R("ci")
            k11, k12, k22, invd = k_point()
            sx = invd * (k22 * bx_ - k12 * by_)
            sy = invd * (k11 * by_ - k12 * bx_)
            dix = -msc * sx - isc * imp_x
            diy = -msc * sy - isc * imp_y
            acc["ix"] = imp_x + dix
            acc["iy"] = imp_y + diy
            apply_lin(dix, diy, cross(rax, ray, dix, diy),
                      cross(rbx, rby, dix, diy))

    elif jtype == JOINT_WELD:
        if warm:
            apply_lin(imp_x, imp_y, cross(rax, ray, imp_x, imp_y) + ang_i,
                      cross(rbx, rby, imp_x, imp_y) + ang_i)
        else:
            rel_angle = torch.atan2(rels, relc)
            ang_on = torch.clamp(bias_f + R("f_motor"), max=1.0)
            bias = ang_on * R("ab") * rel_angle
            msc = 1.0 + ang_on * (R("am_") - 1.0)
            isc = ang_on * R("ai")
            dimp = -msc * axial * (st["wb"] - st["wa"] + bias) - isc * ang_i
            acc["angular"] = ang_i + dimp
            apply_ang(dimp)
            lin_on = torch.clamp(bias_f + R("f_spring"), max=1.0)
            sepx = dpbx - dpax + (rbx - rax) + R("dcx")
            sepy = dpby - dpay + (rby - ray) + R("dcy")
            cdx, cdy = point_rel()
            bx_ = cdx + lin_on * R("sb") * sepx
            by_ = cdy + lin_on * R("sb") * sepy
            mscl = 1.0 + lin_on * (R("sm") - 1.0)
            iscl = lin_on * R("si")
            k11, k12, k22, invd = k_point()
            sx = invd * (k22 * bx_ - k12 * by_)
            sy = invd * (k11 * by_ - k12 * bx_)
            dix = -mscl * sx - iscl * imp_x
            diy = -mscl * sy - iscl * imp_y
            acc["ix"] = imp_x + dix
            acc["iy"] = imp_y + diy
            apply_lin(dix, diy, cross(rax, ray, dix, diy),
                      cross(rbx, rby, dix, diy))

    elif jtype == JOINT_MOTOR:
        if warm:
            px, py = imp_x + s2x, imp_y + s2y
            am2 = ang_i + spr_i
            apply_lin(px, py, cross(rax, ray, px, py) + am2,
                      cross(rbx, rby, px, py) + am2)
        else:
            rel_angle = torch.atan2(rels, relc)
            aspr = R("f_spring")
            dimp = (-R("am_") * axial
                    * (st["wb"] - st["wa"] + R("ab") * rel_angle)
                    - R("ai") * spr_i)
            max_i = h * R("max2")
            new_aspr = clamp(spr_i + dimp, -max_i, max_i)
            dimp = (new_aspr - spr_i) * aspr
            acc["spring"] = gate(aspr, new_aspr, spr_i)
            apply_ang(dimp)
            avel = R("f_motor")
            dimp = -axial * (st["wb"] - st["wa"] - R("speed"))
            max_i = h * R("max1")
            new_avel = clamp(ang_i + dimp, -max_i, max_i)
            dimp = (new_avel - ang_i) * avel
            acc["angular"] = gate(avel, new_avel, ang_i)
            apply_ang(dimp)

            k11, k12, k22, invd = k_point()

            def solve22(bx_, by_):
                return (invd * (k22 * bx_ - k12 * by_),
                        invd * (k11 * by_ - k12 * bx_))

            lspr = R("f_limit")
            sepx = dpbx - dpax + (rbx - rax) + R("dcx")
            sepy = dpby - dpay + (rby - ray) + R("dcy")
            cdx, cdy = point_rel()
            sx, sy = solve22(cdx + R("sb") * sepx, cdy + R("sb") * sepy)
            dix = -R("sm") * sx - R("si") * s2x
            diy = -R("sm") * sy - R("si") * s2y
            nx_, ny_ = cap_length(s2x + dix, s2y + diy, h * R("max3"))
            dix = (nx_ - s2x) * lspr
            diy = (ny_ - s2y) * lspr
            acc["s2x"] = gate(lspr, nx_, s2x)
            acc["s2y"] = gate(lspr, ny_, s2y)
            apply_lin(dix, diy, cross(rax, ray, dix, diy),
                      cross(rbx, rby, dix, diy))

            lvel = R("f_aux")
            cdx, cdy = point_rel()
            sx, sy = solve22(cdx - R("lvx"), cdy - R("lvy"))
            nx_, ny_ = cap_length(imp_x - sx, imp_y - sy, h * R("max4"))
            dix = (nx_ - imp_x) * lvel
            diy = (ny_ - imp_y) * lvel
            acc["ix"] = gate(lvel, nx_, imp_x)
            acc["iy"] = gate(lvel, ny_, imp_y)
            apply_lin(dix, diy, cross(rax, ray, dix, diy),
                      cross(rbx, rby, dix, diy))

    elif jtype in (JOINT_PRISMATIC, JOINT_WHEEL):
        axx, axy = qac, qas
        perpx, perpy = -axy, axx
        a1 = cross(rax + dx, ray + dy, axx, axy)
        a2 = cross(rbx, rby, axx, axy)
        s1 = cross(rax + dx, ray + dy, perpx, perpy)
        s2 = cross(rbx, rby, perpx, perpy)
        translation = axx * dx + axy * dy
        ax_mass = _recip_pos(ma + mb + ia * a1 * a1 + ib * a2 * a2)

        def adot():
            base = (axx * (st["vbx"] - st["vax"])
                    + axy * (st["vby"] - st["vay"]))
            return base + a2 * st["wb"] - a1 * st["wa"]

        def apply_axial(di):
            px, py = di * axx, di * axy
            st["vax"] = st["vax"] - ma * px
            st["vay"] = st["vay"] - ma * py
            st["wa"] = st["wa"] - ia * di * a1
            st["vbx"] = st["vbx"] + mb * px
            st["vby"] = st["vby"] + mb * py
            st["wb"] = st["wb"] + ib * di * a2

        def limits():
            lim = R("f_limit")
            new_low, dlow = soft_limit(translation - R("lower"), adot(),
                                       ax_mass, low_i)
            dlow = dlow * lim
            acc["lower"] = gate(lim, new_low, low_i)
            apply_axial(dlow)
            new_up, dup = soft_limit(R("upper") - translation, -adot(),
                                     ax_mass, up_i)
            dup = dup * lim
            acc["upper"] = gate(lim, new_up, up_i)
            apply_axial(-dup)

        def perp_dot():
            return (perpx * (st["vbx"] - st["vax"])
                    + perpy * (st["vby"] - st["vay"])
                    + s2 * st["wb"] - s1 * st["wa"])

        if jtype == JOINT_PRISMATIC:
            if warm:
                axl = spr_i + mot_i + low_i - up_i
                px = axl * axx + imp_x * perpx
                py = axl * axy + imp_x * perpy
                la = axl * a1 + imp_x * s1 + imp_y
                lb = axl * a2 + imp_x * s2 + imp_y
                apply_lin(px, py, la, lb)
            else:
                rel_angle = torch.atan2(rels, relc)
                spr = R("f_spring")
                cspr = translation - R("target")
                dimp = (-R("sm") * ax_mass * (adot() + R("sb") * cspr)
                        - R("si") * spr_i) * spr
                acc["spring"] = spr_i + dimp
                apply_axial(dimp)
                mot = R("f_motor")
                dimp = ax_mass * (R("speed") - adot())
                max_i = h * R("max1")
                new_mot = clamp(mot_i + dimp, -max_i, max_i)
                dimp = (new_mot - mot_i) * mot
                acc["motor"] = gate(mot, new_mot, mot_i)
                apply_axial(dimp)
                limits()
                cdot1 = perp_dot()
                cdot2 = st["wb"] - st["wa"]
                bias1 = bias_f * R("cb") * (perpx * dx + perpy * dy)
                bias2 = bias_f * R("cb") * rel_angle
                msc = 1.0 + bias_f * (R("cm") - 1.0)
                isc = bias_f * R("ci")
                k11 = ma + mb + ia * s1 * s1 + ib * s2 * s2
                k12 = ia * s1 + ib * s2
                k22 = ia + ib
                k22 = torch.where(k22 == 0.0, 1.0, k22)
                invd = _recip_nz(k11 * k22 - k12 * k12)
                bx_ = cdot1 + bias1
                by_ = cdot2 + bias2
                sx = invd * (k22 * bx_ - k12 * by_)
                sy = invd * (k11 * by_ - k12 * bx_)
                dix = -msc * sx - isc * imp_x
                diy = -msc * sy - isc * imp_y
                acc["ix"] = imp_x + dix
                acc["iy"] = imp_y + diy
                apply_lin(dix * perpx, dix * perpy, dix * s1 + diy,
                          dix * s2 + diy)
        else:  # JOINT_WHEEL
            if warm:
                axl = spr_i + low_i - up_i
                px = axl * axx + imp_x * perpx
                py = axl * axy + imp_x * perpy
                la = axl * a1 + imp_x * s1 + mot_i
                lb = axl * a2 + imp_x * s2 + mot_i
                apply_lin(px, py, la, lb)
            else:
                motor_mass = _recip_pos(ia + ib)
                perp_mass = _recip_pos(ma + mb + ia * s1 * s1 + ib * s2 * s2)
                mot = R("f_motor")
                dimp = -motor_mass * (st["wb"] - st["wa"] - R("speed"))
                max_i = h * R("max1")
                new_mot = clamp(mot_i + dimp, -max_i, max_i)
                dimp = (new_mot - mot_i) * mot
                acc["motor"] = gate(mot, new_mot, mot_i)
                apply_ang(dimp)
                spr = R("f_spring")
                dimp = (-R("sm") * ax_mass
                        * (adot() + R("sb") * translation)
                        - R("si") * spr_i) * spr
                acc["spring"] = spr_i + dimp
                apply_axial(dimp)
                limits()
                cdot = perp_dot()
                bias = bias_f * R("cb") * (perpx * dx + perpy * dy)
                msc = 1.0 + bias_f * (R("cm") - 1.0)
                isc = bias_f * R("ci")
                dimp = -msc * perp_mass * (cdot + bias) - isc * imp_x
                acc["ix"] = imp_x + dimp
                apply_lin(dimp * perpx, dimp * perpy, dimp * s1, dimp * s2)

    elif jtype == JOINT_MOUSE:
        if warm:
            apply_lin(imp_x, imp_y, torch.zeros_like(imp_x),
                      cross(rbx, rby, imp_x, imp_y))
        else:
            cx = R("dcx") - R("fapx") + rbx + dpbx
            cy = R("dcy") - R("fapy") + rby + dpby
            cdx = st["vbx"] - st["wb"] * rby + R("sb") * cx
            cdy = st["vby"] + st["wb"] * rbx + R("sb") * cy
            k11 = mb + rby * rby * ib
            k12 = -rby * rbx * ib
            k22 = mb + rbx * rbx * ib
            invd = _recip_nz(k11 * k22 - k12 * k12)
            sx = invd * (k22 * cdx - k12 * cdy)
            sy = invd * (k11 * cdy - k12 * cdx)
            dix = -R("sm") * sx - R("si") * imp_x
            diy = -R("sm") * sy - R("si") * imp_y
            nx_, ny_ = cap_length(imp_x + dix, imp_y + diy, h * R("max1"),
                                  need_pos=True)
            acc["ix"] = nx_
            acc["iy"] = ny_
            dix, diy = nx_ - imp_x, ny_ - imp_y
            st["vbx"] = st["vbx"] + mb * dix
            st["vby"] = st["vby"] + mb * diy
            st["wb"] = st["wb"] + ib * cross(rbx, rby, dix, diy)
    else:
        raise ValueError(f"joint type {jtype} has no sweep")

    dva = torch.stack([st["vax"] - vax0, st["vay"] - vay0, st["wa"] - wa0])
    dvb = torch.stack([st["vbx"] - vbx0, st["vby"] - vby0, st["wb"] - wb0])
    acc_new = torch.stack([acc[k] for k in _JA])
    return dva, dvb, acc_new


def joint_window(body, jr: JointRows, jacc, lanes, p: int, h, inv_h):
    """One Jacobi window of stage p over the live joint `lanes` (any mix of
    types): every lane reads the body state at the window's start, then the
    velocity deltas of dynamic endpoints are summed in. Updates `body` and
    `jacc` in place."""
    ia = jr.idx[0, lanes].long()
    ib = jr.idx[1, lanes].long()
    st_a = body[:, ia]
    st_b = body[:, ib]
    d = jr.data[:, lanes]
    a = jacc[:, lanes]
    ty = jr.type[lanes]
    dva = torch.zeros_like(st_a[0:3])
    dvb = torch.zeros_like(dva)
    acc_new = a.clone()
    for t in torch.unique(ty).tolist():
        sel = torch.nonzero(ty == t).squeeze(1)
        va, vb, an = joint_lanes(t, p, d[:, sel], a[:, sel], st_a[:, sel],
                                 st_b[:, sel], h, inv_h)
        dva[:, sel] = va
        dvb[:, sel] = vb
        acc_new[:, sel] = an
    jacc[:, lanes] = acc_new
    dyn_a = (d[_JF["inv_ma"]] > 0.0) | (d[_JF["inv_ia"]] > 0.0)
    dyn_b = (d[_JF["inv_mb"]] > 0.0) | (d[_JF["inv_ib"]] > 0.0)
    vel = body[0:3]   # a view: index_add_ writes into body
    vel.index_add_(1, ia[dyn_a], dva[:, dyn_a])
    vel.index_add_(1, ib[dyn_b], dvb[:, dyn_b])
