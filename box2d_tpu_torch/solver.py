"""Contact preparation, body finalization and the kernel's packers.

Torch port of box2d_tpu/solver.py (`prepare_contacts` :82,
`finalize_bodies` :439) and of the packers in box2d_tpu/solver_pallas.py
that feed the contact solver kernel (`pack_constraints_pairs` :494,
`pack_bodies` / `unpack_bodies` :548-583, the unshifted mode-1 layout).
The per-color solve itself is contact_solver.py.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import math2d as m
from .constants import MAX_ROTATION
from .contact_solver import NA
from .narrowphase import ContactData
from .state import (ALLOW_FAST_ROTATION, DYNAMIC, ENABLE_SLEEP,
                    LOCK_ANGULAR_Z, LOCK_LINEAR_X, LOCK_LINEAR_Y, STATIC,
                    WorldState)


class BodySolverState(NamedTuple):
    v: torch.Tensor   # (Nb, 2)
    w: torch.Tensor   # (Nb,)
    dp: torch.Tensor  # (Nb, 2) delta position this step
    dq: torch.Tensor  # (Nb, 2) delta rotation this step (cos, sin)


class ContactConstraints(NamedTuple):
    """Prepared contact constraints, (P,) lanes with 2 points each."""

    body_a: torch.Tensor
    body_b: torch.Tensor
    normal: torch.Tensor
    friction: torch.Tensor
    restitution: torch.Tensor
    tangent_speed: torch.Tensor
    rolling_resistance: torch.Tensor
    rolling_mass: torch.Tensor
    soft_bias: torch.Tensor
    soft_mass: torch.Tensor
    soft_imp: torch.Tensor
    anchor_a: torch.Tensor
    anchor_b: torch.Tensor
    base_separation: torch.Tensor
    normal_mass: torch.Tensor
    tangent_mass: torch.Tensor
    relative_velocity: torch.Tensor
    point_mask: torch.Tensor
    inv_mass_a: torch.Tensor
    inv_mass_b: torch.Tensor
    inv_i_a: torch.Tensor
    inv_i_b: torch.Tensor
    color: torch.Tensor
    normal_impulse: torch.Tensor
    tangent_impulse: torch.Tensor
    total_normal_impulse: torch.Tensor
    rolling_impulse: torch.Tensor


def _safe_recip(k):
    pos = k > 0
    return torch.where(pos, 1.0 / torch.where(pos, k, 1.0), 0.0)


def prepare_contacts(state: WorldState, data: ContactData, color, h: float,
                     inv_h: float) -> ContactConstraints:
    """ref: src/ContactSolver.cs:40-115. Body operands come from the narrow
    phase's packed rows (data.dyn_a/dyn_b). h and inv_h are float32 values
    held in Python floats. The tuning's contact fields are 0-d, or one per
    pair lane (a flat batch of worlds, batch.py)."""
    tn = state.tuning
    man = data.manifold
    da, db = data.dyn_a, data.dyn_b

    contact_hertz = torch.clamp(tn.contact_hertz, max=0.125 * inv_h)
    soft_c = m.softness(contact_hertz, tn.contact_damping_ratio, h)
    soft_s = m.softness(2.0 * contact_hertz, tn.contact_damping_ratio, h)

    ma, mb = da[:, 9], db[:, 9]
    ia, ib = da[:, 10], db[:, 10]
    is_static = (da[:, 11] != DYNAMIC) | (db[:, 11] != DYNAMIC)
    soft_bias = torch.where(is_static, soft_s[0], soft_c[0])
    soft_mass = torch.where(is_static, soft_s[1], soft_c[1])
    soft_imp = torch.where(is_static, soft_s[2], soft_c[2])

    inv_lo = torch.minimum(ma, mb)
    inv_hi = torch.maximum(ma, mb)
    ratio = torch.where(inv_lo == inv_hi, 1.0,
                        torch.clamp(inv_lo / torch.where(inv_hi > 0, inv_hi,
                                                         1.0), min=0.5))
    soft_r = m.softness(ratio * contact_hertz,
                        ratio * tn.contact_damping_ratio, h)
    softened = tn.enable_contact_softening & ~is_static
    soft_bias = torch.where(softened, soft_r[0], soft_bias)
    soft_mass = torch.where(softened, soft_r[1], soft_mass)
    soft_imp = torch.where(softened, soft_r[2], soft_imp)

    rolling_mass = _safe_recip(ia + ib)
    normal = man.normal
    tangent = m.right_perp(normal)
    va, wa = da[:, 6:8], da[:, 8]
    vb, wb = db[:, 6:8], db[:, 8]

    ra = man.anchor_a
    rb = man.anchor_b
    nrm = normal[:, None, :]
    base_sep = man.separation - m.dot(rb - ra, nrm)
    rn_a = m.cross(ra, nrm)
    rn_b = m.cross(rb, nrm)
    k_n = ((ma + mb)[:, None] + ia[:, None] * (rn_a * rn_a)
           + ib[:, None] * (rn_b * rn_b))
    rt_a = m.cross(ra, tangent[:, None, :])
    rt_b = m.cross(rb, tangent[:, None, :])
    k_t = ((ma + mb)[:, None] + ia[:, None] * (rt_a * rt_a)
           + ib[:, None] * (rt_b * rt_b))
    vr_a = va[:, None, :] + m.cross_sv(wa[:, None], ra)
    vr_b = vb[:, None, :] + m.cross_sv(wb[:, None], rb)
    rel_v = m.dot(nrm, vr_b - vr_a)

    warm = torch.where(tn.enable_warm_starting, 1.0, 0.0)
    warm2 = warm[..., None]
    lane = torch.arange(2, device=normal.device)[None, :]
    point_mask = lane < man.point_count[:, None]
    return ContactConstraints(
        body_a=data.body_a, body_b=data.body_b, normal=normal,
        friction=data.friction, restitution=data.restitution,
        tangent_speed=data.tangent_speed,
        rolling_resistance=data.rolling_resistance, rolling_mass=rolling_mass,
        soft_bias=soft_bias, soft_mass=soft_mass, soft_imp=soft_imp,
        anchor_a=ra, anchor_b=rb, base_separation=base_sep,
        normal_mass=_safe_recip(k_n), tangent_mass=_safe_recip(k_t),
        relative_velocity=rel_v, point_mask=point_mask,
        inv_mass_a=ma, inv_mass_b=mb, inv_i_a=ia, inv_i_b=ib, color=color,
        normal_impulse=warm2 * data.normal_impulse * point_mask,
        tangent_impulse=warm2 * data.tangent_impulse * point_mask,
        total_normal_impulse=torch.zeros_like(data.normal_impulse),
        rolling_impulse=warm * data.rolling_impulse,
    )


def pack_constraints_pairs(cc: ContactConstraints, relax=None):
    """Pair-order constraints -> ((P, NF) data, (P, NA) acc, (P, 2) idx),
    columns in contact_solver._F / accumulator order."""
    live = (cc.color >= 0).float()
    mask0 = cc.point_mask[:, 0].float()
    mask1 = cc.point_mask[:, 1].float()
    if relax is None:
        relax = torch.ones_like(cc.friction)
    data = torch.stack([
        cc.normal[:, 0], cc.normal[:, 1], cc.friction, cc.restitution,
        cc.tangent_speed, cc.rolling_resistance, cc.rolling_mass,
        cc.soft_bias, cc.soft_mass, cc.soft_imp,
        cc.anchor_a[:, 0, 0], cc.anchor_a[:, 0, 1],
        cc.anchor_b[:, 0, 0], cc.anchor_b[:, 0, 1],
        cc.anchor_a[:, 1, 0], cc.anchor_a[:, 1, 1],
        cc.anchor_b[:, 1, 0], cc.anchor_b[:, 1, 1],
        cc.base_separation[:, 0], cc.base_separation[:, 1],
        cc.normal_mass[:, 0], cc.normal_mass[:, 1],
        cc.tangent_mass[:, 0], cc.tangent_mass[:, 1],
        cc.relative_velocity[:, 0], cc.relative_velocity[:, 1],
        mask0 * live, mask1 * live,
        cc.inv_mass_a * live, cc.inv_mass_b * live,
        cc.inv_i_a * live, cc.inv_i_b * live,
        torch.clamp(relax, min=0.0),
    ], dim=1)
    z = torch.zeros_like(cc.rolling_impulse)
    acc = torch.stack([
        cc.normal_impulse[:, 0], cc.normal_impulse[:, 1],
        cc.tangent_impulse[:, 0], cc.tangent_impulse[:, 1],
        cc.total_normal_impulse[:, 0], cc.total_normal_impulse[:, 1],
        cc.rolling_impulse,
    ] + [z] * (NA - 7), dim=1)
    live_i = cc.color >= 0
    idx = torch.stack([torch.where(live_i, cc.body_a, -1),
                       torch.where(live_i, cc.body_b, -1)], dim=1)
    return data, acc, idx.to(torch.int32)


def pack_bodies(b, bs: BodySolverState, tuning, h: float, inv_dt: float):
    """Bodies + solver state -> (body (8, Nb), params (12, Nb)); the
    tuning's gravity is (2,), or (Nb, 2) one per body (batch.py)."""
    pos_active = ((b.type != STATIC) & b.awake & b.enabled).float()
    vel_active = ((b.type == DYNAMIC) & b.awake & b.enabled).float()
    body = torch.stack([bs.v[:, 0], bs.v[:, 1], bs.w, bs.dp[:, 0],
                        bs.dp[:, 1], bs.dq[:, 0], bs.dq[:, 1], pos_active])
    g_scale = torch.where(b.inv_mass > 0, b.gravity_scale, 0.0)
    ext_dv = h * (b.inv_mass[:, None] * b.force
                  + g_scale[:, None] * tuning.gravity.reshape(-1, 2))
    ext_dw = h * b.inv_inertia * b.torque
    # float32 product, as the JAX code forms it from a traced inv_dt
    max_w = float(np.float32(MAX_ROTATION) * np.float32(inv_dt))
    max_w_allow = torch.where((b.flags & ALLOW_FAST_ROTATION) != 0, 1e9,
                              max_w)
    params = torch.stack([
        b.inv_mass, b.inv_inertia, ext_dv[:, 0], ext_dv[:, 1], ext_dw,
        1.0 / (1.0 + h * b.linear_damping),
        1.0 / (1.0 + h * b.angular_damping),
        ((b.flags & LOCK_LINEAR_X) != 0).float(),
        ((b.flags & LOCK_LINEAR_Y) != 0).float(),
        ((b.flags & LOCK_ANGULAR_Z) != 0).float(),
        max_w_allow.float(), vel_active,
    ])
    return body, params


def unpack_bodies(bs: BodySolverState, body) -> BodySolverState:
    return bs._replace(v=body[0:2].T, w=body[2], dp=body[3:5].T,
                       dq=body[5:7].T)


def finalize_bodies(state: WorldState, bs: BodySolverState, dt: float,
                    inv_dt: float, advance_fraction) -> WorldState:
    """ref: src/Solver.cs:402-503 FinalizeBodiesTask (commit transforms,
    sleep timers); advance_fraction (Nb,) is the continuous pass's result,
    None when the world runs without continuous collision."""
    b = state.bodies
    tn = state.tuning
    active = (b.type != STATIC) & b.awake & b.enabled
    t = advance_fraction
    if t is None:
        center_end = b.center + bs.dp
        rot_end = m.rot_normalize(m.rot_mul(bs.dq, b.rot))
    else:
        center_end = b.center + t[:, None] * bs.dp
        rot_end = m.rot_nlerp(b.rot, m.rot_normalize(m.rot_mul(bs.dq, b.rot)),
                              t)
    act2 = active[:, None]
    center = torch.where(act2, center_end, b.center)
    rot = torch.where(act2, rot_end, b.rot)

    speed = m.length(bs.v) + torch.abs(bs.w) * b.max_extent
    max_dpos = m.length(bs.dp) + torch.abs(bs.dq[:, 1]) * b.max_extent
    sleep_velocity = torch.maximum(speed, (0.5 * inv_dt) * max_dpos)
    can_sleep = tn.enable_sleep & ((b.flags & ENABLE_SLEEP) != 0)
    resting = can_sleep & (sleep_velocity <= b.sleep_threshold)
    sleep_time = torch.where(active,
                             torch.where(resting, b.sleep_time + dt, 0.0),
                             b.sleep_time)
    bodies = dataclasses.replace(
        b, center=center, rot=rot,
        v=torch.where(act2, bs.v, b.v), w=torch.where(active, bs.w, b.w),
        force=torch.zeros_like(b.force), torque=torch.zeros_like(b.torque),
        sleep_time=sleep_time)
    return dataclasses.replace(state, bodies=bodies)
