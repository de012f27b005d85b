"""Continuous collision: the fast-body gate of the contact-only slice.

Torch port of the gate in box2d_tpu/continuous.py:30-80 (ref:
src/Solver.cs:445-449 fast-body flagging and the target-existence test).
When the gate stays shut, every body advances its full step, exactly as the
JAX `lax.cond`'s closed branch returns. The TOI sweep behind an open gate
(`_continuous_impl`, which needs distance.time_of_impact) is not ported yet:
an open gate raises instead of silently skipping the sweep.
"""

from __future__ import annotations

import torch

from . import math2d as m
from .state import DYNAMIC, IS_BULLET, STATIC, WorldState


def fast_shape_mask(state: WorldState, bs, dt):
    """(S,) shapes that need a TOI sweep this step."""
    sh = state.shapes
    b = state.bodies
    body = sh.body.long()
    max_velocity = m.length(bs.v) + torch.abs(bs.w) * b.max_extent
    fast_body = ((b.type == DYNAMIC) & b.awake & b.enabled
                 & (max_velocity * dt > 0.5 * b.min_extent)
                 & state.tuning.enable_continuous)
    bullet_body = fast_body & ((b.flags & IS_BULLET) != 0)
    mask = fast_body[body] & sh.enabled & ~sh.is_sensor
    tgt_bullet = (b.flags[body] & IS_BULLET) != 0
    base_ok = sh.enabled & b.enabled[body] & ~sh.is_sensor & ~tgt_bullet
    has_static_target = (base_ok & (b.type[body] == STATIC)).any()
    has_any_target = base_ok.any()
    return mask & torch.where(bullet_body[body], has_any_target,
                              has_static_target)


def continuous_pass(state: WorldState, bs, dt, stats):
    """Returns (per-body advancement fraction (Nb,), overflow count).
    stats (world.StepStats) counts the device read and any gate opening."""
    (gate,) = stats.read(fast_shape_mask(state, bs, dt).any())
    nb = state.bodies.center.shape[0]
    dev = state.bodies.center.device
    if gate:
        stats.ccd_gate_openings += 1
        raise NotImplementedError("CCD TOI: ROADMAP.md queue 10")
    return (torch.ones(nb, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))
