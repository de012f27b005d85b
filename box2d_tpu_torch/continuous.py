"""Continuous collision: the fast-body gate, the TOI sweep and the
per-body advancement fraction.

Torch port of box2d_tpu/continuous.py (ref: src/Solver.cs:224-401
ContinuousQueryCallback / SolveContinuous and the fast-body flagging of
FinalizeBodiesTask :445-449). The fast shapes are compacted into a
buffer of `fast_cap` lanes, highest tunnelling risk first; each gets the
top `cand_cap` targets whose AABBs overlap its swept AABB; the (F, K)
pair grid runs the lane-batched conservative-advancement TOI; a body
with a hit is rolled back to the least TOI fraction of its shapes.
Each `lax.cond` of the JAX pass is a host branch here, one device read
each: the gate, whether any pair is valid, whether any pair needs the
fraction-0 retry.
"""

from __future__ import annotations

import torch

from . import math2d as m
from .broadphase import _group_pass, compute_shape_aabbs
from .constants import MAX_POLYGON_VERTICES
from .distance import TOI_HIT, Sweep, time_of_impact
from .state import DYNAMIC, IS_BULLET, STATIC, WorldState


def _gate(state: WorldState, bs, dt):
    """(fast shape mask (S,), bullet bodies (Nb,), max velocity (Nb,)):
    gate_batched of one world."""
    return gate_batched(state, bs, dt, 1, state.tuning.enable_continuous)


def gate_batched(state: WorldState, bs, dt, n_worlds: int, enable_continuous):
    """The fast shapes (S,), bullet bodies and max velocities (Nb,) of each
    world of a flat batched state (broadphase.py, "batched worlds");
    enable_continuous is the worlds' tuning flag per body, or one flag. A
    non-bullet fast shape only sweeps against static shapes, a bullet
    against any non-bullet shape, of its own world; with no such target
    it never hits."""
    sh = state.shapes
    b = state.bodies
    body = sh.body.long()
    S = body.shape[0] // n_worlds
    max_velocity = m.length(bs.v) + torch.abs(bs.w) * b.max_extent
    fast_body = ((b.type == DYNAMIC) & b.awake & b.enabled
                 & (max_velocity * dt > 0.5 * b.min_extent)
                 & enable_continuous)
    bullet_body = fast_body & ((b.flags & IS_BULLET) != 0)
    mask = fast_body[body] & sh.enabled & ~sh.is_sensor
    tgt_bullet = (b.flags[body] & IS_BULLET) != 0
    base_ok = sh.enabled & b.enabled[body] & ~sh.is_sensor & ~tgt_bullet
    per_world = lambda x: x.reshape(n_worlds, S).any(  # noqa: E731
        dim=1).repeat_interleave(S)
    has_static_target = per_world(base_ok & (b.type[body] == STATIC))
    has_any_target = per_world(base_ok)
    mask = mask & torch.where(bullet_body[body], has_any_target,
                              has_static_target)
    return mask, bullet_body, max_velocity


def continuous_pass(state: WorldState, bs, dt, stats, fast_cap: int = 32,
                    cand_cap: int = 8):
    """Returns (per-body advancement fraction (Nb,) in [0, 1], overflow):
    the overflow counts fast shapes beyond `fast_cap` plus TOI candidates
    beyond `cand_cap` (Profile.overflow_ccd). stats (world.StepStats)
    counts the device reads, the gate's openings, the TOI pairs, those
    that took the fraction-0 retry and those that hit."""
    mask, bullet_body, max_velocity = _gate(state, bs, dt)
    (gate,) = stats.read(mask.any())
    b = state.bodies
    nb = b.center.shape[0]
    dev = b.center.device
    if not gate:
        return (torch.ones(nb, dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    stats.ccd_gate_openings += 1
    c2 = b.center + bs.dp
    q2 = m.rot_normalize(m.rot_mul(bs.dq, b.rot))
    return _continuous_impl(state, bs, dt, fast_cap, cand_cap, mask,
                            bullet_body, c2, q2, max_velocity, stats)


def _continuous_impl(state: WorldState, bs, dt, fast_cap, cand_cap,
                     fast_shape_mask, bullet_body, c2, q2, max_velocity,
                     stats):
    """box2d_tpu/continuous.py:84-216."""
    sh = state.shapes
    b = state.bodies
    nb = b.center.shape[0]
    S = sh.type.shape[0]
    dev = b.center.device
    body = sh.body.long()
    lane_s = torch.arange(S, device=dev)

    # compact the fast shapes, highest tunnelling risk first; the scores
    # are unique, so the order of top-k's values is the reference's
    danger = max_velocity[body] * dt / torch.clamp(b.min_extent[body],
                                                   min=1e-6)
    dq = torch.clamp(danger * 8.0, 0.0, float((1 << 10) - 1)).to(
        torch.int32)
    score = torch.where(fast_shape_mask, (dq << 20) + (S - lane_s), 0)
    top = torch.topk(score, min(fast_cap, S)).values
    fs_valid = top > 0
    fs = torch.where(fs_valid, S - (top & ((1 << 20) - 1)), 0).long()
    F = fs.shape[0]

    # the swept AABB of each fast shape: its start AABB and its end pose's
    aabb1 = compute_shape_aabbs(state)
    fb = body[fs]
    q = q2[fb]
    p = c2[fb] - m.rot_vec(q, b.local_center[fb])
    wv = m.rot_vec(q[:, None, :], sh.verts[fs]) + p[:, None, :]
    ok = (torch.arange(sh.verts.shape[1], device=dev)[None, :]
          < sh.count[fs][:, None])[..., None]
    r = sh.radius[fs][:, None]
    end = torch.cat([
        torch.where(ok, wv, float("inf")).min(dim=1).values - r,
        torch.where(ok, wv, float("-inf")).max(dim=1).values + r], dim=1)
    fs_aabb = m.aabb_union(aabb1[fs], end)                   # (F, 4)

    # candidate targets of each fast shape (ref: ContinuousQueryCallback)
    tgt_static = b.type[body] == STATIC
    tgt_bullet = (b.flags[body] & IS_BULLET) != 0
    base_ok = sh.enabled & b.enabled[body] & ~sh.is_sensor & ~tgt_bullet
    is_bullet = bullet_body[fb]
    cmask = (base_ok[None, :] & (body[None, :] != fb[:, None])
             & _group_pass(sh, fs[:, None], lane_s[None, :])
             & (tgt_static[None, :]
                | (is_bullet[:, None] & (b.type[body] != STATIC)[None, :]))
             & m.aabb_overlaps(aabb1[None, :, :], fs_aabb[:, None, :])
             & fs_valid[:, None])                             # (F, S)
    cscore = torch.where(cmask, S - lane_s[None, :], 0)
    ctop = torch.topk(cscore, min(cand_cap, S), dim=1).values  # (F, K)
    cvalid = ctop > 0
    cidx = torch.where(cvalid, S - ctop, 0).long()

    # fast shapes beyond the buffer and candidates beyond the top K get no
    # TOI this step: both are counted
    n_fast = fast_shape_mask.sum()
    ovf_fast = torch.clamp(n_fast - fs_valid.sum(), min=0)
    ovf_cand = torch.clamp(cmask.sum(dim=1) - cvalid.sum(dim=1),
                           min=0).sum()
    overflow = (ovf_fast + ovf_cand).to(torch.int32)

    pair_valid = (cvalid & fs_valid[:, None]).reshape(-1)
    K = cidx.shape[1]
    fsh = fs[:, None].expand(F, K).reshape(-1)
    tsh = cidx.reshape(-1)
    ones = torch.ones(F * K, dtype=torch.float32, device=dev)
    (n_pairs,) = stats.read(pair_valid.sum())
    if n_pairs:
        stats.toi_pairs += n_pairs

        def sweep(shapes):
            bid = body[shapes]
            return Sweep(b.local_center[bid], b.center[bid], c2[bid],
                         b.rot[bid], q2[bid])

        sweep_f = sweep(fsh)
        sweep_t = sweep(tsh)
        out = time_of_impact(
            sh.verts[tsh], sh.count[tsh], sh.radius[tsh], sweep_t,
            sh.verts[fsh], sh.count[fsh], sh.radius[fsh], sweep_f, 1.0,
            active=pair_valid, stats=stats)
        hit = (out.state == TOI_HIT) & (out.fraction > 0.0) & (
            out.fraction < 1.0)
        fr1 = torch.where(pair_valid & hit, out.fraction, 1.0)
        retry = pair_valid & (out.state == TOI_HIT) & (out.fraction == 0.0)
        # the fraction-0 retry with a core proxy (ref: :294-303)
        n_retry, n_hit = stats.read(retry.sum(), (pair_valid & hit).sum())
        stats.toi_retries += n_retry
        stats.toi_hits += n_hit
        fr2 = ones
        if n_retry:
            core_r = 0.25 * b.min_extent[body[fsh]]
            core = sh.centroid[fsh][:, None, :].expand(
                -1, MAX_POLYGON_VERTICES, 2)
            out2 = time_of_impact(
                sh.verts[tsh], sh.count[tsh], sh.radius[tsh], sweep_t,
                core, torch.ones_like(fsh), core_r, sweep_f, 1.0,
                active=retry, stats=stats)
            hit2 = (out2.state == TOI_HIT) & (out2.fraction > 0.0) & (
                out2.fraction < 1.0)
            fr2 = torch.where(retry & hit2, out2.fraction, 1.0)
            (n_hit2,) = stats.read((retry & hit2).sum())
            stats.toi_hits += n_hit2
        # a hit lane has fr1 in (0, 1) and no retry, a retried hit fr1 = 1
        fracs = torch.minimum(fr1, fr2).reshape(F, K)
    else:
        fracs = ones.reshape(F, K)

    per_fast = fracs.min(dim=1).values
    body_frac = torch.ones(nb + 1, dtype=torch.float32, device=dev)
    body_frac = body_frac.scatter_reduce(
        0, torch.where(fs_valid, fb, nb), per_fast, "amin")
    return body_frac[:nb], overflow
