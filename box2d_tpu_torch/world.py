"""World step: one rigid world of circles, capsules and polygons, with
joints, and a plain-water particle system.

Torch port of box2d_tpu/world.py: `make_step`, `_step` with the idle gate
(:137-159), `_step_work` along the kernel branch (layout scatter :383-496,
the kernel call :547-566, the pair-order impulse gather :567-573) and
`_step_tail` (:706-805) with the contact, hit and joint events. A world
with particles steps them first and runs the rigid pipeline only where it
has work (the particle gate, box2d_tpu/world.py:101-135). A world
with solvable joints prepares them after the contacts, sorts their packed
rows into the joint region of the layout (joints.layout_joint_rows) and
hands it to the same kernel launch; a world without them packs and
launches exactly the contact-only pipeline. The sensor pass is a no-op:
World.compile refuses sensor shapes.

PyTorch runs eagerly, so every `lax.cond` / `while_loop` of the JAX step
is a host branch or loop here, and each costs one device read.
`StepStats` counts them; CUDA graphs or device-side conditionals are
later work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math2d as m
from .broadphase import compute_shape_aabbs, find_pairs_incremental
from .coloring import dense_remap, repair_colors
from .contact_solver import NA, NF, contact_solve
from .continuous import continuous_pass
from .joints import (layout_joint_rows, prepare_joints, solvable_joint_types,
                     unpack_joint_acc)
from .narrowphase import narrow_phase, update_cache
from .particles import ParticleConfig, particle_step
from .sleep import wake_and_sleep
from .solver import (BodySolverState, finalize_bodies, pack_bodies,
                     pack_constraints_pairs, prepare_contacts, unpack_bodies)
from .state import (DYNAMIC, JOINT_DISTANCE, JOINT_FILTER, JOINT_PRISMATIC,
                    JOINT_REVOLUTE, JOINT_WHEEL, Capacity, Profile,
                    WorldState, auto_chunk, zero_events, zero_profile)


class StepStats:
    """Counters of a step function: steps taken, idle steps (the idle gate,
    or in a particle world the particle gate, skipped the rigid work),
    openings of the CCD gate, device reads, and the particle sub-iterations
    that took the rank repair (K4) or the full sort. Each read blocks the
    host until the device has caught up; `syncs` counts them."""

    def __init__(self):
        self.steps = 0
        self.idle_steps = 0
        self.ccd_gate_openings = 0
        self.syncs = 0
        self.rank_repairs = 0
        self.full_sorts = 0

    def read(self, *tensors):
        """Read scalar tensors to Python ints in one transfer."""
        self.syncs += 1
        vals = torch.stack([t.reshape(()).to(torch.int64) for t in tensors])
        return vals.tolist()


class Step:
    """The step function of one static configuration (the counterpart of
    the jitted closure box2d_tpu.world.make_step returns)."""

    def __init__(self, capacity: Capacity, classes_present: frozenset,
                 substeps: int = 4, continuous: bool = True,
                 joint_types: frozenset = frozenset(),
                 particle_cfg: ParticleConfig | None = None):
        self.capacity = capacity
        self.classes = classes_present
        self.substeps = substeps
        self.continuous = continuous
        self.joint_types = joint_types
        self.particle_cfg = particle_cfg
        self.stats = StepStats()

    def __call__(self, state: WorldState, dt,
                 light_events: bool = False) -> WorldState:
        return _step(state, dt, self.capacity, self.classes, self.substeps,
                     self.continuous, self.stats, light_events,
                     self.joint_types, self.particle_cfg)


def make_step(capacity: Capacity, classes_present: frozenset,
              substeps: int = 4, continuous: bool = True,
              joint_types: frozenset = frozenset(),
              particle_cfg: ParticleConfig | None = None) -> Step:
    return Step(capacity, classes_present, substeps, continuous, joint_types,
                particle_cfg)


def _step(state: WorldState, dt, cap: Capacity, classes_present: frozenset,
          substeps: int, continuous: bool, syncs: StepStats,
          light_events: bool = False,
          joint_types: frozenset = frozenset(),
          particle_cfg: ParticleConfig | None = None) -> WorldState:
    if (particle_cfg is not None and state.particles is not None
            and state.broadphase is not None):
        return _particle_gate(state, dt, cap, classes_present, substeps,
                              continuous, syncs, light_events, joint_types,
                              particle_cfg)
    # whole-world idle fast path (box2d_tpu/world.py:137-159)
    b0 = state.bodies
    idle = (~state.broadphase.dirty
            & ~(b0.awake & (b0.type != 0) & b0.enabled).any())
    (idle_h,) = syncs.read(idle)
    syncs.steps += 1
    if idle_h:
        syncs.idle_steps += 1
        dev = b0.center.device
        return dataclasses.replace(
            state, events=zero_events(cap, dev), profile=zero_profile(dev),
            step_count=state.step_count + 1)
    return _step_work(state, dt, cap, classes_present, substeps, continuous,
                      syncs, light_events=light_events,
                      joint_types=joint_types)


def _particle_gate(state, dt, cap, classes_present, substeps, continuous,
                   syncs, light_events, joint_types, particle_cfg):
    """Particles step first; the rigid pipeline runs only when a body is
    awake or the broadphase is dirty (box2d_tpu/world.py:101-135). The
    rigid phases read only poses, which particles never touch, so the order
    is the reference's (api/World.cs:92)."""
    new_particles, body_dv, body_dw, pov = particle_step(
        state.particles, state, dt, particle_cfg, syncs)
    # particle impulses wake the bodies they touch
    # (ref: particle/World.cs:47-61 ApplyLinearImpulse -> WakeBody)
    poked = (m.dot(body_dv, body_dv) + body_dw * body_dw) > 1e-12
    b0 = state.bodies
    b1 = dataclasses.replace(
        b0, v=b0.v + body_dv, w=b0.w + body_dw,
        awake=b0.awake | (poked & (b0.type == DYNAMIC)),
        sleep_time=torch.where(poked, 0.0, b0.sleep_time))
    state = dataclasses.replace(state, bodies=b1, particles=new_particles)
    rigid_live = (state.broadphase.dirty
                  | (b1.awake & (b1.type != 0) & b1.enabled).any())
    (live_h,) = syncs.read(rigid_live)
    syncs.steps += 1
    if live_h:
        return _step_work(state, dt, cap, classes_present, substeps,
                          continuous, syncs, light_events=light_events,
                          joint_types=joint_types, particle_overflow=pov)
    syncs.idle_steps += 1
    dev = b0.center.device
    return dataclasses.replace(
        state, events=zero_events(cap, dev),
        profile=dataclasses.replace(zero_profile(dev),
                                    overflow_particles=pov),
        step_count=state.step_count + 1)


def _f32_scalars(dt, substeps):
    """dt, inv_dt, h, inv_h as float32 values (held in Python floats),
    computed as the JAX step computes them in float32."""
    dt = np.float32(dt)
    one = np.float32(1.0)
    inv_dt = one / dt if dt > 0 else np.float32(0.0)
    h = dt / np.float32(substeps)
    inv_h = one / h if h > 0 else np.float32(0.0)
    return float(dt), float(inv_dt), float(h), float(inv_h)


def _scatter_rows(rows, idx, n, fill):
    """out[idx[i]] = rows[i] into n rows pre-filled with `fill`; indices
    >= n are dropped (JAX mode="drop")."""
    out = torch.full((n + 1,) + tuple(rows.shape[1:]), fill, dtype=rows.dtype,
                     device=rows.device)
    out[torch.clamp(idx, max=n).long()] = rows
    return out[:n]


def _step_work(state: WorldState, dt, cap: Capacity,
               classes_present: frozenset, substeps: int, continuous: bool,
               syncs: StepStats, until: str = "",
               light_events: bool = False,
               joint_types: frozenset = frozenset(), particle_overflow=None):
    dt, inv_dt, h, inv_h = _f32_scalars(dt, substeps)
    b = state.bodies
    nb = b.center.shape[0]
    tn = state.tuning
    dev = b.center.device

    old_key_a = state.contacts.key_a
    old_key_b = state.contacts.key_b
    aabbs = compute_shape_aabbs(state, cap.max_verts)
    if until == "aabbs":
        return aabbs
    pairs, new_bp, cache, orphan_mask, store_drops, rebuild_kind = \
        find_pairs_incremental(state, cap, aabbs, syncs)
    state = dataclasses.replace(state, broadphase=new_bp, contacts=cache)
    if until == "pairs":
        return pairs, state.contacts
    data = narrow_phase(state, pairs, classes_present, cap.max_verts)
    touching = data.manifold.point_count > 0
    if until == "narrow":
        return data

    # --- constraint graph coloring (contacts, then joint lanes) ----------
    awake_dyn = b.awake & (b.type == DYNAMIC)
    jn = state.joints
    joint_active = (jn.enabled & (jn.type >= 0) & (jn.type != JOINT_FILTER)
                    & (awake_dyn[torch.clamp(jn.body_a, min=0).long()]
                       | awake_dyn[torch.clamp(jn.body_b, min=0).long()]))
    ad_a = (data.dyn_a[:, 12] > 0) & (data.dyn_a[:, 11] == 2)
    ad_b = (data.dyn_b[:, 12] > 0) & (data.dyn_b[:, 11] == 2)
    contact_live = touching & (ad_a | ad_b)
    all_ba = torch.cat([data.body_a, jn.body_a])
    all_bb = torch.cat([data.body_b, jn.body_b])
    all_active = torch.cat([contact_live, joint_active])
    all_prev = torch.cat([torch.where(touching, data.prev_color, -1),
                          jn.color])
    all_reserved = torch.cat([touching, jn.enabled & (jn.type >= 0)])
    chunk = cap.color_chunk or auto_chunk(cap.max_contact_pairs)
    n_all = all_ba.shape[0]
    raw_colors = repair_colors(
        all_ba, all_bb, all_active, all_reserved, all_prev, b.type, nb,
        syncs, cap.max_colors, color_cap=chunk,
        repair_cap=min(max(512, cap.max_contact_pairs // 4), n_all, 1 << 16),
        two_tier=not cap.batched)
    ovf = all_active & (raw_colors < 0)
    overflow_colors = ovf.sum().to(torch.int32)
    colors = dense_remap(
        torch.where(all_active,
                    torch.where(ovf, cap.max_colors - 1, raw_colors), -1),
        all_active, cap.max_colors)
    p = data.body_a.shape[0]
    contact_color = torch.where(contact_live, colors[:p], -1)
    joint_color = torch.where(joint_active, colors[p:], -1)
    num_colors = torch.clamp(
        torch.where(all_active, colors, -1).max() + 1, min=0)
    contact_color_store = raw_colors[:p]
    state = dataclasses.replace(state, joints=dataclasses.replace(
        jn, color=torch.where(joint_active, raw_colors[p:], jn.color)))

    # mass-splitting scale for the overflow color (world.py:308-321)
    (n_ovf,) = syncs.read(overflow_colors)
    if n_ovf > 0:
        ovf2 = torch.cat([ovf, ovf])
        both = torch.cat([all_ba, all_bb]).long()
        deg = torch.zeros(nb + 1, dtype=torch.float32, device=dev)
        deg.index_add_(0, torch.where(ovf2, both, nb),
                       torch.ones_like(both, dtype=torch.float32))
        deg2 = deg[both % (nb + 1)]
        cdeg = torch.clamp(torch.maximum(deg2[:n_all], deg2[n_all:]), min=1.0)
        relax = torch.where(ovf, 1.0 / cdeg, 1.0)
    else:
        relax = torch.ones(n_all, dtype=torch.float32, device=dev)
    contact_relax = relax[:p]
    if until == "colors":
        return contact_color, joint_color, num_colors, contact_relax

    bs = BodySolverState(v=b.v, w=b.w, dp=torch.zeros_like(b.center),
                         dq=m.rot_identity((nb,), device=dev))
    cc = prepare_contacts(state, data, contact_color, h, inv_h)
    # a world without solvable joints prepares none and emits no joint event
    with_joints = bool(solvable_joint_types(joint_types))
    jc = prepare_joints(state, joint_color, h, inv_h) if with_joints else None
    if until == "prepare":
        return cc, jc

    # --- color-bucket layout (world.py:337-378) ---------------------------
    l0 = cap.max_colors * chunk
    ovf_cap = ((min(p, 2 * chunk) + chunk - 1) // chunk) * chunk
    layout_len = l0 + ovf_cap
    onehot_c = cc.color[:, None] == torch.arange(cap.max_colors,
                                                 device=dev)[None, :]
    ranks = torch.cumsum(onehot_c.to(torch.int32), 0, dtype=torch.int32)
    ovf_color = num_colors - 1
    slot = torch.where(onehot_c, ranks, 0).sum(dim=1) - 1
    is_ovf_lane = ((((cc.color == ovf_color) & (overflow_colors > 0))
                    | (slot >= chunk)) & (cc.color >= 0))
    tail_rank = torch.cumsum(is_ovf_lane.to(torch.int64), 0) - 1
    layout_idx = torch.where(
        cc.color < 0, layout_len,
        torch.where(is_ovf_lane,
                    torch.where(tail_rank < ovf_cap, l0 + tail_rank,
                                layout_len),
                    cc.color.long() * chunk + slot))
    gidx = torch.clamp(layout_idx, 0, layout_len - 1)
    active_lane = layout_idx < layout_len

    # one row scatter of the packed pair-order matrices into the layout
    data_p, acc_p, idx_p = pack_constraints_pairs(cc, contact_relax)
    rowsL = _scatter_rows(torch.cat([data_p, acc_p], dim=1), layout_idx,
                          layout_len, 0.0)
    idxL = _scatter_rows(idx_p, layout_idx, layout_len, -1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    scalars = torch.stack([
        f32(h), f32(inv_h), tn.contact_speed, tn.restitution_threshold,
        tn.max_linear_speed, f32(0.0), f32(0.0), f32(0.0)])[None, :]
    bodyp, paramsp = pack_bodies(b, bs, tn, h, inv_dt)
    # every bucket is swept (empty ones are no-ops), so the live color
    # count is never read back to the host
    # joint region: the live joints' packed rows sorted by (color, type),
    # one segment per color, swept ahead of that color's contact bucket
    jrows = jpos = None
    if with_joints:
        jrows, jpos = layout_joint_rows(state.joints, jc, cap.max_colors)
    kernel_args = (scalars, idxL.T.contiguous(),
                   rowsL[:, :NF].T.contiguous(),
                   rowsL[:, NF:NF + NA].T.contiguous(), bodyp, paramsp,
                   substeps, chunk, l0, cap.max_colors, jrows)
    if until == "layout":
        return kernel_args
    out = contact_solve(*kernel_args)
    if until == "kernel":
        return out
    out_body, out_acc = out[0], out[1]
    if with_joints:
        jc = unpack_joint_acc(jc, out[2].T[jpos], joint_color >= 0)
    bs = unpack_bodies(bs, out_body)
    pair_acc = out_acc.T[gidx]
    act = active_lane[:, None]
    ni = torch.where(act, pair_acc[:, 0:2], data.normal_impulse)
    ti = torch.where(act, pair_acc[:, 2:4], data.tangent_impulse)
    tni = torch.where(act, pair_acc[:, 4:6], 0.0)
    roll = torch.where(active_lane, pair_acc[:, 6], data.rolling_impulse)
    tail_args = (state, data, bs, dt, inv_dt, cap, pairs, num_colors,
                 overflow_colors, touching, continuous, contact_color_store,
                 ni, ti, roll, tni, cc.relative_velocity,
                 (orphan_mask, old_key_a, old_key_b, store_drops,
                  rebuild_kind))
    if until == "tail":
        return tail_args
    return _step_tail(*tail_args, syncs, until=until,
                      light_events=light_events, jc=jc, inv_h=inv_h,
                      particle_overflow=particle_overflow)


def _step_tail(state, data, bs, dt, inv_dt, cap, pairs, num_colors,
               overflow_colors, touching, continuous, contact_color_store,
               ni, ti, roll, tni, relv, orphan_info, syncs, until: str = "",
               light_events: bool = False, jc=None, inv_h: float = 0.0,
               particle_overflow=None):
    """Post-solve: store impulses, events, continuous gate, finalize,
    sleep, profile (box2d_tpu/world.py:706-805). jc: the solved
    JointConstraints (None leaves the joints' stored impulses as they are
    and emits no joint event). particle_overflow: the particle step's
    overflow count, stored in the profile."""
    dev = touching.device
    data = data._replace(normal_impulse=ni, tangent_impulse=ti,
                         rolling_impulse=roll)
    state = dataclasses.replace(
        state, contacts=update_cache(data, contact_color_store),
        joints=_store_joint_impulses(state.joints, jc))
    store_drops = orphan_info[3]
    if until == "store":
        return state.contacts

    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    if light_events:
        events, ev_drop = zero_events(cap, dev), i0
    else:
        # the begin/end, orphan and hit conds of the JAX code share one read
        ev = data.ev_contact
        begin = touching & ~data.was_touching & ev
        end = ~touching & data.was_touching & ev
        approach = -relv
        pt_ok = (approach > state.tuning.hit_event_threshold) & (tni > 0.0)
        hit = data.ev_hit & touching & pt_ok.any(dim=1)
        any_be, any_orphan, any_hit = syncs.read(
            (begin | end).any(), orphan_info[0].any(), hit.any())
        events, ev_drop = _contact_events(state, data, begin, end, cap,
                                          orphan_info, any_be, any_orphan)
        events, d_hit = _hit_events(data, approach, pt_ok, hit, events, cap,
                                    any_hit)
        ev_drop = ev_drop + d_hit
        if jc is not None:
            events, d_joint = _joint_events(state, jc, inv_h, events, cap)
            ev_drop = ev_drop + d_joint
    if until == "events":
        return events

    advance, overflow_ccd = None, i0
    if continuous:
        advance, overflow_ccd = continuous_pass(state, bs, dt, syncs)
    if until == "continuous":
        return advance, overflow_ccd, events

    state = finalize_bodies(state, bs, dt, inv_dt, advance)
    if until == "finalize":
        return state.bodies.center, state.bodies.rot, events

    awake_fin = state.bodies.awake
    new_touch = touching & ~data.was_touching
    lost_touch = (data.was_touching & ~touching) | orphan_info[0]
    state = wake_and_sleep(state, touching, new_touch, data.body_a,
                           data.body_b, dt, data.dyn_a, data.dyn_b,
                           lost_touch, syncs)
    if until == "sleep":
        return state.bodies.awake, state.bodies.island_label, events

    bnew = state.bodies
    moved = awake_fin & (bnew.type != 0) & bnew.enabled
    fell = moved & ~bnew.awake
    events = dataclasses.replace(
        events, body_moved=moved, body_fell_asleep=fell,
        body_move_count=moved.sum().to(torch.int32),
        body_fell_asleep_count=fell.sum().to(torch.int32))
    # sensor_pass is a no-op: World.compile refuses sensor shapes
    profile = Profile(
        pair_count=pairs.count,
        contact_point_count=data.manifold.point_count.sum().to(torch.int32),
        color_count=num_colors.to(torch.int32),
        overflow_pairs=pairs.overflow,
        overflow_colors=overflow_colors,
        store_drops=store_drops,
        overflow_ccd=overflow_ccd,
        overflow_particles=(i0 if particle_overflow is None
                            else particle_overflow),
        events_dropped=ev_drop,
        pair_rebuild=orphan_info[4],
    )
    return dataclasses.replace(state, events=events, profile=profile,
                               step_count=state.step_count + 1)


def _store_joint_impulses(joints, jc):
    if jc is None:
        return joints
    return dataclasses.replace(
        joints, impulse=jc.impulse, spring_impulse=jc.spring_impulse,
        spring_impulse2=jc.spring_impulse2, motor_impulse=jc.motor_impulse,
        lower_impulse=jc.lower_impulse, upper_impulse=jc.upper_impulse,
        angular_impulse=jc.angular_impulse)


def _compact_events(mask, payload, capacity):
    """The first `capacity` set lanes of `mask`, in ascending lane order,
    as a fixed-size event array; returns (rows, count, dropped)."""
    n = mask.shape[0]
    big = 1 << 30
    lane = torch.arange(n, dtype=torch.int32, device=mask.device)
    k = min(capacity, n)
    idx = torch.sort(torch.where(mask, lane, big)).values[:k]
    valid = idx < big
    rows = payload[torch.clamp(idx, 0, n - 1).long()]
    rows = torch.where(valid.reshape((k,) + (1,) * (payload.dim() - 1)),
                       rows, 0)
    if k < capacity:
        rows = torch.cat([rows, torch.zeros(
            (capacity - k,) + tuple(payload.shape[1:]), dtype=payload.dtype,
            device=payload.device)])
    count = mask.sum()
    return (rows, torch.clamp(count, max=capacity).to(torch.int32),
            torch.clamp(count - capacity, min=0).to(torch.int32))


def _contact_events(state, data, begin, end, cap, orphan_info,
                    any_be: bool, any_orphan: bool):
    """Begin/end touch events plus end events of pairs a rebuild dropped
    (box2d_tpu/world.py:858-921); any_be / any_orphan are the host values
    of the JAX code's two conds."""
    sh = state.shapes
    e = cap.event_capacity
    events = zero_events(cap, begin.device)
    if any_be:
        pairs_ab = torch.stack([data.shape_a, data.shape_b], dim=1)
        begin_arr, begin_count, drop_b = _compact_events(begin, pairs_ab, e)
        end_arr, end_count, drop_e = _compact_events(end, pairs_ab, e)
        dropped = drop_b + drop_e
    else:
        begin_arr, end_arr = events.contact_begin, events.contact_end
        begin_count = end_count = dropped = events.contact_begin_count

    if any_orphan:
        orphan_mask, old_key_a, old_key_b = orphan_info[:3]
        ka = torch.clamp(old_key_a, min=0).long()
        kb = torch.clamp(old_key_b, min=0).long()
        orphan = (orphan_mask & sh.enable_contact_events[ka]
                  & sh.enable_contact_events[kb])
        pos = end_count + torch.cumsum(orphan.to(torch.int64), 0) - 1
        tgt = torch.where(orphan & (pos < e), pos, e)
        ext = torch.cat([end_arr, end_arr[:1]])
        ext[tgt] = torch.stack([ka, kb], dim=1).to(end_arr.dtype)
        end_arr = ext[:e]
        total = end_count + orphan.sum()
        end_count = torch.clamp(total, max=e).to(torch.int32)
        dropped = dropped + torch.clamp(total - e, min=0).to(torch.int32)

    return dataclasses.replace(
        events, contact_begin=begin_arr, contact_begin_count=begin_count,
        contact_end=end_arr, contact_end_count=end_count), dropped


def _hit_events(data, approach, pt_ok, hit, events, cap, any_hit: bool):
    """Contact hit events (box2d_tpu/world.py:924-961): the fastest
    approaching point of each qualifying pair, in lane order."""
    e = cap.event_capacity
    if not any_hit:
        return events, torch.zeros((), dtype=torch.int32, device=hit.device)
    best_pt = torch.argmax(torch.where(pt_ok, approach, float("-inf")), dim=1)
    lane = torch.arange(data.shape_a.shape[0], device=hit.device)
    speed = approach[lane, best_pt]
    point = data.manifold.point[lane, best_pt]
    pairs_ab = torch.stack([data.shape_a, data.shape_b], dim=1)
    pos = torch.cumsum(hit.to(torch.int64), 0) - 1
    tgt = torch.clamp(torch.where(hit, pos, e), max=e)
    n_hit = hit.sum()

    def put(arr, val):
        out = torch.cat([arr, arr[:1]])
        out[tgt] = val.to(arr.dtype)
        return out[:e]

    return dataclasses.replace(
        events,
        hit_point=put(events.hit_point, point),
        hit_normal=put(events.hit_normal, data.manifold.normal),
        hit_speed=put(events.hit_speed, speed),
        hit_shapes=put(events.hit_shapes, pairs_ab),
        hit_count=torch.clamp(n_hit, max=e).to(torch.int32),
    ), torch.clamp(n_hit - e, min=0).to(torch.int32)


def _joint_events(state, jc, inv_h, events, cap):
    """Joint force/torque threshold events (box2d_tpu/world.py:964-1000,
    ref: src/Solver.cs:1126-1150 + per-joint GetReaction), in joint-lane
    order."""
    jn = state.joints
    ty = jn.type
    lin = torch.sqrt((jc.impulse ** 2).sum(dim=1))
    axial = jc.spring_impulse + jc.lower_impulse - jc.upper_impulse
    force = torch.where(
        ty == JOINT_DISTANCE,
        torch.abs(jc.impulse[:, 0] + jc.lower_impulse - jc.upper_impulse
                  + jc.motor_impulse),
        torch.where(ty == JOINT_PRISMATIC,
                    torch.hypot(jc.impulse[:, 0], axial + jc.motor_impulse),
                    torch.where(ty == JOINT_WHEEL,
                                torch.hypot(jc.impulse[:, 0], axial),
                                lin))) * inv_h
    torque = torch.where(
        ty == JOINT_REVOLUTE,
        torch.abs(jc.motor_impulse + jc.lower_impulse - jc.upper_impulse),
        torch.where(ty == JOINT_PRISMATIC, torch.abs(jc.impulse[:, 1]),
                    torch.where(ty == JOINT_WHEEL,
                                torch.abs(jc.motor_impulse),
                                torch.abs(jc.angular_impulse)))) * inv_h
    over = jc.active & ((force >= jn.force_threshold)
                        | (torque >= jn.torque_threshold))
    e = cap.event_capacity
    pos = torch.cumsum(over.to(torch.int64), 0) - 1
    tgt = torch.clamp(torch.where(over, pos, e), max=e)
    ids = torch.arange(ty.shape[0], dtype=torch.int32, device=ty.device)
    ext = torch.cat([events.joint_force, events.joint_force[:1]])
    ext[tgt] = ids
    n_over = over.sum()
    return dataclasses.replace(
        events, joint_force=ext[:e],
        joint_force_count=torch.clamp(n_over, max=e).to(torch.int32),
    ), torch.clamp(n_over - e, min=0).to(torch.int32)
