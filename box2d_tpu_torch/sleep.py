"""Sleep management: island labels, sleep/wake transitions.

Torch port of box2d_tpu/sleep.py `wake_and_sleep` (ref: src/Island.cs,
src/SolverSet.cs, src/Solver.cs:1293-1321). Islands are a persistent
min-label propagated over touching dynamic contacts and over enabled
joints between dynamic bodies; the JAX code's label
and wake `lax.cond`s are host branches here (one device read per step,
counted in world.StepStats). Island labels ride the narrow phase's packed body
rows through the named column `dyn_col("label")`.
"""

from __future__ import annotations

import dataclasses

import torch

from .constants import TIME_TO_SLEEP
from .narrowphase import dyn_col
from .state import DYNAMIC, ENABLE_SLEEP, WorldState

_LARGE = 1 << 30


def wake_and_sleep(state: WorldState, touching, new_touch, body_a, body_b,
                   dt, dyn_a, dyn_b, lost_touch, syncs) -> WorldState:
    """Wake islands hit by new contacts; put long-still islands to sleep:
    wake_and_sleep_batched of one world. dyn_a/dyn_b are the narrow
    phase's start-of-step body rows (no particle impulse can make them
    stale)."""
    b = state.bodies
    one = dataclasses.replace(state, bodies=dataclasses.replace(
        b, island_dirty=b.island_dirty.reshape(1),
        island_split_pending=b.island_split_pending.reshape(1)))
    out = wake_and_sleep_batched(one, touching, new_touch, body_a, body_b,
                                 dt, dyn_a, dyn_b, lost_touch, 1,
                                 state.tuning.enable_sleep, syncs)
    ob = out.bodies
    return dataclasses.replace(out, bodies=dataclasses.replace(
        ob, island_dirty=ob.island_dirty.reshape(()),
        island_split_pending=ob.island_split_pending.reshape(())))


def wake_and_sleep_batched(state: WorldState, touching, new_touch, body_a,
                           body_b, dt, dyn_a, dyn_b, lost_touch, n_worlds,
                           enable_sleep, syncs) -> WorldState:
    """Wake islands hit by new contacts and put long-still islands to
    sleep, in each world of a flat batched state (broadphase.py, "batched
    worlds"): labels and body ids are flat, island_dirty /
    island_split_pending are (W,), enable_sleep is the worlds' tuning
    flag per body (W * Nb,) or one flag. The label and wake branches run
    when any world takes them, and each world keeps its own branch's
    outputs. One device read."""
    b = state.bodies
    n_w = n_worlds
    NB = b.center.shape[0]
    nb = NB // n_w
    dev = b.center.device
    per_body = lambda x: x.repeat_interleave(nb)  # noqa: E731
    rw = lambda x: x.reshape(n_w, -1)  # noqa: E731
    c_typ_a = dyn_a[:, dyn_col("btype")].to(torch.int32)
    c_typ_b = dyn_b[:, dyn_col("btype")].to(torch.int32)
    c_awk_a = dyn_a[:, dyn_col("awake")] > 0
    c_awk_b = dyn_b[:, dyn_col("awake")] > 0
    c_en_a = dyn_a[:, dyn_col("enabled")] > 0
    c_en_b = dyn_b[:, dyn_col("enabled")] > 0
    lab_a = dyn_a[:, dyn_col("label")].to(torch.int32)
    lab_b = dyn_b[:, dyn_col("label")].to(torch.int32)
    dd = (c_typ_a == DYNAMIC) & (c_typ_b == DYNAMIC)

    any_new = rw(new_touch).any(dim=1)
    any_lost = rw(lost_touch).any(dim=1)
    any_new_cross = rw(new_touch & dd & (lab_a != lab_b)).any(dim=1)
    any_change = any_new | any_lost
    pend_in = b.island_split_pending | any_lost
    launch = pend_in & ~any_change
    run_labels = b.island_dirty | any_new_cross | launch
    ids = torch.arange(NB, dtype=torch.int32, device=dev)
    fresh_in = torch.where(per_body(launch), ids, b.island_fresh)
    pend_out = pend_in & ~launch
    any_asleep = rw(~b.awake & (b.type == DYNAMIC) & b.enabled).any(dim=1)
    do_wake = any_new & any_asleep
    run_labels_h, do_wake_h = syncs.read(run_labels.any(), do_wake.any())

    if run_labels_h:
        jn = state.joints
        j_on = jn.enabled & (jn.body_a >= 0)
        j_dyn_a = b.type[torch.clamp(jn.body_a, 0, NB - 1).long()] == DYNAMIC
        j_dyn_b = b.type[torch.clamp(jn.body_b, 0, NB - 1).long()] == DYNAMIC
        edges_a = torch.cat([body_a, jn.body_a]).long()
        edges_b = torch.cat([body_b, jn.body_b]).long()
        on = torch.cat([touching & dd, j_on & j_dyn_a & j_dyn_b])
        slot_ab = torch.cat([torch.where(on, edges_a, NB),
                             torch.where(on, edges_b, NB)])
        ce = torch.clamp(torch.cat([edges_a, edges_b]), 0, NB - 1)
        E = edges_a.shape[0]

        def prop2(l2):
            gg = l2[ce]
            mn = torch.minimum(gg[:E], gg[E:])
            ext = torch.cat([l2, torch.full((1, 2), _LARGE, dtype=torch.int32,
                                            device=dev)])
            ext = ext.scatter_reduce(0, slot_ab[:, None].expand(-1, 2),
                                     torch.cat([mn, mn]), reduce="amin")
            return ext[:NB]

        lab2 = torch.stack([b.island_label, fresh_in], dim=1)
        for _ in range(4):
            lab2 = prop2(lab2)
        snap4 = lab2
        lab2 = prop2(lab2)
        converged = rw((lab2 == snap4).all(dim=1)).all(dim=1)
        conv_b = per_body(converged)
        run_b = per_body(run_labels)
        labels = torch.where(run_b, torch.where(conv_b, snap4[:, 1],
                                                lab2[:, 0]), b.island_label)
        fresh = torch.where(run_b, torch.where(conv_b, ids, lab2[:, 1]),
                            fresh_in)
        dirty_out = run_labels & ~converged
    else:
        labels, fresh = b.island_label, fresh_in
        dirty_out = torch.zeros(n_w, dtype=torch.bool, device=dev)

    lab_c = torch.clamp(labels, 0, NB).long()
    if do_wake_h:
        mover_a = c_awk_a & (c_typ_a != 0) & c_en_a
        mover_b = c_awk_b & (c_typ_b != 0) & c_en_b
        hit = new_touch & ((~c_awk_a & mover_b) | (~c_awk_b & mover_a))
        hit2 = torch.cat([hit, hit])
        woken = torch.zeros(NB + 1, dtype=torch.bool, device=dev)
        woken[torch.where(hit2, torch.cat([body_a, body_b]).long(), NB)] = True
        island_woken = torch.zeros(NB + 1, dtype=torch.bool, device=dev)
        island_woken[torch.where(woken[:NB], lab_c, NB)] = True
        wake = (island_woken[lab_c] & (b.type == DYNAMIC)
                & per_body(do_wake))
    else:
        wake = torch.zeros(NB, dtype=torch.bool, device=dev)
    awake = b.awake | wake
    sleep_time = torch.where(wake, 0.0, b.sleep_time)

    can_sleep = (enable_sleep & ((b.flags & ENABLE_SLEEP) != 0)
                 & (b.type == DYNAMIC) & b.enabled)
    eligible = torch.where(b.type == DYNAMIC,
                           can_sleep & (sleep_time >= TIME_TO_SLEEP), True)
    dyn = (b.type == DYNAMIC) & b.enabled
    island_ok = torch.ones(NB + 1, dtype=torch.uint8, device=dev)
    island_ok = island_ok.scatter_reduce(
        0, torch.where(dyn, lab_c, NB), (eligible | ~dyn).to(torch.uint8),
        reduce="amin")
    go_sleep = awake & dyn & (island_ok[lab_c] > 0) & can_sleep
    awake = torch.where(go_sleep, False, awake)
    v = torch.where(go_sleep[:, None], 0.0, b.v)
    w = torch.where(go_sleep, 0.0, b.w)

    bodies = dataclasses.replace(
        b, awake=awake, v=v, w=w, sleep_time=sleep_time, island_label=labels,
        island_fresh=fresh, island_dirty=dirty_out,
        island_split_pending=pend_out)
    return dataclasses.replace(state, bodies=bodies)
