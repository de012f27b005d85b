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
    """Wake islands hit by new contacts; put long-still islands to sleep.
    dyn_a/dyn_b are the narrow phase's start-of-step body rows (the slice
    has no particle impulses that could make them stale)."""
    b = state.bodies
    nb = b.center.shape[0]
    tn = state.tuning
    dev = b.center.device
    c_typ_a = dyn_a[:, dyn_col("btype")].to(torch.int32)
    c_typ_b = dyn_b[:, dyn_col("btype")].to(torch.int32)
    c_awk_a = dyn_a[:, dyn_col("awake")] > 0
    c_awk_b = dyn_b[:, dyn_col("awake")] > 0
    c_en_a = dyn_a[:, dyn_col("enabled")] > 0
    c_en_b = dyn_b[:, dyn_col("enabled")] > 0
    lab_a = dyn_a[:, dyn_col("label")].to(torch.int32)
    lab_b = dyn_b[:, dyn_col("label")].to(torch.int32)
    dd = (c_typ_a == DYNAMIC) & (c_typ_b == DYNAMIC)

    any_new = new_touch.any()
    any_lost = lost_touch.any()
    any_new_cross = (new_touch & dd & (lab_a != lab_b)).any()
    any_change = any_new | any_lost
    pend_in = b.island_split_pending | any_lost
    launch = pend_in & ~any_change
    run_labels = b.island_dirty | any_new_cross | launch
    fresh_in = torch.where(launch, torch.arange(nb, dtype=torch.int32,
                                                device=dev), b.island_fresh)
    pend_out = pend_in & ~launch
    any_asleep = (~b.awake & (b.type == DYNAMIC) & b.enabled).any()
    run_labels_h, do_wake_h = syncs.read(run_labels, any_new & any_asleep)

    if run_labels_h:
        jn = state.joints
        j_on = jn.enabled & (jn.body_a >= 0)
        j_dyn_a = b.type[torch.clamp(jn.body_a, 0, nb - 1).long()] == DYNAMIC
        j_dyn_b = b.type[torch.clamp(jn.body_b, 0, nb - 1).long()] == DYNAMIC
        edges_a = torch.cat([body_a, jn.body_a]).long()
        edges_b = torch.cat([body_b, jn.body_b]).long()
        on = torch.cat([touching & dd, j_on & j_dyn_a & j_dyn_b])
        slot_a = torch.where(on, edges_a, nb)
        slot_b = torch.where(on, edges_b, nb)
        ce = torch.clamp(torch.cat([edges_a, edges_b]), 0, nb - 1)
        slot_ab = torch.cat([slot_a, slot_b])
        E = edges_a.shape[0]

        def prop2(l2):
            gg = l2[ce]
            mn = torch.minimum(gg[:E], gg[E:])
            mn2 = torch.cat([mn, mn])
            ext = torch.cat([l2, torch.full((1, 2), _LARGE, dtype=torch.int32,
                                            device=dev)])
            ext = ext.scatter_reduce(0, slot_ab[:, None].expand(-1, 2), mn2,
                                     reduce="amin")
            return ext[:nb]

        lab2 = torch.stack([b.island_label, fresh_in], dim=1)
        for _ in range(4):
            lab2 = prop2(lab2)
        snap4 = lab2
        lab2 = prop2(lab2)
        converged = (lab2 == snap4).all()
        labels = torch.where(converged, snap4[:, 1], lab2[:, 0])
        fresh = torch.where(converged, torch.arange(
            nb, dtype=torch.int32, device=dev), lab2[:, 1])
        dirty_out = ~converged
    else:
        labels, fresh = b.island_label, fresh_in
        dirty_out = torch.zeros((), dtype=torch.bool, device=dev)

    lab_c = torch.clamp(labels, 0, nb).long()
    if do_wake_h:
        mover_a = c_awk_a & (c_typ_a != 0) & c_en_a
        mover_b = c_awk_b & (c_typ_b != 0) & c_en_b
        hit = new_touch & ((~c_awk_a & mover_b) | (~c_awk_b & mover_a))
        hit2 = torch.cat([hit, hit])
        # every write stores True; the spare row nb takes the no-op lanes
        woken = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
        woken[torch.where(hit2, torch.cat([body_a, body_b]).long(), nb)] = True
        island_woken = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
        island_woken[torch.where(woken[:nb], lab_c, nb)] = True
        wake = island_woken[lab_c] & (b.type == DYNAMIC)
    else:
        wake = torch.zeros(nb, dtype=torch.bool, device=dev)
    awake = b.awake | wake
    sleep_time = torch.where(wake, 0.0, b.sleep_time)

    can_sleep = (tn.enable_sleep & ((b.flags & ENABLE_SLEEP) != 0)
                 & (b.type == DYNAMIC) & b.enabled)
    eligible = torch.where(b.type == DYNAMIC,
                           can_sleep & (sleep_time >= TIME_TO_SLEEP), True)
    dyn = (b.type == DYNAMIC) & b.enabled
    island_ok = torch.ones(nb + 1, dtype=torch.uint8, device=dev)
    island_ok = island_ok.scatter_reduce(
        0, torch.where(dyn, lab_c, nb), (eligible | ~dyn).to(torch.uint8),
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
