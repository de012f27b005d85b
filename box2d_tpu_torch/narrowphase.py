"""Narrow phase: manifolds for candidate pairs + warm-start matching.

Torch port of box2d_tpu/narrowphase.py for circles, capsules, segments,
polygons and chain segments: pairs are oriented canonically (a chain
segment always A, a circle always B), each pair class present in the
scene is evaluated over the whole pair buffer and lanes take their
class's result. The contact store keeps the reference's hash: the murmur
mix that the JAX code runs in uint32 (narrowphase.py:334-341) runs here
in int64 with `& 0xFFFFFFFF` after every step, which gives the same
bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as g
from . import manifold as mfm
from . import math2d as m
from .broadphase import PairBuffer
from .state import ContactStore, WorldState

CLS_CIRCLES = "circles"
CLS_CAPSULE_CIRCLE = "capsule_circle"
CLS_POLY_CIRCLE = "poly_circle"
CLS_CAPSULES = "capsules"
CLS_POLYS = "polys"
CLS_CHAIN_CIRCLE = "chain_circle"
CLS_CHAIN_POLY = "chain_poly"


def classes_for_shape_types(types) -> frozenset:
    """Host-side: which pair classes can occur given the shape types
    present (same names and rules as the JAX package)."""
    ts = set(int(x) for x in types)
    has_circle = g.CIRCLE in ts
    has_cap2 = bool(ts & {g.CAPSULE, g.SEGMENT})
    has_poly = g.POLYGON in ts
    has_chain = g.CHAIN_SEGMENT in ts
    out = set()
    if has_circle:
        out.add(CLS_CIRCLES)
        if has_cap2:
            out.add(CLS_CAPSULE_CIRCLE)
        if has_poly:
            out.add(CLS_POLY_CIRCLE)
        if has_chain:
            out.add(CLS_CHAIN_CIRCLE)
    if has_cap2:
        out.add(CLS_CAPSULES)
    if has_poly and (has_cap2 or has_poly):
        out.add(CLS_POLYS)
    if has_chain and (has_cap2 or has_poly):
        out.add(CLS_CHAIN_POLY)
    return frozenset(out)


class ContactData(NamedTuple):
    """Per-candidate-pair narrow phase output (P lanes)."""

    shape_a: torch.Tensor
    shape_b: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    key_a: torch.Tensor
    key_b: torch.Tensor
    manifold: mfm.Manifold
    friction: torch.Tensor
    restitution: torch.Tensor
    rolling_resistance: torch.Tensor
    tangent_speed: torch.Tensor
    normal_impulse: torch.Tensor
    tangent_impulse: torch.Tensor
    rolling_impulse: torch.Tensor
    was_touching: torch.Tensor
    prev_color: torch.Tensor
    dyn_a: torch.Tensor   # (P, N_DYN) start-of-step body rows, see _DYN
    dyn_b: torch.Tensor
    ev_contact: torch.Tensor
    ev_hit: torch.Tensor


_DYN = dict(ox=0, oy=1, qc=2, qs=3, offx=4, offy=5, vx=6, vy=7, w=8,
            inv_m=9, inv_i=10, btype=11, awake=12, enabled=13, label=14)
N_DYN = 15


def dyn_col(name: str) -> int:
    return _DYN[name]


def build_static_table(sh, V: int):
    """Static half of the packed shape table (S, 4V+14)."""
    S = sh.type.shape[0]
    f = lambda x: x.float()[:, None]
    return torch.cat([
        sh.verts[:, :V].reshape(S, 2 * V),
        sh.normals[:, :V].reshape(S, 2 * V),
        sh.radius[:, None], f(sh.count), f(sh.type),
        sh.ghost1, sh.ghost2,
        sh.friction[:, None], sh.restitution[:, None],
        sh.rolling_resistance[:, None], sh.tangent_speed[:, None],
        f(sh.enable_contact_events), f(sh.enable_hit_events), f(sh.body),
    ], dim=1)


def build_shape_table(state: WorldState, V: int):
    """Packed per-shape operand table (S, 4V+14+N_DYN): static columns plus
    each shape's body row (one gather)."""
    sh = state.shapes
    b = state.bodies
    off = m.rot_vec(b.rot, b.local_center)
    f = lambda x: x.float()[:, None]
    pose = torch.cat([
        b.origin, b.rot, off, b.v, b.w[:, None],
        b.inv_mass[:, None], b.inv_inertia[:, None],
        f(b.type), f(b.awake), f(b.enabled), f(b.island_label),
    ], dim=1)
    dyn = pose[sh.body.long()]
    static = sh.table
    if static is None or static.shape[1] != 4 * V + 14:
        static = build_static_table(sh, V)
    return torch.cat([static, dyn], dim=1)


def _static_cols(V: int):
    names = ("radius", "count", "type", "g1x", "g1y", "g2x", "g2y",
             "friction", "restitution", "rolling", "tspeed", "evc", "evh",
             "body")
    return {n: 4 * V + i for i, n in enumerate(names)}


def narrow_phase(state: WorldState, pairs: PairBuffer,
                 classes_present: frozenset, max_verts: int = 8,
                 stats=None) -> ContactData:
    """stats (world.StepStats) counts the device reads of the chain
    polygon class's GJK loop."""
    sh = state.shapes
    V = max(2, min(max_verts, sh.verts.shape[1]))
    tbl = build_shape_table(state, V)
    C = _static_cols(V)
    D0 = 4 * V + 14
    rA0 = tbl[pairs.shape_a.long()]
    rB0 = tbl[pairs.shape_b.long()]
    ta0 = rA0[:, C["type"]].to(torch.int32)
    tb0 = rB0[:, C["type"]].to(torch.int32)

    # canonical orientation: chain -> A, circle -> B
    swap = (((tb0 == g.CHAIN_SEGMENT) & (ta0 != g.CHAIN_SEGMENT))
            | ((ta0 == g.CIRCLE) & (tb0 != g.CIRCLE)))
    sa = torch.where(swap, pairs.shape_b, pairs.shape_a)
    sb = torch.where(swap, pairs.shape_a, pairs.shape_b)
    sw = swap[:, None]
    rA = torch.where(sw, rB0, rA0)
    rB = torch.where(sw, rA0, rB0)
    ta = torch.where(swap, tb0, ta0)
    tb = torch.where(swap, ta0, tb0)

    P = sa.shape[0]
    body_a = rA[:, C["body"]].to(torch.int32)
    body_b = rB[:, C["body"]].to(torch.int32)
    pa, qa = rA[:, D0:D0 + 2], rA[:, D0 + 2:D0 + 4]
    pb, qb = rB[:, D0:D0 + 2], rB[:, D0 + 2:D0 + 4]
    va = rA[:, :2 * V].reshape(P, V, 2)
    na = rA[:, 2 * V:4 * V].reshape(P, V, 2)
    ca, ra = rA[:, C["count"]].to(torch.int32), rA[:, C["radius"]]
    vb = rB[:, :2 * V].reshape(P, V, 2)
    nb = rB[:, 2 * V:4 * V].reshape(P, V, 2)
    cb, rb = rB[:, C["count"]].to(torch.int32), rB[:, C["radius"]]
    ghost1_a = rA[:, C["g1x"]:C["g1x"] + 2]
    ghost2_a = rA[:, C["g2x"]:C["g2x"] + 2]

    out = _zero_manifold(P, sa.device)

    def merge(mask, new):
        return mfm.Manifold(*[
            torch.where(mask.reshape((P,) + (1,) * (o.dim() - 1)), n, o)
            for o, n in zip(out, new)])

    a_cap2 = (ta == g.CAPSULE) | (ta == g.SEGMENT)
    if CLS_CIRCLES in classes_present:
        man = mfm.collide_circles(va[:, 0], ra, pa, qa, vb[:, 0], rb, pb, qb)
        out = merge((ta == g.CIRCLE) & (tb == g.CIRCLE), man)
    if CLS_CAPSULE_CIRCLE in classes_present:
        man = mfm.collide_capsule_circle(va[:, 0], va[:, 1], ra, pa, qa,
                                         vb[:, 0], rb, pb, qb)
        out = merge(a_cap2 & (tb == g.CIRCLE), man)
    if CLS_POLY_CIRCLE in classes_present:
        man = mfm.collide_polygon_circle(va, na, ca, ra, pa, qa, vb[:, 0],
                                         rb, pb, qb)
        out = merge((ta == g.POLYGON) & (tb == g.CIRCLE), man)
    if CLS_CHAIN_CIRCLE in classes_present:
        man = mfm.collide_chain_segment_circle(
            va[:, 0], va[:, 1], ghost1_a, ghost2_a, pa, qa, vb[:, 0], rb,
            pb, qb)
        out = merge((ta == g.CHAIN_SEGMENT) & (tb == g.CIRCLE), man)
    if CLS_CAPSULES in classes_present:
        man = mfm.collide_capsules(va[:, 0], va[:, 1], ra, pa, qa,
                                   vb[:, 0], vb[:, 1], rb, pb, qb)
        out = merge(a_cap2 & ((tb == g.CAPSULE) | (tb == g.SEGMENT)), man)
    if CLS_POLYS in classes_present:
        man = mfm.collide_polygons_batched(va, na, ca, ra, pa, qa,
                                           vb, nb, cb, rb, pb, qb)
        apoly = (ta == g.POLYGON) | (tb == g.POLYGON)
        not_special = (ta != g.CHAIN_SEGMENT) & (tb != g.CIRCLE)
        out = merge(apoly & not_special, man)
    if CLS_CHAIN_POLY in classes_present:
        lanes = (ta == g.CHAIN_SEGMENT) & (tb != g.CIRCLE)
        man = mfm.collide_chain_segment_polygon(
            va[:, 0], va[:, 1], ghost1_a, ghost2_a, pa, qa, vb, nb, cb, rb,
            pb, qb, active=lanes, stats=stats)
        out = merge(lanes, man)
    out = out._replace(point_count=torch.where(pairs.valid, out.point_count,
                                               0))

    fr_a, fr_b = rA[:, C["friction"]], rB[:, C["friction"]]
    re_a, re_b = rA[:, C["restitution"]], rB[:, C["restitution"]]
    ro_a, ro_b = rA[:, C["rolling"]], rB[:, C["rolling"]]
    friction = torch.sqrt(fr_a * fr_b)
    restitution = torch.maximum(re_a, re_b)
    rr = torch.where((ro_a > 0) | (ro_b > 0),
                     torch.maximum(ro_a, ro_b) * torch.maximum(ra, rb), 0.0)
    tangent_speed = rA[:, C["tspeed"]] + rB[:, C["tspeed"]]

    off_a = rA[:, D0 + 4:D0 + 6]
    off_b = rB[:, D0 + 4:D0 + 6]
    out = out._replace(anchor_a=out.anchor_a - off_a[:, None, :],
                       anchor_b=out.anchor_b - off_b[:, None, :])

    key_a = torch.where(pairs.valid, torch.minimum(sa, sb), -1)
    key_b = torch.where(pairs.valid, torch.maximum(sa, sb), -1)
    ni, ti, ri, was_touching, prev_color = _match_warm_start(
        state.contacts, key_a, key_b, out.ids)
    return ContactData(
        shape_a=sa, shape_b=sb, body_a=body_a, body_b=body_b,
        key_a=key_a, key_b=key_b, manifold=out, friction=friction,
        restitution=restitution, rolling_resistance=rr,
        tangent_speed=tangent_speed, normal_impulse=ni, tangent_impulse=ti,
        rolling_impulse=ri, was_touching=was_touching, prev_color=prev_color,
        dyn_a=rA[:, D0:], dyn_b=rB[:, D0:],
        ev_contact=(rA[:, C["evc"]] > 0) & (rB[:, C["evc"]] > 0),
        ev_hit=(rA[:, C["evh"]] > 0) | (rB[:, C["evh"]] > 0),
    )


def _zero_manifold(P, device) -> mfm.Manifold:
    z = lambda *sh: torch.zeros((P,) + sh, dtype=torch.float32,
                                device=device)
    zi = lambda *sh: torch.zeros((P,) + sh, dtype=torch.int32, device=device)
    return mfm.Manifold(z(2), zi(), z(2, 2), z(2, 2), z(2, 2), z(2), zi(2))


_PROBES = 8
_M32 = 0xFFFFFFFF


def table_size(capacity_pairs: int) -> int:
    """Next power of two >= 2x the pair capacity (at least 1024)."""
    t = 1024
    while t < 2 * capacity_pairs:
        t *= 2
    return t


def _probe_slots(key_a, key_b, t: int):
    """(P, _PROBES) slots: the murmur3-style mix of the JAX code, computed in
    int64 and cut to 32 bits after every multiply and add."""
    x = ((key_a.to(torch.int64) & _M32) * 0x9E3779B9
         + (key_b.to(torch.int64) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    h = x & (t - 1)
    return (h[:, None] + torch.arange(_PROBES, device=key_a.device)[None, :]) \
        & (t - 1)


def _match_warm_start(cache: ContactStore, new_ka, new_kb, new_ids):
    """Lane-wise (key, feature id) impulse transfer (ref:
    src/Contact.cs:385-413)."""
    found = ((cache.key_a == new_ka) & (cache.key_b == new_kb)
             & (new_ka >= 0))
    old_ids = cache.ids
    old_ni = cache.normal_impulse
    old_ti = cache.tangent_impulse

    def match_point(j):
        same0 = found & (new_ids[:, j] == old_ids[:, 0])
        same1 = found & (new_ids[:, j] == old_ids[:, 1])
        ni = torch.where(same0, old_ni[:, 0],
                         torch.where(same1, old_ni[:, 1], 0.0))
        ti = torch.where(same0, old_ti[:, 0],
                         torch.where(same1, old_ti[:, 1], 0.0))
        return ni, ti

    ni0, ti0 = match_point(0)
    ni1, ti1 = match_point(1)
    rolling = torch.where(found, cache.rolling_impulse, 0.0)
    was_touching = found & cache.touching
    prev_color = torch.where(found, cache.color, -1)
    return (torch.stack([ni0, ni1], dim=1), torch.stack([ti0, ti1], dim=1),
            rolling, was_touching, prev_color)


def empty_cache(P: int, device) -> ContactStore:
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return ContactStore(
        key_a=torch.full((P,), -1, **i32),
        key_b=torch.full((P,), -1, **i32),
        ids=torch.zeros((P, 2), **i32),
        normal_impulse=torch.zeros((P, 2), **f32),
        tangent_impulse=torch.zeros((P, 2), **f32),
        rolling_impulse=torch.zeros(P, **f32),
        touching=torch.zeros(P, dtype=torch.bool, device=device),
        color=torch.full((P,), -1, **i32),
    )


def remap_cache(old_cache: ContactStore, new_ka, new_kb,
                capacity_pairs: int):
    """Re-align the per-lane contact cache to a rebuilt pair buffer through
    a transient open-addressed table (box2d_tpu/narrowphase.py:393-484):
    remap_cache_batched of one world. Returns (new_cache, orphan_mask,
    drops)."""
    new_cache, orphan, drops = remap_cache_batched(
        old_cache, new_ka, new_kb, capacity_pairs, 1, 0)
    return new_cache, orphan, drops[0]


def update_cache(data: ContactData, color=None) -> ContactStore:
    """This step's pair-order results become the per-lane cache."""
    touching = (data.manifold.point_count > 0) & (data.key_a >= 0)
    if color is None:
        color = torch.full_like(data.key_a, -1)
    return ContactStore(
        key_a=data.key_a, key_b=data.key_b, ids=data.manifold.ids,
        normal_impulse=data.normal_impulse,
        tangent_impulse=data.tangent_impulse,
        rolling_impulse=data.rolling_impulse,
        touching=touching,
        color=torch.where(touching, color, -1),
    )


def remap_cache_batched(old_cache: ContactStore, new_ka, new_kb,
                        capacity_pairs: int, n_worlds: int, n_shapes: int):
    """The contact store's remap of each world of a flat batched state
    (broadphase.py, "batched worlds"): the keys are flat shape ids, world
    w's lanes are [w * P, (w + 1) * P). Old lanes probe-insert into a
    transient open-addressed table (each round, pending lanes claim their
    slot if it was empty before the round; races resolve by the lowest
    lane id), then each new key looks its old lane up. Each world probes
    its own table of the same size with its own local keys, so its slots,
    races and drops are those of a single world. Returns (new_cache,
    orphan_mask, drops (W,))."""
    t = table_size(capacity_pairs)
    ka, kb = old_cache.key_a, old_cache.key_b
    n = ka.shape[0]
    P = n // n_worlds
    dev = ka.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    world = lane.long() // P
    soff = world * n_shapes
    local = lambda k: torch.where(k >= 0, k - soff, -1)  # noqa: E731
    toff = (world * t)[:, None]
    spare = n_worlds * t
    live = ka >= 0
    big = 1 << 30

    slots = _probe_slots(local(ka), local(kb), t) + toff
    tbl_lane = torch.full((spare + 1,), big, dtype=torch.int32, device=dev)
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for r in range(_PROBES):
        s_r = slots[:, r]
        pend = live & (slot_of < 0)
        cand = pend & (tbl_lane[s_r] == big)
        tbl_lane = tbl_lane.scatter_reduce(
            0, torch.where(cand, s_r, spare), torch.where(cand, lane, big),
            reduce="amin")
        won = cand & (tbl_lane[s_r] == lane)
        slot_of = torch.where(won, s_r, slot_of)
    drops = (live & (slot_of < 0)).reshape(n_worlds, P).sum(dim=1).to(
        torch.int32)

    rows = torch.stack([lane, ka, kb], dim=1)
    tbl = torch.full((spare + 1, 3), -1, dtype=torch.int32, device=dev)
    tbl[torch.where(slot_of >= 0, slot_of, spare)] = rows
    tbl[spare] = -1

    nslots = _probe_slots(local(new_ka), local(new_kb), t) + toff
    live_new = new_ka >= 0
    old_lane_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for r in range(_PROBES):
        row = tbl[nslots[:, r]]
        ok = (live_new & (old_lane_s < 0)
              & (row[:, 1] == new_ka) & (row[:, 2] == new_kb))
        old_lane_s = torch.where(ok, row[:, 0], old_lane_s)
    found = old_lane_s >= 0
    old_lane = torch.clamp(old_lane_s, min=0).long()

    f = found
    new_cache = ContactStore(
        key_a=new_ka, key_b=new_kb,
        ids=torch.where(f[:, None], old_cache.ids[old_lane], 0),
        normal_impulse=torch.where(f[:, None],
                                   old_cache.normal_impulse[old_lane], 0.0),
        tangent_impulse=torch.where(f[:, None],
                                    old_cache.tangent_impulse[old_lane], 0.0),
        rolling_impulse=torch.where(f, old_cache.rolling_impulse[old_lane],
                                    0.0),
        touching=f & old_cache.touching[old_lane],
        color=torch.where(f, old_cache.color[old_lane], -1),
    )
    claimed = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    claimed[torch.where(found, old_lane, n)] = True
    claimed[n] = False
    orphan = live & old_cache.touching & ~claimed[:n]
    return new_cache, orphan, drops
