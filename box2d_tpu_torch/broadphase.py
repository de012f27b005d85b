"""Broadphase: grid-cell candidate pairs and the persistent pair buffer.

Torch port of box2d_tpu/broadphase.py (compute_shape_aabbs :40,
_repair_pairs :157, find_pairs_incremental :309-406, find_pairs :409-667).
Pair lanes come out in the reference's order, because the contact store and
the coloring priorities are keyed by lane. Where the JAX code relies on an
order guarantee, the port states it:
- `jax.lax.top_k` breaks ties by the lower index; `_top_k` sorts stably on
  the descending value, which gives the same order;
- `jnp.argsort` is stable; the port passes stable=True;
- the int32 cell key is built in int32 and wraps where the JAX key wraps.
The keep / repair / full tiers are `lax.cond`s in JAX; here they are host
branches that cost one device read per step (see world.StepStats).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .constants import AABB_MARGIN
from .state import DYNAMIC, BroadphaseStore, Capacity, WorldState

INT32_MAX = 2**31 - 1


def _top_k(x, k: int):
    """(values, indices) of the k largest entries along the last dim; equal
    values keep ascending index order (jax.lax.top_k's tie-break)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def compute_shape_aabbs(state: WorldState, max_verts: int = 8):
    """World-space AABBs (S, 4) from current body transforms."""
    sh = state.shapes
    b = state.bodies
    V = max(2, min(max_verts, sh.verts.shape[1]))
    pq = torch.cat([b.origin, b.rot], dim=1)[sh.body.long()]
    px, py = pq[:, 0], pq[:, 1]
    qc, qs = pq[:, 2], pq[:, 3]
    tbl = sh.table
    if tbl is not None and tbl.shape[1] == 4 * V + 14:
        vx = [tbl[:, 2 * i] for i in range(V)]
        vy = [tbl[:, 2 * i + 1] for i in range(V)]
        radius = tbl[:, 4 * V]
        count = tbl[:, 4 * V + 1]
    else:
        vx = [sh.verts[:, i, 0] for i in range(V)]
        vy = [sh.verts[:, i, 1] for i in range(V)]
        radius = sh.radius
        count = sh.count.float()
    lox = hix = qc * vx[0] - qs * vy[0] + px
    loy = hiy = qs * vx[0] + qc * vy[0] + py
    for i in range(1, V):
        ok = count > i
        wx = torch.where(ok, qc * vx[i] - qs * vy[i] + px, lox)
        wy = torch.where(ok, qs * vx[i] + qc * vy[i] + py, loy)
        lox = torch.minimum(lox, wx)
        loy = torch.minimum(loy, wy)
        hix = torch.maximum(hix, wx)
        hiy = torch.maximum(hiy, wy)
    return torch.stack([lox - radius, loy - radius,
                        hix + radius, hiy + radius], dim=-1)


class PairBuffer(NamedTuple):
    shape_a: torch.Tensor   # (P,) i32, a < b
    shape_b: torch.Tensor
    valid: torch.Tensor     # (P,) bool
    count: torch.Tensor     # i32
    overflow: torch.Tensor  # i32


def _grid_cell(cap: Capacity, alive, fat_lo, fat_hi):
    """Grid cell size = widest non-big fat extent (see find_pairs)."""
    S = alive.shape[0]
    B = min(cap.big_shape_cap, max(S - 1, 1))
    extent = torch.where(alive, torch.maximum(fat_hi[:, 0] - fat_lo[:, 0],
                                              fat_hi[:, 1] - fat_lo[:, 1]),
                         float("-inf"))
    kb = min(B + 1, S)
    top_ext, _ = _top_k(extent, kb)
    cell0 = torch.clamp(top_ext[kb - 1], min=1e-3)
    genuine = top_ext[:B] > 2.0 * cell0
    return torch.maximum(
        cell0, torch.where(genuine, float("-inf"), top_ext[:B]).max())


def _box_overlap(a, b):
    return ((a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2])
            & (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3]))


def _compact_ids(mask, k):
    """First k set lanes of `mask`, ascending: (ids clipped to range, ok)."""
    n = mask.shape[0]
    big = 1 << 30
    lane = torch.arange(n, dtype=torch.int32, device=mask.device)
    score = torch.where(mask, lane, big)
    ids = torch.sort(score).values[:min(k, n)]
    return torch.clamp(ids, 0, n - 1), ids < big


_REPAIR_KE = 8
_REPAIR_KB = 4
_REPAIR_EB = 8


def _kth_true(ok, ids_row, kslots):
    """(R, N) mask -> (R, kslots) id of the k-th set entry per row (-1 when
    absent): the JAX rank-match reduction max(where(ok & rank==k, id, -1))."""
    rank = torch.cumsum(ok.to(torch.int32), dim=1, dtype=torch.int32) - 1
    cnt = rank[:, -1] + 1
    out = torch.stack(
        [torch.where(ok & (rank == k), ids_row, -1).max(dim=1).values
         for k in range(kslots)], dim=1)
    return out, cnt


def _repair_pairs(state: WorldState, cap: Capacity, bp, cache, fat_t,
                  esc, wide):
    """Lane-stable in-place repair of the pair buffer after a few shapes
    escaped their fat AABBs (box2d_tpu/broadphase.py:157-306)."""
    sh = state.shapes
    b = state.bodies
    S = fat_t.shape[0]
    P = bp.shape_a.shape[0]
    dev = fat_t.device
    alive = bp.alive
    all_ids = torch.arange(S, dtype=torch.int32, device=dev)
    fat_new = torch.where(esc[:, None], fat_t, bp.fat)
    old_fat = bp.fat
    esc_big = esc & wide
    esc_small = esc & ~wide

    ab = torch.stack([bp.shape_a, bp.shape_b], dim=1).long()
    esc_ab = esc[ab]
    touched_lane = bp.valid & (esc_ab[:, 0] | esc_ab[:, 1])
    fr = fat_new[ab]
    still = _box_overlap(fr[:, 0], fr[:, 1])
    valid2 = bp.valid & (~touched_lane | still)
    inval = bp.valid & ~valid2
    orphan = inval & cache.touching

    body_of = sh.body
    dyn = b.type[body_of.long()] == DYNAMIC

    # pass A: escaped small shapes vs everything
    E = min(cap.bp_repair_cap, S)
    eids, e_ok = _compact_ids(esc_small, E)
    el = eids.long()
    ef_new = fat_new[el]
    ef_old = old_fat[el]
    e_body = body_of[el]
    e_dyn = dyn[el]
    now_a = _box_overlap(ef_new[:, None, :], fat_new[None, :, :])
    was_a = _box_overlap(ef_old[:, None, :], old_fat[None, :, :])
    ok_a = (now_a & ~was_a & e_ok[:, None] & alive[None, :]
            & (e_body[:, None] != body_of[None, :])
            & (e_dyn[:, None] | dyn[None, :])
            & (eids[:, None] != all_ids[None, :])
            & ~esc_big[None, :]
            & (~esc_small[None, :] | (eids[:, None] < all_ids[None, :])))
    nbr_a, cnt_a = _kth_true(ok_a, all_ids[None, :], _REPAIR_KE)
    ovf_repair = torch.clamp(cnt_a - _REPAIR_KE, min=0).sum()

    # pass B: everything vs escaped big shapes
    gids, g_ok = _compact_ids(esc_big, _REPAIR_EB)
    gl = gids.long()
    gf_new = fat_new[gl]
    gf_old = old_fat[gl]
    g_body = body_of[gl]
    g_dyn = dyn[gl]
    now_b = _box_overlap(fat_new[:, None, :], gf_new[None, :, :])
    was_b = _box_overlap(old_fat[:, None, :], gf_old[None, :, :])
    ok_b = (now_b & ~was_b & g_ok[None, :] & alive[:, None]
            & (body_of[:, None] != g_body[None, :])
            & (dyn[:, None] | g_dyn[None, :])
            & (all_ids[:, None] != gids[None, :])
            & (~esc_big[:, None] | (all_ids[:, None] < gids[None, :])))
    nbr_b, cnt_b = _kth_true(ok_b, gids[None, :], _REPAIR_KB)
    ovf_repair = ovf_repair + torch.clamp(cnt_b - _REPAIR_KB, min=0).sum()

    cand_a = torch.cat(
        [eids[:, None].expand(nbr_a.shape).reshape(-1),
         all_ids.repeat_interleave(_REPAIR_KB)])
    cand_b = torch.cat([nbr_a.reshape(-1), nbr_b.reshape(-1)])
    cand_ok = cand_b >= 0
    NEW = min(max(cap.bp_repair_cap, 128), cand_ok.shape[0], P)
    pos, new_ok = _compact_ids(cand_ok, NEW)
    na = cand_a[pos.long()]
    nb_ = torch.clamp(cand_b[pos.long()], min=0)
    lo = torch.minimum(na, nb_)
    hi = torch.maximum(na, nb_)

    if cap.has_filters:
        new_ok = new_ok & _group_pass(sh, lo.long(), hi.long())
    if cap.has_joint_exclusions:
        new_ok = new_ok & ~_joint_excluded(state, lo, hi)

    free_lanes, free_ok = _compact_ids(~valid2, NEW)
    slot_ok = new_ok & free_ok
    ovf_repair = (ovf_repair + (new_ok & ~free_ok).sum()
                  + torch.clamp(cand_ok.sum() - NEW, min=0))
    # out-of-range targets land in a dropped extra row (JAX mode="drop")
    tgt = torch.where(slot_ok, free_lanes, P).long()

    def put(base, val):
        ext = torch.cat([base, base[:1]])
        ext[tgt] = val
        return ext[:P]

    sa2 = put(bp.shape_a, lo)
    sb2 = put(bp.shape_b, hi)
    valid3 = put(valid2, torch.ones_like(valid2[:1]).expand(tgt.shape[0]))
    minus1 = torch.full((tgt.shape[0],), -1, dtype=torch.int32, device=dev)
    ka2 = put(torch.where(inval, -1, cache.key_a), minus1)
    kb2 = put(torch.where(inval, -1, cache.key_b), minus1)
    cache2 = dataclasses.replace(cache, key_a=ka2, key_b=kb2)
    count2 = valid3.sum().to(torch.int32)
    return (sa2, sb2, valid3, count2, ovf_repair.to(torch.int32),
            fat_new, cache2, orphan,
            torch.zeros((), dtype=torch.int32, device=dev))


def _joint_excluded(state: WorldState, shape_lo, shape_hi):
    """(N,) pairs whose two bodies are joined by an enabled joint with
    collide_connected == False (ref: src/Joint.cs:293). The JAX code
    compares every pair with every joint, an (N, J) boolean; here the
    unordered body pair is one int64 key looked up in the sorted joint
    keys, which admits the same set."""
    j = state.joints
    nb = state.bodies.center.shape[0]
    body_of = state.shapes.body
    ba = body_of[shape_lo.long()].long()
    bb = body_of[shape_hi.long()].long()
    key = torch.minimum(ba, bb) * nb + torch.maximum(ba, bb)
    ja, jb = j.body_a.long(), j.body_b.long()
    jex = j.enabled & ~j.collide_connected & (j.body_a >= 0)
    jkey = torch.where(jex, torch.minimum(ja, jb) * nb + torch.maximum(ja, jb),
                       -1)
    jsorted = torch.sort(jkey).values
    pos = torch.clamp(torch.searchsorted(jsorted, key),
                      max=jsorted.shape[0] - 1)
    return jsorted[pos] == key


def _group_pass(sh, ia, ib):
    cat = sh.filter_category.to(torch.int64)
    msk = sh.filter_mask.to(torch.int64)
    grp = sh.filter_group
    ga, gb = grp[ia], grp[ib]
    same_group = (ga == gb) & (ga != 0)
    return torch.where(same_group, ga > 0,
                       ((cat[ia] & msk[ib]) != 0) & ((cat[ib] & msk[ia]) != 0))


def find_pairs_incremental(state: WorldState, cap: Capacity, aabbs, syncs):
    """Persistent-pair keep / repair / full tiers
    (box2d_tpu/broadphase.py:309-406). Returns (PairBuffer, new
    BroadphaseStore, cache, orphan_mask, drops, kind) with kind 0/1/2."""
    from .narrowphase import remap_cache

    bp = state.broadphase
    sh = state.shapes
    b = state.bodies
    cache = state.contacts
    P = cache.key_a.shape[0]
    dev = aabbs.device
    alive = sh.enabled & b.enabled[sh.body.long()] & ~sh.is_sensor
    inside = ((aabbs[:, 0] >= bp.fat[:, 0]) & (aabbs[:, 1] >= bp.fat[:, 1])
              & (aabbs[:, 2] <= bp.fat[:, 2]) & (aabbs[:, 3] <= bp.fat[:, 3]))
    esc = alive & ~inside
    n_esc = esc.sum()
    must_full = bp.dirty | (alive != bp.alive).any()
    fat_t = torch.cat([aabbs[:, :2] - AABB_MARGIN,
                       aabbs[:, 2:] + AABB_MARGIN], -1)

    def do_full():
        pb = find_pairs(state, cap, aabbs)
        new_ka = torch.where(pb.valid, pb.shape_a, -1)
        new_kb = torch.where(pb.valid, pb.shape_b, -1)
        new_cache, orphan, drops = remap_cache(
            cache, new_ka, new_kb, cap.max_contact_pairs)
        cell = _grid_cell(cap, alive, fat_t[:, :2], fat_t[:, 2:])
        return (pb.shape_a, pb.shape_b, pb.valid, pb.count, pb.overflow,
                fat_t, new_cache, orphan, drops, cell)

    def keep():
        return (bp.shape_a, bp.shape_b, bp.valid, bp.count, bp.overflow,
                bp.fat, cache, torch.zeros(P, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev), bp.cell)

    if cap.bp_repair_cap <= 0:
        must_full_h, n_esc_h = syncs.read(must_full, n_esc)
        full = must_full_h or n_esc_h > 0
        out = do_full() if full else keep()
        kind = 2 if full else 0
    else:
        ext_new = torch.where(
            esc,
            torch.maximum(fat_t[:, 2] - fat_t[:, 0], fat_t[:, 3] - fat_t[:, 1]),
            torch.maximum(bp.fat[:, 2] - bp.fat[:, 0],
                          bp.fat[:, 3] - bp.fat[:, 1]))
        wide = ext_new > 1.5 * bp.cell
        n_big = (esc & wide).sum()
        must_full_h, n_esc_h, n_big_h, ovf_h = syncs.read(
            must_full, n_esc, n_big, bp.overflow)
        full = must_full_h or (n_esc_h > 0 and (
            ovf_h > 0 or n_esc_h > cap.bp_repair_cap or n_big_h > _REPAIR_EB))
        if full:
            out, kind = do_full(), 2
        elif n_esc_h > 0:
            out = _repair_pairs(state, cap, bp, cache, fat_t, esc, wide) \
                + (bp.cell,)
            kind = 1
        else:
            out, kind = keep(), 0

    sa, sb, valid, count, ovf, fat, cache2, orphan, drops, cell = out
    dirty_out = (ovf > 0) if kind == 1 else torch.zeros(
        (), dtype=torch.bool, device=dev)
    new_bp = BroadphaseStore(
        fat=fat, alive=alive, shape_a=sa, shape_b=sb, valid=valid,
        count=count, overflow=ovf, dirty=dirty_out, cell=cell)
    kind_t = torch.tensor(kind, dtype=torch.int32, device=dev)
    return (PairBuffer(sa, sb, valid, count, ovf), new_bp, cache2, orphan,
            drops, kind_t)


def find_pairs(state: WorldState, cap: Capacity, aabbs) -> PairBuffer:
    """Full rebuild: big-shape pass + grid-cell block-tile pass
    (box2d_tpu/broadphase.py:409-667)."""
    S = aabbs.shape[0]
    dev = aabbs.device
    W = min(cap.sap_window, max(S - 1, 1))
    B = min(cap.big_shape_cap, max(S - 1, 1))
    P = cap.max_contact_pairs
    sh = state.shapes
    b = state.bodies
    body_l = sh.body.long()

    alive = sh.enabled & b.enabled[body_l] & ~sh.is_sensor
    fat_lo = aabbs[:, :2] - AABB_MARGIN
    fat_hi = aabbs[:, 2:] + AABB_MARGIN
    center = 0.5 * (fat_lo + fat_hi)
    extent = torch.where(alive, torch.maximum(fat_hi[:, 0] - fat_lo[:, 0],
                                              fat_hi[:, 1] - fat_lo[:, 1]),
                         float("-inf"))

    # ---- big-shape pass ----------------------------------------------------
    kb = min(B + 1, S)
    top_ext, bigs = _top_k(extent, kb)
    cell0 = torch.clamp(top_ext[kb - 1], min=1e-3)
    bigs = bigs[:min(B, S)]
    B = bigs.shape[0]
    genuine = top_ext[:B] > 2.0 * cell0
    cell = torch.maximum(
        cell0, torch.where(genuine, float("-inf"), top_ext[:B]).max())
    big_valid = alive[bigs] & genuine
    is_big = torch.zeros(S, dtype=torch.bool, device=dev)
    is_big[bigs] = big_valid
    all_ids = torch.arange(S, device=dev)
    body_of = sh.body
    body_dyn = b.type[body_l] == DYNAMIC
    blo = fat_lo[bigs]
    bhi = fat_hi[bigs]
    ok_sb = ((fat_lo[:, 0:1] <= bhi[None, :, 0])
             & (blo[None, :, 0] <= fat_hi[:, 0:1])
             & (fat_lo[:, 1:2] <= bhi[None, :, 1])
             & (blo[None, :, 1] <= fat_hi[:, 1:2])
             & alive[:, None] & big_valid[None, :]
             & (body_of[:, None] != body_of[bigs][None, :])
             & (body_dyn[:, None] | body_dyn[bigs][None, :])
             & (all_ids[:, None] != bigs[None, :])
             & (~is_big[:, None] | (all_ids[:, None] < bigs[None, :])))
    KB = min(8, B)
    scoreB = torch.where(ok_sb, B - torch.arange(B, device=dev)[None, :], 0)
    topB, _ = _top_k(scoreB, KB)
    b_slot_ok = topB > 0
    b_partner = bigs[torch.clamp(B - topB, 0, B - 1)]
    overflow_big = torch.clamp(ok_sb.sum(dim=1) - KB, min=0).sum()

    # ---- grid-cell block-tile pass -----------------------------------------
    alive_w = alive & ~is_big
    inv_c = 1.0 / cell
    xi = torch.floor(center[:, 0] * inv_c).to(torch.int32)
    yi = torch.floor(center[:, 1] * inv_c).to(torch.int32)
    key = torch.where(alive_w,
                      (((yi + 0x4000) & 0x7FFF) << 16)
                      | ((xi + 0x8000) & 0xFFFF),
                      torch.tensor(INT32_MAX, dtype=torch.int32, device=dev))
    order = torch.argsort(key, stable=True)
    skey = key[order]

    BLK = 128
    T = max(256, ((cap.bp_tile + BLK - 1) // BLK) * BLK)
    K = max(4, min(W, 24))
    n_blk = (S + BLK - 1) // BLK
    S_pad = n_blk * BLK

    body_f = sh.body.float()
    dyn_f = body_dyn.float()
    unsorted = torch.cat([fat_lo, fat_hi, alive_w.float()[:, None],
                          body_f[:, None], dyn_f[:, None]], dim=1)
    us = unsorted[order]
    srt = torch.cat([us[:, :4], (skey >> 16).float()[:, None], us[:, 4:]],
                    dim=1)                                   # (S, 8)
    srt = torch.cat([srt, torch.zeros((S_pad + T - S, 8), device=dev)], dim=0)
    blocks = srt[:S_pad].reshape(n_blk, BLK, 8)
    tiles = torch.stack(
        [srt[k * BLK: k * BLK + S_pad].reshape(n_blk, BLK, 8)
         for k in range(T // BLK)], dim=1).reshape(n_blk, T, 8)

    bi = blocks[:, :, None, :]
    tj = tiles[:, None, :, :]
    l_loc = torch.arange(BLK, device=dev)[None, :, None]
    t_loc = torch.arange(T, device=dev)[None, None, :]
    ok = ((bi[..., 0] <= tj[..., 2]) & (tj[..., 0] <= bi[..., 2])
          & (bi[..., 1] <= tj[..., 3]) & (tj[..., 1] <= bi[..., 3])
          & ((tj[..., 4] == bi[..., 4]) | (tj[..., 4] == bi[..., 4] + 1))
          & (t_loc > l_loc)
          & (bi[..., 5] > 0) & (tj[..., 5] > 0)
          & (bi[..., 6] != tj[..., 6])
          & ((bi[..., 7] > 0) | (tj[..., 7] > 0)))

    # coverage overflow (int32 arithmetic wraps like the JAX key compare)
    sh_n = min(T - BLK, S)
    ahead = torch.cat([skey[sh_n:], torch.full(
        (sh_n,), INT32_MAX, dtype=torch.int32, device=dev)])
    overflow_shapes = ((ahead <= skey + ((1 << 16) + 1))
                       & (skey != INT32_MAX)).sum()

    # per-shape K-slot compaction: the k-th set entry of each row, as the
    # JAX rank-match reduction picks it (a top-k over distinct scores)
    cnt = ok.sum(dim=2)
    score = torch.where(ok, T - t_loc, 0)
    kslot, _ = torch.topk(score, K, dim=2)
    t_base = torch.arange(n_blk, device=dev)[:, None, None] * BLK
    nbr = torch.where(kslot > 0, t_base + (T - kslot), -1).reshape(S_pad, K)
    cnt = cnt.reshape(S_pad)
    overflow_shapes = overflow_shapes + torch.clamp(cnt - K, min=0).sum()
    cntK = torch.clamp(cnt, max=K)

    # ---- global slots + one pair scatter -----------------------------------
    base_w = torch.cumsum(cntK, 0) - cntK
    count_win = base_w[-1] + cntK[-1]
    karange = torch.arange(K, device=dev)[None, :]
    tgt = torch.where((karange < cntK[:, None]) & (nbr >= 0),
                      base_w[:, None] + karange, P)
    tgt = torch.clamp(tgt, max=P)                 # >= P rows are dropped
    pos_i = torch.arange(S_pad, device=dev)[:, None].expand(S_pad, K)
    pair_pos = torch.stack([pos_i, torch.clamp(nbr, min=0)], dim=-1)
    pos_ab = torch.full((P + 1, 2), -1, dtype=torch.int64, device=dev)
    pos_ab[tgt.reshape(-1)] = pair_pos.reshape(-1, 2)
    pos_ab = pos_ab[:P]

    rank_b = torch.cumsum(b_slot_ok.long(), dim=1) - 1
    cnt_b = b_slot_ok.sum(dim=1)
    base_b = count_win + torch.cumsum(cnt_b, 0) - cnt_b
    slot_b = torch.clamp(torch.where(b_slot_ok, base_b[:, None] + rank_b, P),
                         max=P)
    count = count_win + cnt_b.sum()
    ids_bg = torch.stack([all_ids[:, None].expand(b_partner.shape),
                          b_partner], dim=-1)
    id_ab = torch.full((P + 1, 2), -1, dtype=torch.int64, device=dev)
    id_ab[slot_b.reshape(-1)] = ids_bg.reshape(-1, 2)
    id_ab = id_ab[:P]

    from_win = pos_ab[:, 0] >= 0
    ord_pad = torch.cat([order, torch.zeros(S_pad + T - S, dtype=order.dtype,
                                            device=dev)])
    ids_win = ord_pad[torch.clamp(pos_ab, 0, S_pad - 1)]
    raw_a = torch.where(from_win, ids_win[:, 0], id_ab[:, 0])
    raw_b = torch.where(from_win, ids_win[:, 1], id_ab[:, 1])
    pair_valid = from_win | (id_ab[:, 0] >= 0)
    shape_a = torch.where(pair_valid, torch.minimum(raw_a, raw_b), 0)
    shape_b = torch.where(pair_valid, torch.maximum(raw_a, raw_b), 0)

    if cap.has_filters:
        pair_valid = pair_valid & _group_pass(sh, shape_a, shape_b)
    if cap.has_joint_exclusions:
        pair_valid = pair_valid & ~_joint_excluded(state, shape_a, shape_b)

    overflow = (overflow_shapes + overflow_big
                + torch.clamp(count - P, min=0)).to(torch.int32)
    return PairBuffer(shape_a.to(torch.int32), shape_b.to(torch.int32),
                      pair_valid, torch.clamp(count, max=P).to(torch.int32),
                      overflow)
