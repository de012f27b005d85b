"""Broadphase: grid-cell candidate pairs and the persistent pair buffer.

Torch port of box2d_tpu/broadphase.py (compute_shape_aabbs :40,
_repair_pairs :157, find_pairs_incremental :309-406, find_pairs :409-667),
each the one-world case of its batched form below.
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


def _box_overlap(a, b):
    return ((a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2])
            & (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3]))


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


def find_pairs_incremental(state: WorldState, cap: Capacity, aabbs, syncs,
                           custom_filter=None):
    """Persistent-pair keep / repair / full tiers
    (box2d_tpu/broadphase.py:309-406): find_pairs_incremental_batched of
    one world. custom_filter (state, shape_a, shape_b) -> keep mask judges
    pairs where they are built, the new pairs of a repair and the whole
    set of a full rebuild. Returns (PairBuffer, new BroadphaseStore,
    cache, orphan_mask, drops, kind) with kind 0/1/2."""
    bp = state.broadphase
    one = lambda x: x.reshape(1)  # noqa: E731
    first = lambda x: x[0]  # noqa: E731
    per_world = ("count", "overflow", "dirty", "cell")
    pair_filter = None
    if custom_filter is not None:
        pair_filter = lambda a, b: torch.as_tensor(  # noqa: E731
            custom_filter(state, a[0], b[0]), dtype=torch.bool)[None]
    pairs, new_bp, cache, orphan, drops, kind = \
        find_pairs_incremental_batched(
            dataclasses.replace(state, broadphase=dataclasses.replace(
                bp, **{k: one(getattr(bp, k)) for k in per_world})),
            cap, aabbs, 1, syncs, pair_filter)
    new_bp = dataclasses.replace(
        new_bp, **{k: first(getattr(new_bp, k)) for k in per_world})
    return (pairs._replace(count=first(pairs.count),
                           overflow=first(pairs.overflow)),
            new_bp, cache, orphan, first(drops), first(kind))


def find_pairs(state: WorldState, cap: Capacity, aabbs) -> PairBuffer:
    """Full rebuild: big-shape pass + grid-cell block-tile pass
    (box2d_tpu/broadphase.py:409-667): find_pairs_batched of one world.
    The step takes it through find_pairs_incremental, which applies the
    custom filter; the phase tests call it alone."""
    pb = find_pairs_batched(state, cap, aabbs, 1)
    return PairBuffer(pb.shape_a, pb.shape_b, pb.valid, pb.count[0],
                      pb.overflow[0])


# ---------------------------------------------------------------------------
# batched worlds
# ---------------------------------------------------------------------------
# The batched step (batch.py) lays W worlds of one capacity side by side on
# one lane axis: world w's shapes are lanes [w * S, (w + 1) * S) and its
# bodies [w * Nb, (w + 1) * Nb), and every shape and body id it holds is
# offset by that much. Lane-wise code runs on that flat state as it is;
# what couples the lanes of one world (a top-k, a sort, a compaction into
# a fixed capacity, a reduction behind a branch) runs here on (W, N) views,
# along the last axis, so that every world keeps its own order, its own
# capacity and its own counts.

def _gather_rows(x, idx):
    """x (W, N, ...) at idx (W, K): (W, K, ...)."""
    tail = tuple(x.shape[2:])
    ix = idx.long().reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return torch.gather(x, 1, ix)


def _scatter_rows_batched(n_rows: int, fill, idx, rows):
    """out[w, idx[w, i]] = rows[w, i] into (W, n_rows, ...) pre-filled with
    `fill`; idx >= n_rows is dropped."""
    n_w = idx.shape[0]
    tail = tuple(rows.shape[idx.dim():])
    out = torch.full((n_w * (n_rows + 1),) + tail, fill, dtype=rows.dtype,
                     device=rows.device)
    base = (torch.arange(n_w, device=idx.device) * (n_rows + 1)).reshape(
        (n_w,) + (1,) * (idx.dim() - 1))
    out[(torch.clamp(idx, max=n_rows) + base).reshape(-1)] = rows.reshape(
        (-1,) + tail)
    return out.reshape((n_w, n_rows + 1) + tail)[:, :n_rows]


def _grid_cell_batched(cap: Capacity, alive, fat_lo, fat_hi):
    """The grid cell size of each world, the widest non-big fat extent
    (find_pairs_batched): alive (W, S), fat (W, S, 2) -> (W,)."""
    S = alive.shape[1]
    B = min(cap.big_shape_cap, max(S - 1, 1))
    extent = torch.where(alive, torch.maximum(fat_hi[..., 0] - fat_lo[..., 0],
                                              fat_hi[..., 1] - fat_lo[..., 1]),
                         float("-inf"))
    kb = min(B + 1, S)
    top_ext, _ = _top_k(extent, kb)
    cell0 = torch.clamp(top_ext[:, kb - 1], min=1e-3)
    genuine = top_ext[:, :B] > 2.0 * cell0[:, None]
    return torch.maximum(cell0, torch.where(genuine, float("-inf"),
                                            top_ext[:, :B]).max(dim=1).values)


def find_pairs_batched(state: WorldState, cap: Capacity, aabbs,
                       n_worlds: int) -> PairBuffer:
    """The full rebuild (box2d_tpu/broadphase.py:409-667) of each of the
    n_worlds worlds of a flat batched state (see above): shape_a /
    shape_b / valid (W * P,) with flat shape ids, count and overflow
    (W,). find_pairs is its one-world case."""
    n_w = n_worlds
    S = aabbs.shape[0] // n_w
    dev = aabbs.device
    win = min(cap.sap_window, max(S - 1, 1))
    B = min(cap.big_shape_cap, max(S - 1, 1))
    P = cap.max_contact_pairs
    sh = state.shapes
    b = state.bodies
    nb = b.center.shape[0] // n_w
    body_l = sh.body.long()
    r = lambda x: x.reshape((n_w, S) + tuple(x.shape[1:]))  # noqa: E731

    alive = r(sh.enabled & b.enabled[body_l] & ~sh.is_sensor)
    box = r(aabbs)
    fat_lo = box[..., :2] - AABB_MARGIN
    fat_hi = box[..., 2:] + AABB_MARGIN
    center = 0.5 * (fat_lo + fat_hi)
    extent = torch.where(alive, torch.maximum(fat_hi[..., 0] - fat_lo[..., 0],
                                              fat_hi[..., 1] - fat_lo[..., 1]),
                         float("-inf"))

    # ---- big-shape pass ----------------------------------------------------
    kb = min(B + 1, S)
    top_ext, bigs = _top_k(extent, kb)
    cell0 = torch.clamp(top_ext[:, kb - 1], min=1e-3)
    bigs = bigs[:, :min(B, S)]
    B = bigs.shape[1]
    genuine = top_ext[:, :B] > 2.0 * cell0[:, None]
    cell = torch.maximum(cell0, torch.where(genuine, float("-inf"),
                                            top_ext[:, :B]).max(dim=1).values)
    big_valid = torch.gather(alive, 1, bigs) & genuine
    is_big = torch.zeros((n_w, S), dtype=torch.bool, device=dev).scatter(
        1, bigs, big_valid)
    all_ids = torch.arange(S, device=dev)
    woff = (torch.arange(n_w, device=dev) * nb)[:, None]
    body_of = r(sh.body).long() - woff               # local body ids
    body_dyn = r(b.type[body_l] == DYNAMIC)
    blo = _gather_rows(fat_lo, bigs)
    bhi = _gather_rows(fat_hi, bigs)
    g_body = torch.gather(body_of, 1, bigs)
    g_dyn = torch.gather(body_dyn, 1, bigs)
    ok_sb = ((fat_lo[:, :, None, 0] <= bhi[:, None, :, 0])
             & (blo[:, None, :, 0] <= fat_hi[:, :, None, 0])
             & (fat_lo[:, :, None, 1] <= bhi[:, None, :, 1])
             & (blo[:, None, :, 1] <= fat_hi[:, :, None, 1])
             & alive[:, :, None] & big_valid[:, None, :]
             & (body_of[:, :, None] != g_body[:, None, :])
             & (body_dyn[:, :, None] | g_dyn[:, None, :])
             & (all_ids[None, :, None] != bigs[:, None, :])
             & (~is_big[:, :, None]
                | (all_ids[None, :, None] < bigs[:, None, :])))
    KB = min(8, B)
    scoreB = torch.where(ok_sb, B - torch.arange(B, device=dev), 0)
    topB, _ = _top_k(scoreB, KB)
    b_slot_ok = topB > 0
    b_partner = torch.gather(
        bigs, 1, torch.clamp(B - topB, 0, B - 1).reshape(n_w, -1)).reshape(
            n_w, S, KB)
    overflow_big = torch.clamp(ok_sb.sum(dim=2) - KB, min=0).sum(dim=1)

    # ---- grid-cell block-tile pass -----------------------------------------
    alive_w = alive & ~is_big
    inv_c = (1.0 / cell)[:, None]
    xi = torch.floor(center[..., 0] * inv_c).to(torch.int32)
    yi = torch.floor(center[..., 1] * inv_c).to(torch.int32)
    key = torch.where(alive_w,
                      (((yi + 0x4000) & 0x7FFF) << 16)
                      | ((xi + 0x8000) & 0xFFFF),
                      torch.tensor(INT32_MAX, dtype=torch.int32, device=dev))
    order = torch.argsort(key, dim=1, stable=True)
    skey = torch.gather(key, 1, order)

    BLK = 128
    T = max(256, ((cap.bp_tile + BLK - 1) // BLK) * BLK)
    K = max(4, min(win, 24))
    n_blk = (S + BLK - 1) // BLK
    S_pad = n_blk * BLK

    unsorted = torch.cat([fat_lo, fat_hi, alive_w.float()[..., None],
                          body_of.float()[..., None],
                          body_dyn.float()[..., None]], dim=2)
    us = _gather_rows(unsorted, order)
    srt = torch.cat([us[..., :4], (skey >> 16).float()[..., None],
                     us[..., 4:]], dim=2)                    # (W, S, 8)
    srt = torch.cat([srt, torch.zeros((n_w, S_pad + T - S, 8), device=dev)],
                    dim=1)
    blocks = srt[:, :S_pad].reshape(n_w, n_blk, BLK, 8)
    tiles = torch.stack(
        [srt[:, k * BLK: k * BLK + S_pad].reshape(n_w, n_blk, BLK, 8)
         for k in range(T // BLK)], dim=2).reshape(n_w, n_blk, T, 8)

    bi = blocks[:, :, :, None, :]
    tj = tiles[:, :, None, :, :]
    l_loc = torch.arange(BLK, device=dev)[:, None]
    t_loc = torch.arange(T, device=dev)[None, :]
    ok = ((bi[..., 0] <= tj[..., 2]) & (tj[..., 0] <= bi[..., 2])
          & (bi[..., 1] <= tj[..., 3]) & (tj[..., 1] <= bi[..., 3])
          & ((tj[..., 4] == bi[..., 4]) | (tj[..., 4] == bi[..., 4] + 1))
          & (t_loc > l_loc)
          & (bi[..., 5] > 0) & (tj[..., 5] > 0)
          & (bi[..., 6] != tj[..., 6])
          & ((bi[..., 7] > 0) | (tj[..., 7] > 0)))

    sh_n = min(T - BLK, S)
    ahead = torch.cat([skey[:, sh_n:], torch.full(
        (n_w, sh_n), INT32_MAX, dtype=torch.int32, device=dev)], dim=1)
    overflow_shapes = ((ahead <= skey + ((1 << 16) + 1))
                       & (skey != INT32_MAX)).sum(dim=1)

    cnt = ok.sum(dim=3)
    score = torch.where(ok, T - t_loc, 0)
    kslot, _ = torch.topk(score, K, dim=3)
    t_base = torch.arange(n_blk, device=dev)[:, None, None] * BLK
    nbr = torch.where(kslot > 0, t_base + (T - kslot), -1).reshape(
        n_w, S_pad, K)
    cnt = cnt.reshape(n_w, S_pad)
    overflow_shapes = overflow_shapes + torch.clamp(cnt - K, min=0).sum(dim=1)
    cntK = torch.clamp(cnt, max=K)

    # ---- each world's slots + one pair scatter ------------------------------
    base_w = torch.cumsum(cntK, 1) - cntK
    count_win = base_w[:, -1] + cntK[:, -1]
    karange = torch.arange(K, device=dev)
    tgt = torch.where((karange < cntK[..., None]) & (nbr >= 0),
                      base_w[..., None] + karange, P)
    pos_i = torch.arange(S_pad, device=dev)[None, :, None].expand(
        n_w, S_pad, K)
    pair_pos = torch.stack([pos_i, torch.clamp(nbr, min=0)], dim=-1)
    pos_ab = _scatter_rows_batched(P, -1, tgt, pair_pos)

    rank_b = torch.cumsum(b_slot_ok.long(), dim=2) - 1
    cnt_b = b_slot_ok.sum(dim=2)
    base_b = count_win[:, None] + torch.cumsum(cnt_b, 1) - cnt_b
    slot_b = torch.where(b_slot_ok, base_b[..., None] + rank_b, P)
    count = count_win + cnt_b.sum(dim=1)
    ids_bg = torch.stack([all_ids[None, :, None].expand(n_w, S, KB),
                          b_partner], dim=-1)
    id_ab = _scatter_rows_batched(P, -1, slot_b, ids_bg)

    from_win = pos_ab[..., 0] >= 0
    ord_pad = torch.cat([order, torch.zeros((n_w, S_pad + T - S),
                                            dtype=order.dtype, device=dev)],
                        dim=1)
    ids_win = torch.gather(ord_pad, 1, torch.clamp(
        pos_ab, 0, S_pad - 1).reshape(n_w, -1)).reshape(n_w, P, 2)
    raw_a = torch.where(from_win, ids_win[..., 0], id_ab[..., 0])
    raw_b = torch.where(from_win, ids_win[..., 1], id_ab[..., 1])
    pair_valid = from_win | (id_ab[..., 0] >= 0)
    soff = (torch.arange(n_w, device=dev) * S)[:, None]
    shape_a = (torch.where(pair_valid, torch.minimum(raw_a, raw_b), 0)
               + soff).reshape(-1)
    shape_b = (torch.where(pair_valid, torch.maximum(raw_a, raw_b), 0)
               + soff).reshape(-1)
    pair_valid = pair_valid.reshape(-1)

    if cap.has_filters:
        pair_valid = pair_valid & _group_pass(sh, shape_a, shape_b)
    if cap.has_joint_exclusions:
        pair_valid = pair_valid & ~_joint_excluded(state, shape_a, shape_b)

    overflow = (overflow_shapes + overflow_big
                + torch.clamp(count - P, min=0)).to(torch.int32)
    return PairBuffer(shape_a.to(torch.int32), shape_b.to(torch.int32),
                      pair_valid, torch.clamp(count, max=P).to(torch.int32),
                      overflow)


def _compact_ids(mask, k):
    """The first k set lanes of each row of a (W, N) mask, ascending, as
    (ids (W, min(k, N)) clipped to range, ok)."""
    n = mask.shape[1]
    big = 1 << 30
    lane = torch.arange(n, dtype=torch.int32, device=mask.device)
    ids = torch.sort(torch.where(mask, lane, big), dim=1).values[:, :min(k, n)]
    return torch.clamp(ids, 0, n - 1), ids < big


def _put_rows(base, tgt, val):
    """base (W, n, ...) with base[w, tgt[w, i]] = val[w, i]; tgt == n is
    dropped (JAX mode="drop")."""
    n = base.shape[1]
    tail = tuple(base.shape[2:])
    ext = torch.cat([base, base[:, :1]], dim=1)
    ix = tgt.reshape(tgt.shape + (1,) * len(tail)).expand(tgt.shape + tail)
    return ext.scatter(1, ix.long(), val.to(base.dtype))[:, :n]


def _repair_pairs(state: WorldState, cap: Capacity, bp, cache, fat_t, esc,
                  wide, n_worlds: int, pair_filter=None):
    """Lane-stable in-place repair of the pair buffer after a few shapes
    escaped their fat AABBs (box2d_tpu/broadphase.py:157-306), in each
    world of a flat batched state: its escape lists capped at
    bp_repair_cap, its new pairs in its own free lanes, its own counts
    (W,). pair_filter(lo, hi): the user's custom filter on the new pairs
    at local shape ids (W, NEW) -> (W, NEW) keep, as in the JAX package
    (:284)."""
    sh = state.shapes
    b = state.bodies
    n_w = n_worlds
    S = fat_t.shape[0] // n_w
    P = bp.shape_a.shape[0] // n_w
    dev = fat_t.device
    r = lambda x: x.reshape((n_w, -1) + tuple(x.shape[1:]))  # noqa: E731
    woff = (torch.arange(n_w, device=dev) * S)[:, None]
    alive = r(bp.alive)
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
    fn_w, of_w, bo_w, dy_w = r(fat_new), r(old_fat), r(body_of), r(dyn)
    eb_w, es_w = r(esc_big), r(esc_small)

    # pass A: escaped small shapes vs everything of their world
    E = min(cap.bp_repair_cap, S)
    eids, e_ok = _compact_ids(es_w, E)
    eg = eids.long() + woff
    ef_new, ef_old = fat_new[eg], old_fat[eg]
    e_body, e_dyn = body_of[eg], dyn[eg]
    now_a = _box_overlap(ef_new[:, :, None, :], fn_w[:, None, :, :])
    was_a = _box_overlap(ef_old[:, :, None, :], of_w[:, None, :, :])
    ok_a = (now_a & ~was_a & e_ok[:, :, None] & alive[:, None, :]
            & (e_body[:, :, None] != bo_w[:, None, :])
            & (e_dyn[:, :, None] | dy_w[:, None, :])
            & (eids[:, :, None] != all_ids[None, None, :])
            & ~eb_w[:, None, :]
            & (~es_w[:, None, :] | (eids[:, :, None] < all_ids)))
    E = eids.shape[1]
    nbr_a, cnt_a = _kth_true(ok_a.reshape(n_w * E, S), all_ids[None, :],
                             _REPAIR_KE)
    ovf_repair = torch.clamp(cnt_a - _REPAIR_KE, min=0).reshape(
        n_w, E).sum(dim=1)

    # pass B: everything vs the escaped big shapes of its world
    gids, g_ok = _compact_ids(eb_w, _REPAIR_EB)
    EB = gids.shape[1]
    gg = gids.long() + woff
    gf_new, gf_old = fat_new[gg], old_fat[gg]
    g_body, g_dyn = body_of[gg], dyn[gg]
    now_b = _box_overlap(fn_w[:, :, None, :], gf_new[:, None, :, :])
    was_b = _box_overlap(of_w[:, :, None, :], gf_old[:, None, :, :])
    ok_b = (now_b & ~was_b & g_ok[:, None, :] & alive[:, :, None]
            & (bo_w[:, :, None] != g_body[:, None, :])
            & (dy_w[:, :, None] | g_dyn[:, None, :])
            & (all_ids[None, :, None] != gids[:, None, :])
            & (~eb_w[:, :, None] | (all_ids[None, :, None]
                                    < gids[:, None, :])))
    nbr_b, cnt_b = _kth_true(
        ok_b.reshape(n_w * S, EB),
        gids[:, None, :].expand(n_w, S, EB).reshape(n_w * S, EB),
        _REPAIR_KB)
    ovf_repair = ovf_repair + torch.clamp(
        cnt_b - _REPAIR_KB, min=0).reshape(n_w, S).sum(dim=1)

    cand_a = torch.cat(
        [eids[:, :, None].expand(n_w, E, _REPAIR_KE).reshape(n_w, -1),
         all_ids.repeat_interleave(_REPAIR_KB)[None, :].expand(n_w, -1)],
        dim=1)
    cand_b = torch.cat([nbr_a.reshape(n_w, -1), nbr_b.reshape(n_w, -1)],
                       dim=1)
    cand_ok = cand_b >= 0
    NEW = min(max(cap.bp_repair_cap, 128), cand_ok.shape[1], P)
    pos, new_ok = _compact_ids(cand_ok, NEW)
    na = torch.gather(cand_a, 1, pos.long())
    nb_ = torch.clamp(torch.gather(cand_b, 1, pos.long()), min=0)
    lo = torch.minimum(na, nb_)
    hi = torch.maximum(na, nb_)
    lo_g, hi_g = lo + woff.to(lo.dtype), hi + woff.to(hi.dtype)

    if cap.has_filters:
        new_ok = new_ok & _group_pass(sh, lo_g.long(), hi_g.long())
    if cap.has_joint_exclusions:
        new_ok = new_ok & ~_joint_excluded(
            state, lo_g.reshape(-1), hi_g.reshape(-1)).reshape(n_w, -1)
    if pair_filter is not None:
        new_ok = new_ok & pair_filter(lo, hi)

    free_lanes, free_ok = _compact_ids(~r(valid2), NEW)
    slot_ok = new_ok & free_ok
    ovf_repair = (ovf_repair + (new_ok & ~free_ok).sum(dim=1)
                  + torch.clamp(cand_ok.sum(dim=1) - NEW, min=0))
    # out-of-range targets land in a dropped extra row (JAX mode="drop")
    tgt = torch.where(slot_ok, free_lanes, P)
    put = lambda base, val: _put_rows(r(base), tgt, val).reshape(  # noqa
        base.shape)
    minus1 = torch.full_like(lo, -1)
    valid3 = put(valid2, torch.ones_like(slot_ok))
    cache2 = dataclasses.replace(
        cache, key_a=put(torch.where(inval, -1, cache.key_a), minus1),
        key_b=put(torch.where(inval, -1, cache.key_b), minus1))
    return (put(bp.shape_a, lo_g), put(bp.shape_b, hi_g), valid3,
            r(valid3).sum(dim=1).to(torch.int32),
            ovf_repair.to(torch.int32), fat_new, cache2, orphan,
            torch.zeros(n_w, dtype=torch.int32, device=dev))


def find_pairs_incremental_batched(state: WorldState, cap: Capacity, aabbs,
                                   n_worlds: int, syncs, pair_filter=None):
    """find_pairs_incremental of each world of a flat batched state: each
    world takes the full, repair or keep tier by its own rule
    (box2d_tpu/broadphase.py:309-406, its must_full, escapes, escaped big
    shapes and overflow). A tier runs when any world takes it, on every
    world, and each world keeps its own tier's outputs (jax.vmap's select
    of the conds). One device read: how many worlds rebuild and how many
    repair. pair_filter(shape_a, shape_b): the user's custom filter at
    local shape ids (W, N) -> (W, N) keep, judging a full rebuild's pairs
    and a repair's new pairs. Returns what find_pairs_incremental returns,
    each world's counts (W,)."""
    from .narrowphase import remap_cache_batched

    n_w = n_worlds
    bp = state.broadphase
    sh = state.shapes
    b = state.bodies
    cache = state.contacts
    S = aabbs.shape[0] // n_w
    P = cache.key_a.shape[0] // n_w
    dev = aabbs.device
    alive = sh.enabled & b.enabled[sh.body.long()] & ~sh.is_sensor
    inside = ((aabbs[:, 0] >= bp.fat[:, 0]) & (aabbs[:, 1] >= bp.fat[:, 1])
              & (aabbs[:, 2] <= bp.fat[:, 2]) & (aabbs[:, 3] <= bp.fat[:, 3]))
    esc = alive & ~inside
    n_esc = esc.reshape(n_w, S).sum(dim=1)
    must_full = bp.dirty | (alive != bp.alive).reshape(n_w, S).any(dim=1)
    fat_t = torch.cat([aabbs[:, :2] - AABB_MARGIN,
                       aabbs[:, 2:] + AABB_MARGIN], -1)
    if cap.bp_repair_cap <= 0:
        full_w = must_full | (n_esc > 0)
        repair_w = torch.zeros_like(full_w)
    else:
        ext_new = torch.where(
            esc,
            torch.maximum(fat_t[:, 2] - fat_t[:, 0],
                          fat_t[:, 3] - fat_t[:, 1]),
            torch.maximum(bp.fat[:, 2] - bp.fat[:, 0],
                          bp.fat[:, 3] - bp.fat[:, 1]))
        wide = ext_new > 1.5 * bp.cell.repeat_interleave(S)
        n_big = (esc & wide).reshape(n_w, S).sum(dim=1)
        full_w = must_full | ((n_esc > 0) & (
            (bp.overflow > 0) | (n_esc > cap.bp_repair_cap)
            | (n_big > _REPAIR_EB)))
        repair_w = ~full_w & (n_esc > 0)
    n_full, n_repair = syncs.read(full_w.sum(), repair_w.sum())
    pick = lambda new, old, m: torch.where(  # noqa: E731
        m.reshape(m.shape + (1,) * (new.dim() - 1)), new, old)
    lane_p = lambda m: m.repeat_interleave(P)  # noqa: E731
    zero_w = torch.zeros(n_w, dtype=torch.int32, device=dev)
    sa, sb, valid, count, ovf = (bp.shape_a, bp.shape_b, bp.valid,
                                 bp.count, bp.overflow)
    fat, cache2, cell, drops = bp.fat, cache, bp.cell, zero_w
    orphan = torch.zeros(n_w * P, dtype=torch.bool, device=dev)

    def take(m, n_m, out):
        """World m's outputs from one tier's (sa, sb, valid, count, ovf,
        fat, cache, orphan, drops); n_m worlds took it (all of them: the
        tier's outputs as they are, as in every single world's step)."""
        if n_m == n_w:
            return out
        lp = lane_p(m)
        return (pick(out[0], sa, lp), pick(out[1], sb, lp),
                pick(out[2], valid, lp), pick(out[3], count, m),
                pick(out[4], ovf, m),
                pick(out[5], fat, m.repeat_interleave(S)),
                dataclasses.replace(cache2, **{
                    f.name: pick(getattr(out[6], f.name),
                                 getattr(cache2, f.name), lp)
                    for f in dataclasses.fields(cache2)}),
                torch.where(lp, out[7], orphan), torch.where(m, out[8], drops))

    if n_full:
        # every world runs the rebuild; each keeps its own tier's outputs
        pb = find_pairs_batched(state, cap, aabbs, n_w)
        if pair_filter is not None:
            soff = (torch.arange(n_w, dtype=pb.shape_a.dtype, device=dev)
                    * S)[:, None]
            keep = pair_filter(pb.shape_a.reshape(n_w, P) - soff,
                               pb.shape_b.reshape(n_w, P) - soff)
            pb = pb._replace(valid=pb.valid & keep.reshape(-1))
        new_ka = torch.where(pb.valid, pb.shape_a, -1)
        new_kb = torch.where(pb.valid, pb.shape_b, -1)
        new_cache, f_orphan, f_drops = remap_cache_batched(
            cache, new_ka, new_kb, cap.max_contact_pairs, n_w, S)
        f_cell = _grid_cell_batched(cap, alive.reshape(n_w, S),
                                    fat_t[:, :2].reshape(n_w, S, 2),
                                    fat_t[:, 2:].reshape(n_w, S, 2))
        sa, sb, valid, count, ovf, fat, cache2, orphan, drops = take(
            full_w, n_full, (pb.shape_a, pb.shape_b, pb.valid, pb.count,
                             pb.overflow, fat_t, new_cache, f_orphan,
                             f_drops))
        cell = torch.where(full_w, f_cell, cell)
    if n_repair:
        rep = _repair_pairs(state, cap, bp, cache, fat_t, esc, wide,
                            n_w, pair_filter)
        sa, sb, valid, count, ovf, fat, cache2, orphan, drops = take(
            repair_w, n_repair, rep)
    kind = torch.where(full_w, 2, torch.where(repair_w, 1, 0)).to(
        torch.int32)
    new_bp = BroadphaseStore(
        fat=fat, alive=alive, shape_a=sa, shape_b=sb, valid=valid,
        count=count, overflow=ovf, dirty=repair_w & (ovf > 0), cell=cell)
    return (PairBuffer(sa, sb, valid, count, ovf), new_bp, cache2, orphan,
            drops, kind)
