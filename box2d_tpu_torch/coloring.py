"""Incremental constraint-graph coloring (Jones-Plassmann repair rounds).

Torch port of box2d_tpu/coloring.py: `repair_colors` (:161) and
`dense_remap` (:145). The JAX code's `lax.cond` gates and its round
`while_loop` become host branches and a host loop, each costing one device
read (counted in world.StepStats). The priority hash multiplies in int32 with
wrap-around (:282); here it is computed in int64, cut to a signed 32-bit
value and then shifted arithmetically, which gives the same bits.
"""

from __future__ import annotations

import torch

from .state import DYNAMIC

_BIG = 2**31 - 1


def _wrap_i32(x):
    """int64 -> the signed 32-bit value with the same low 32 bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def dense_remap(color, active, max_colors):
    """Remap used colors to a dense 0..k range, order-preserving; along the
    last axis, so a leading world axis remaps each world on its own."""
    ar = torch.arange(max_colors, device=color.device)
    onehot = (color[..., None] == ar) & active[..., None]
    used_c = onehot.any(dim=-2)
    rank = torch.cumsum(used_c.to(torch.int32), -1, dtype=torch.int32) - 1
    ranked = torch.where(onehot, rank[..., None, :], 0).sum(dim=-1)
    return torch.where(active, ranked, -1).to(torch.int32)


def repair_colors(body_a, body_b, active, reserved, prev_color, body_type,
                  num_bodies: int, syncs, max_colors: int = 24,
                  dyn_colors: int = 16, max_rounds: int = 16,
                  repair_cap: int = 4096, color_cap: int | None = None,
                  two_tier: bool = True):
    """Color the active constraints that have no inherited color; see
    box2d_tpu/coloring.py:161-232. Returns raw (not dense-remapped) colors:
    active lanes that found no color this step stay -1."""
    if max_colors > 32:
        raise ValueError(f"max_colors={max_colors}: color masks hold 32 bits")
    n = body_a.shape[0]
    M = min(repair_cap, n)
    todo_full = active & (prev_color < 0)
    (n_todo,) = syncs.read(todo_full.sum())
    if n_todo == 0:
        return prev_color
    M_small = min(512, M)
    if two_tier and M_small < M and n_todo <= M_small:
        M = M_small
    return _repair_rounds(body_a[None], body_b[None], active[None],
                          reserved[None], prev_color[None], body_type,
                          num_bodies, syncs, max_colors, dyn_colors,
                          max_rounds, M, color_cap)[0]


def repair_colors_batched(body_a, body_b, active, reserved, prev_color,
                          body_type, num_bodies: int, syncs,
                          max_colors: int = 24, dyn_colors: int = 16,
                          max_rounds: int = 16, repair_cap: int = 4096,
                          color_cap: int | None = None):
    """repair_colors (one tier, two_tier=False: Capacity.batched) of W
    worlds at once: constraint lanes (W, n) whose endpoints are flat body
    ids (world w's bodies at w * num_bodies, dead endpoints -1),
    body_type (W * num_bodies,). Each world compacts its own uncolored
    lanes, keeps its own per-color counts and priorities; the rounds run
    until no world has a candidate, a finished world's lanes no longer
    change (jax.vmap of the JAX code's while_loop). Reads: whether any
    world has an uncolored lane, then one per round."""
    if max_colors > 32:
        raise ValueError(f"max_colors={max_colors}: color masks hold 32 bits")
    M = min(repair_cap, body_a.shape[1])
    (n_todo,) = syncs.read((active & (prev_color < 0)).sum())
    if n_todo == 0:
        return prev_color
    return _repair_rounds(body_a, body_b, active, reserved, prev_color,
                          body_type, num_bodies, syncs, max_colors,
                          dyn_colors, max_rounds, M, color_cap)


def _repair_rounds(body_a, body_b, active, reserved, prev_color, body_type,
                   num_bodies, syncs, max_colors, dyn_colors, max_rounds, M,
                   color_cap):
    """The Jones-Plassmann rounds of W worlds (box2d_tpu/coloring.py
    :234-330) on a repair buffer of M lanes a world."""
    n_w, n = body_a.shape
    dev = body_a.device
    nb = num_bodies
    spare = n_w * nb
    i32 = dict(dtype=torch.int32, device=dev)
    bit_range = torch.arange(32, **i32)
    col_range = torch.arange(max_colors, **i32)
    dyn = body_type == DYNAMIC
    woff = (torch.arange(n_w, device=dev) * nb)[:, None]
    # a world's endpoint ids wrap within that world, as the single-world
    # code wraps -1 (dead joint lanes)
    ba = (body_a.long() - woff) % nb + woff
    bb = (body_b.long() - woff) % nb + woff

    def slot_of(bidx, isdyn):
        return torch.where(isdyn, bidx, spare)

    hold = (active | reserved) & (prev_color >= 0)
    bit = torch.where(hold, torch.ones_like(prev_color)
                      << torch.clamp(prev_color, 0, 31), 0)
    dyn_a = dyn[ba]
    dyn_b = dyn[bb]
    live_colored = active & (prev_color >= 0)
    idx_all = torch.cat([slot_of(ba, dyn_a).reshape(-1),
                         slot_of(bb, dyn_b).reshape(-1)])
    val_all = torch.cat([torch.where(dyn_a, bit, 0).reshape(-1),
                         torch.where(dyn_b, bit, 0).reshape(-1)])
    used = torch.zeros(spare + 1, **i32).index_add_(0, idx_all, val_all)
    used[spare] = 0
    counts = ((torch.clamp(prev_color, 0, max_colors - 1)[..., None]
               == col_range) & live_colored[..., None]).sum(
        dim=1).to(torch.int32)

    todo = active & (prev_color < 0)
    pos = torch.cumsum(todo.to(torch.int64), 1) - 1
    ext = torch.full((n_w, M + 1), -1, dtype=torch.int64, device=dev)
    ext.scatter_(1, torch.where(todo & (pos < M), pos, M),
                 torch.arange(n, device=dev).expand(n_w, n))
    lane = ext[:, :M]
    cval = lane >= 0
    lane_c = torch.clamp(lane, min=0)
    ca = torch.gather(ba, 1, lane_c)
    cb = torch.gather(bb, 1, lane_c)
    cdyn_a = dyn[ca] & cval
    cdyn_b = dyn[cb] & cval
    both_dyn = cdyn_a & cdyn_b
    cslot_a = slot_of(ca, cdyn_a)
    cslot_b = slot_of(cb, cdyn_b)
    lo = torch.where(both_dyn, 0, dyn_colors)
    hi = torch.where(both_dyn, dyn_colors, max_colors - 1)
    cap = color_cap if color_cap is not None else n
    midx = torch.arange(M, dtype=torch.int64, device=dev)
    h = _wrap_i32(lane_c * -1640531527)
    pri_of = ((((h >> 16) & 0x3FF) << 16) | midx).to(torch.int32)
    cslot_ab = torch.cat([cslot_a.reshape(-1), cslot_b.reshape(-1)])
    pow_c = torch.ones_like(col_range) << col_range
    wm = n_w * M

    ccol = torch.full((n_w, M), -1, **i32)
    any_cand = True
    rounds = 0
    while rounds < max_rounds and any_cand:
        cand = cval & (ccol < 0)
        full_bits = torch.where(counts >= cap, pow_c, 0).sum(dim=1).to(
            torch.int32)
        used_ab = used[cslot_ab]
        forbidden = (used_ab[:wm].reshape(n_w, M)
                     | used_ab[wm:].reshape(n_w, M) | full_bits[:, None])
        free = ((((forbidden[..., None] >> bit_range) & 1) == 0)
                & (bit_range >= lo[..., None])
                & (bit_range < hi[..., None]))
        has_free = free.any(dim=2)
        proposal = torch.argmax(free.to(torch.uint8), dim=2).to(torch.int32)
        cand = cand & has_free

        pri = torch.where(cand, (proposal << 26) | pri_of, _BIG)
        pri2 = torch.cat([pri.reshape(-1), pri.reshape(-1)])
        claims = torch.full((spare + 1,), _BIG, **i32).scatter_reduce(
            0, cslot_ab, pri2, reduce="amin")
        cl_ab = claims[cslot_ab]
        win = (cand & (~cdyn_a | (cl_ab[:wm].reshape(n_w, M) == pri))
               & (~cdyn_b | (cl_ab[wm:].reshape(n_w, M) == pri)))

        seg = torch.where(win, proposal, max_colors)
        onehots = seg[..., None] == col_range
        segc = torch.clamp(seg, 0, max_colors - 1).long()
        ordinal = torch.gather(torch.cumsum(onehots.to(torch.int32), 1,
                                            dtype=torch.int32) - 1,
                               2, segc[..., None])[..., 0]
        room = cap - torch.gather(counts, 1, segc)
        win = win & (ordinal < room)

        ccol = torch.where(win, proposal, ccol)
        counts = counts + (win[..., None] & onehots).sum(dim=1).to(
            torch.int32)
        wbit = torch.where(win, torch.ones_like(proposal) << proposal, 0)
        win2 = torch.cat([torch.where(cdyn_a, wbit, 0).reshape(-1),
                          torch.where(cdyn_b, wbit, 0).reshape(-1)])
        used = used.index_add(0, cslot_ab, win2)
        used[spare] = 0
        (any_cand,) = syncs.read(cand.any())
        rounds += 1

    ext = torch.cat([prev_color, prev_color[:, :1]], dim=1)
    ext.scatter_(1, torch.where(cval & (ccol >= 0), lane_c, n),
                 torch.where(cval, ccol, -1))
    return ext[:, :n]
