"""LiquidFun's water step for particles among static boxes, in plain
PyTorch over every live particle at once (any device, float32).

Written from LiquidFun's b2ParticleSystem::Solve (ParticleSystem.cpp:
UpdateContacts, UpdateBodyContacts, ComputeWeight, SolveGravity,
SolvePressure, SolveDamping, LimitVelocity, SolveCollision, the final
integration) as the scalar transcription tests/oracle_particles.py
(at commit cc11e5e) has it, with its two stated deviations from upstream:
a particle's distance to a box is to the box's surface, negative inside;
SolveCollision does not add the removed momentum back as a force. It
finds its own neighbours (a grid of diameter-wide cells) and its own
particle-box contacts each iteration. Each pass sums over all contacts at
once (Jacobi within a pass, passes in LiquidFun's order), which is the
engine's stated form of LiquidFun's per-contact loops.

`step` takes the primary state only (positions and velocities of the live
particles, the world of each) with the scene (the static boxes, radius,
gravity) and each particle's fluid parameters; nothing else."""

from __future__ import annotations

import math

import numpy as np
import torch

F = np.float32
MAX_PRESSURE = F(0.25)      # b2_maxParticlePressure
MIN_WEIGHT = F(1.0)         # b2_minParticleWeight
LINEAR_SLOP = F(0.005)      # b2_linearSlop, the ray's stand-off


def pairs_within(pos, world, diameter):
    """(i, j), i < j, of every two particles of one world closer than one
    diameter: a grid of diameter-wide cells, each particle against the
    particles of its 3 x 3 cells."""
    dev = pos.device
    n = pos.shape[0]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n < 2:
        return empty, empty
    cell = torch.floor(pos / float(diameter)).to(torch.int64)
    cell = cell - cell.min(0).values + 1
    nx = int(cell[:, 0].max()) + 2
    ny = int(cell[:, 1].max()) + 2
    key = (world * ny + cell[:, 1]) * nx + cell[:, 0]
    order = torch.argsort(key)
    ks = key[order]
    d2 = float(diameter) * float(diameter)
    out_i, out_j = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = ks + dy * nx + dx
            lo = torch.searchsorted(ks, k)
            width = torch.searchsorted(ks, k, right=True) - lo
            for t in range(int(width.max())):
                at = torch.nonzero(width > t).squeeze(1)
                a, b = order[at], order[lo[at] + t]
                keep = a < b
                a, b = a[keep], b[keep]
                d = pos[b] - pos[a]
                near = (d * d).sum(1) < d2
                out_i.append(a[near])
                out_j.append(b[near])
    if not out_i:
        return empty, empty
    return torch.cat(out_i), torch.cat(out_j)


def box_distance(pos, centers, halves):
    """(distance (n, B), outward normal (n, B, 2)) of each particle to the
    surface of each box, negative inside (the deepest face)."""
    q = pos[:, None, :] - centers[None]
    dx = q[..., 0].abs() - halves[None, :, 0]
    dy = q[..., 1].abs() - halves[None, :, 1]
    sx = torch.where(q[..., 0] >= 0, 1.0, -1.0)
    sy = torch.where(q[..., 1] >= 0, 1.0, -1.0)
    outside = (dx > 0) | (dy > 0)
    ox, oy = dx.clamp(min=0), dy.clamp(min=0)
    d_out = torch.hypot(ox, oy)
    safe = torch.where(d_out > 0, d_out, 1.0)
    n_out = torch.stack([sx * ox / safe, sy * oy / safe], -1)
    x_face = dx > dy
    d_in = torch.where(x_face, dx, dy)
    zero = torch.zeros_like(sx)
    n_in = torch.stack([torch.where(x_face, sx, zero),
                        torch.where(x_face, zero, sy)], -1)
    d = torch.where(outside, d_out, d_in)
    n = torch.where(outside[..., None], n_out, n_in)
    return d, n


def ray_boxes(p1, d, centers, halves):
    """The slab ray from p1 along d (fraction 0 to 1) against each box:
    (hit (n, B), fraction (n, B), normal of the entering face (n, B, 2)).
    A ray that starts inside a box, or enters through no face, misses."""
    n, nb = p1.shape[0], centers.shape[0]
    dev = p1.device
    lo = torch.zeros((n, nb), device=dev)
    hi = torch.ones((n, nb), device=dev)
    miss = torch.zeros((n, nb), dtype=torch.bool, device=dev)
    nrm = torch.zeros((n, nb, 2), device=dev)
    for ax in range(2):
        o = p1[:, None, ax] - centers[None, :, ax]
        h = halves[None, :, ax].expand(n, nb)
        dax = d[:, None, ax].expand(n, nb)
        flat = dax.abs() < 1e-12
        miss = miss | (flat & (o.abs() > h))
        inv = 1.0 / torch.where(flat, 1.0, dax)
        t1, t2 = (-h - o) * inv, (h - o) * inv
        swap = t1 > t2
        sgn = torch.where(swap, 1.0, -1.0)
        t1, t2 = torch.where(swap, t2, t1), torch.where(swap, t1, t2)
        enter = ~flat & (t1 > lo)
        lo = torch.where(enter, t1, lo)
        face = torch.zeros((n, nb, 2), device=dev)
        face[..., ax] = sgn
        nrm = torch.where(enter[..., None], face, nrm)
        hi = torch.where(flat, hi, torch.minimum(hi, t2))
        miss = miss | (~flat & (lo > hi))
    hit = ~miss & (lo > 0) & (nrm != 0).any(-1)
    return hit, lo, nrm


def step(pos, vel, world, prm, boxes, radius, gravity, dt, iterations):
    """One step of the live particles: pos, vel (n, 2) float32, world (n,)
    int64, prm {pressure_strength, damping_strength, density: (n,)}; boxes
    (centers (B, 2), halves (B, 2)). Returns the new (pos, vel)."""
    centers, halves = boxes
    h = F(dt) / F(iterations)
    inv_h = F(1.0) / h
    r = F(radius)
    diam = F(2.0) * r
    inv_d = F(1.0) / diam
    crit_v = diam * inv_h
    crit_v2 = crit_v * crit_v
    density = prm["density"]
    crit_p = density * float(crit_v2)
    mass = density * float(r) * float(r) * float(F(math.pi))
    inv_mass = 1.0 / mass
    m_c = 1.0 / inv_mass
    ppw = prm["pressure_strength"] * crit_p
    maxp = float(MAX_PRESSURE) * crit_p
    vpp = float(h) * (1.0 / density) * float(inv_d)
    lin_d = prm["damping_strength"]
    quad_d = float(F(1.0) / crit_v)
    g = torch.tensor(np.asarray(gravity, F) * h, device=pos.device)
    n = pos.shape[0]

    def add(idx, v):
        return torch.zeros((n,) + v.shape[1:], device=pos.device).index_add_(
            0, idx, v)

    for _ in range(iterations):
        i, j = pairs_within(pos, world, diam)
        diff = pos[j] - pos[i]
        dd = (diff * diff).sum(1)
        inv_dist = torch.where(dd > 0, 1.0 / torch.sqrt(dd), 0.0)
        w = 1.0 - dd * inv_dist * float(inv_d)
        nrm = diff * inv_dist[:, None]
        bd, bn = box_distance(pos, centers, halves)
        b_ok = bd < float(r)
        bw = torch.where(b_ok, 1.0 - bd * float(inv_d) * 2.0, 0.0)
        bnrm = -bn
        weight = bw.sum(1) + add(i, w) + add(j, w)
        vel = vel + g
        # pressure
        accum = torch.minimum(
            ppw * torch.clamp(weight - float(MIN_WEIGHT), min=0.0), maxp)
        fb = (vpp[:, None] * bw * m_c[:, None]
              * (accum[:, None] + ppw[:, None] * bw))[..., None] * bnrm
        vel = vel - inv_mass[:, None] * fb.sum(1)
        f = (vpp[i] * w * (accum[i] + accum[j]))[:, None] * nrm
        vel = vel - add(i, f) + add(j, f)
        # damping: the bodies' pass, then the particles'
        vn = -(vel[:, None, :] * bnrm).sum(-1)
        damp = torch.maximum(lin_d[:, None] * bw,
                             torch.clamp(-quad_d * vn, max=0.5))
        fb = torch.where((b_ok & (vn < 0))[..., None],
                         (damp * m_c[:, None] * vn)[..., None] * bnrm, 0.0)
        vel = vel + inv_mass[:, None] * fb.sum(1)
        vn = ((vel[j] - vel[i]) * nrm).sum(1)
        damp = torch.maximum(lin_d[i] * w, torch.clamp(-quad_d * vn, max=0.5))
        f = torch.where((vn < 0)[:, None], (damp * vn)[:, None] * nrm, 0.0)
        vel = vel + add(i, f) - add(j, f)
        # limit velocity
        v2 = (vel * vel).sum(1)
        vel = torch.where((v2 > float(crit_v2))[:, None],
                          vel * torch.sqrt(float(crit_v2) / v2)[:, None], vel)
        # collision: stop at the first box the step's ray enters
        sv = float(h) * vel
        hit, frac, fn = ray_boxes(pos, sv, centers, halves)
        frac = torch.where(hit, frac, math.inf)
        best, at = frac.min(1)
        any_hit = torch.isfinite(best)
        wn = torch.gather(fn, 1, at[:, None, None].expand(n, 1, 2))[:, 0]
        target = pos + torch.where(any_hit, best, 0.0)[:, None] * sv \
            + float(LINEAR_SLOP) * wn
        vel = torch.where(any_hit[:, None], float(inv_h) * (target - pos), vel)
        pos = pos + float(h) * vel
    return pos, vel
