"""The least time the card could take for the work a step's state needs,
and the counts it is computed from.

Frozen from chip_smoke.py at commit cc11e5e: the published peaks
(:200-203), the float operations of K3 (:222-226), K3's bytes and
operations (_k3_work :730-755) and _bound_of (:717-723). chip_smoke
counts from a kernel's arguments; here the counts come from the step's
state (harness docstrings of each count), so the yardstick reads the same
work whatever implements it: live lanes only, each input byte read once
and each output byte written once."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores (700 W; the run records the card's power limit beside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# K3 (csrc/particles.cu window_kernel): operations per neighbour within one
# diameter, by phase (weight, pressure, damping)
FLOP_K3_NEIGHBOUR = (7, 15, 23)


def bound_s(nbytes, flops) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)


def k3_least_s(live, neighbours, worlds, iterations) -> float:
    """A step's K3 calls: three phases in each particle iteration, each
    reading pos (8 bytes), the cell key (4) and the alive flag (1) of every
    live lane, plus 4 bytes for each earlier phase's output it reads
    (weight, then pressure), and writing 8; 32 bytes of scalars a world;
    the phase's operations for every ordered neighbour pair within one
    diameter. The candidates a window visits depend on the kernel and are
    not counted."""
    if not live:
        return 0.0
    per_iter = 0.0
    for phase in range(3):
        nbytes = live * (8 + 4 + 1 + 4 * phase + 8) + 32 * worlds
        per_iter += bound_s(nbytes, neighbours * FLOP_K3_NEIGHBOUR[phase])
    return iterations * per_iter


def particle_neighbours(pos, alive, diameter: float) -> torch.Tensor:
    """(live particles, ordered pairs of live particles closer than one
    diameter) over every world of pos (..., n, 2), as a device tensor: a
    grid of diameter-wide cells, each particle against the particles of
    its 3 x 3 cells."""
    pos = pos.reshape(-1, pos.shape[-2], 2)
    alive = alive.reshape(-1, alive.shape[-1])
    n_w, n = alive.shape
    wid = torch.arange(n_w, device=pos.device)[:, None].expand(n_w, n)
    p = pos[alive]
    w = wid[alive]
    if p.shape[0] == 0:
        return torch.zeros(2, dtype=torch.int64, device=pos.device)
    cell = torch.floor(p / diameter).to(torch.int64)
    cell = cell - cell.min(0).values + 1
    nx = int(cell[:, 0].max()) + 2
    ny = int(cell[:, 1].max()) + 2
    key = (w * ny + cell[:, 1]) * nx + cell[:, 0]
    order = torch.argsort(key)
    key_s, p_s = key[order], p[order]
    d2 = diameter * diameter
    pairs = torch.zeros((), dtype=torch.int64, device=pos.device)
    lane = torch.arange(key_s.shape[0], device=pos.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = key_s + dy * nx + dx
            lo = torch.searchsorted(key_s, k)
            hi = torch.searchsorted(key_s, k, right=True)
            width = hi - lo
            for j in range(int(width.max())):
                idx = (lo + j).clamp(max=key_s.shape[0] - 1)
                d = p_s[idx] - p_s
                ok = ((j < width) & (idx != lane)
                      & ((d * d).sum(1) < d2))
                pairs = pairs + ok.sum()
    return torch.stack([torch.tensor(p.shape[0], device=pos.device),
                        pairs])
