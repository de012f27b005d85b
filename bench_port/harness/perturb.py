"""Worlds made from one spawn state and the seed, on the device.

Rewritten from port_fixtures.perturbed_leaves (port_fixtures.py:859-902 at
commit cc11e5e): every world's live particles move by up to
`particle_jitter` m in x and y, and its pressure and damping strengths
and density are scaled by 1 + s u, 1 - s u / 2 and 1 + s u / 4 with u in
[0, 1) per world and s = `param_spread` (perturbed_leaves scales world w
by w / W of the spread, chip_smoke phase 6 (h): spread 0.2). Every draw
comes from one torch.Generator seeded with the run's seed, on the state's
device, in a few large calls: each seed makes its own worlds."""

from __future__ import annotations

import torch

from .tree import replace_leaf

SCALES = {"pressure_strength": 1.0, "damping_strength": -0.5,
          "density": 0.25}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def perturb(state, seed: int, base: dict, particle_jitter=0.0,
            param_spread=0.0):
    """(the batch `state` (every tensor with a leading world axis) with
    each world perturbed, {parameter: (W,) float32 tensor}): the fluid
    parameters every world steps with, from the configuration's `base`
    values. Returns a new tree; the input is not changed."""
    p = state.particles
    n_w = p.pos.shape[0]
    dev = p.pos.device
    g = generator(seed, dev)
    if particle_jitter:
        u = torch.rand(p.pos.shape, generator=g, device=dev)
        d = (2.0 * u - 1.0) * particle_jitter
        state = replace_leaf(state, "particles.pos",
                             p.pos + torch.where(p.alive[..., None], d, 0.0))
    u = (torch.rand(n_w, generator=g, device=dev) if param_spread
         else torch.zeros(n_w, device=dev))
    params = {}
    for key, scale in SCALES.items():
        v = torch.full((n_w,), float(base[key]), dtype=torch.float32,
                       device=dev)
        params[key] = v * (1.0 + scale * param_spread * u)
        state = replace_leaf(state, "particles.params." + key, params[key])
    return state, params
