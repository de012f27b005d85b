"""The general generator: a cell's spawn state from its configuration,
its traffic mix and the seed.

The configuration names a scene: scenes/<scene>.py builds it in the port
from the configuration's widths and the traffic's size (`size`);
reference/<scene>.py holds the scene's reference. The traffic mix gives
the number of worlds and the perturbation (harness.perturb) that makes
each seed's worlds differ."""

from __future__ import annotations

import dataclasses

from . import perturb as pt
from . import registry
from .tree import tmap


def build_world(cell: dict, device):
    """The port's api.World of the cell's scene, compiled on `device`."""
    cfg, tr = cell["config_data"], cell["traffic_data"]
    w = registry.load_module("scenes", cfg["scene"]).build(
        cfg, tr["size"], device)
    cap = tr.get("capacity")
    if cap:
        w.capacity = dataclasses.replace(w.capacity, **cap)
    return w


def spawn(state, cell: dict, seed: int, n_worlds: int | None):
    """(the perturbed spawn, the inputs the reference is handed): a batch
    of n_worlds worlds (every tensor with a leading world axis), or one
    world where n_worlds is None."""
    cfg, tr = cell["config_data"], cell["traffic_data"]
    w = 1 if n_worlds is None else n_worlds
    batch = tmap(lambda x: x.expand((w,) + tuple(x.shape)).contiguous(),
                 state)
    batch, inputs = pt.perturb(
        batch, seed, cfg, particle_jitter=tr.get("particle_jitter", 0.0),
        param_spread=tr.get("param_spread", 0.0))
    if n_worlds is None:
        batch = tmap(lambda x: x[0].contiguous(), batch)
    return batch, inputs


def live_particles(state) -> int:
    """Live particles of a state, over all its worlds."""
    return int(state.particles.alive.sum())
