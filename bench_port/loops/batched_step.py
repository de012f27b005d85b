"""A batch of worlds, stepped by BatchedStep.__call__ (world.
make_batched_step): each step ends with torch.cuda.synchronize(), and the
observations stay on the card, as in an RL or dataset-generation loop."""

from __future__ import annotations

import torch

from harness import scene
from harness.tree import clone


class Driver:
    kind = "batch"

    def __init__(self, cell: dict, seed: int, device):
        from box2d_tpu_torch import world as pw

        tr = cell["traffic_data"]
        w = scene.build_world(cell, device)
        self.dt = cell["config_data"]["dt"]
        self.n_worlds = tr["worlds"]
        st = w._step
        self.stepper = pw.make_batched_step(
            w.capacity, st.classes, st.substeps, st.continuous,
            particle_cfg=st.particle_cfg)
        self.built = w.state
        self.spawn, self.inputs = scene.spawn(w.state, cell, seed,
                                              self.n_worlds)
        self.units = scene.live_particles(self.spawn)
        self.state = clone(self.spawn)
        self.device = torch.device(device)

    @property
    def stats(self):
        return self.stepper.stats

    def reset(self):
        self.state = clone(self.spawn)

    def advance(self, state):
        """One step of every world through the batched entry."""
        return self.stepper(state, self.dt)

    def step(self):
        self.state = self.advance(self.state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        self.state = self.spawn = self.built = None


def build(cell: dict, seed: int, device) -> Driver:
    return Driver(cell, seed, device)
