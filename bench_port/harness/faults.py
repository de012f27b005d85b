"""Faults planted under the timed path, for the tests and the readings
that show the check fails them (never in a run the driver makes):

  unchanged  the step returns the state it was given
  half       the second half of a batch's worlds is left unstepped
  alter      one answer is altered where it is produced: the particles
             of one world (the first of a batch) gain 0.01 m/s in x"""

from __future__ import annotations

import dataclasses

import torch

from .tree import replace_leaf

NAMES = ("unchanged", "half", "alter")


def _merge(a, b, h):
    """Tree a with its worlds from h on taken from tree b."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _merge(getattr(a, f.name), getattr(b, f.name), h)
            for f in dataclasses.fields(a)})
    if isinstance(a, torch.Tensor):
        return torch.cat((a[:h], b[h:]))
    return a


def wrap(name: str, advance, kind: str):
    if name == "unchanged":
        return lambda state: state
    if name == "half":
        if kind != "batch":
            raise ValueError("the half fault needs a batch")

        def half(state):
            out = advance(state)
            return _merge(out, state, out.particles.pos.shape[0] // 2)

        return half
    if name == "alter":
        def alter(state):
            out = advance(state)
            v = out.particles.vel.clone()
            (v[0] if kind == "batch" else v)[..., 0] += 0.01
            return replace_leaf(out, "particles.vel", v)

        return alter
    raise KeyError(f"no fault named {name!r}")
