"""How `correct` is decided: what the window produced, against the
reference of the cell's scene, reference/<scene>.py, found by the scene's
name. The module gives:

  PRIMARY        the leaves of a state that the reference is handed (the
                 physical state: for particles their positions,
                 velocities and which live), and nothing else of it
  spawn_gap      the program's built state (its PRIMARY leaves) against
                 the configuration's scene, before the seed's jitter
  numbers        {number: reading} of the sampled steps of the window's
                 first episode, and of its last state, against the
                 reference's own steps from the same primary state and
                 the inputs the benchmark made (harness.scene.spawn);
                 control="bf16" puts the reference in the program's
                 place, in bfloat16

The cell's `limits` name the numbers compared."""

from __future__ import annotations

import importlib
import os

from . import registry


def reference(cell: dict):
    scene = cell["config_data"]["scene"]
    if not os.path.isfile(registry.path("reference", scene, ".py")):
        raise KeyError(f"no reference for scene {scene!r}")
    return importlib.import_module("reference." + scene)


def primary(state, paths) -> dict:
    """{path: a clone of the leaf} of the leaves the reference is handed."""
    out = {}
    for path in paths:
        v = state
        for part in path.split("."):
            v = getattr(v, part)
        out[path] = v.clone()
    return out


def spawn_gap(cell: dict, built) -> float:
    ref = reference(cell)
    return ref.spawn_gap(primary(built, ref.PRIMARY), cell)


def numbers(cell: dict, snaps, last, inputs: dict, control=None) -> dict:
    return reference(cell).numbers(snaps, last, inputs, cell, control)
