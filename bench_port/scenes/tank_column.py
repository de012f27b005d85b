"""Builds a tank with a column of water in the port through its public
API, from the configuration's widths (reference/tank_column.py works them
out): the tank's four static boxes, the particle system and its water
column, and the configuration's fluid parameters.

A configuration with "box_first_vertex": "inner_face" lists each box's
corners from one on its face towards the tank's inside (the same box, its
corners and edge normals rolled together); without it each box keeps
geometry.box's order, from its lower left corner."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness.tree import replace_leaf
from reference import tank_column as ref


def inner_first(geom, toward):
    """The box `geom` with its corners and edge normals rolled so that the
    first corner is the one nearest the point `toward` (a corner of the
    face that looks at it)."""
    n = geom.count
    d = ((geom.verts[:n] - np.asarray(toward, np.float32)) ** 2).sum(1)
    order = np.roll(np.arange(n), -int(np.argmin(d)))
    verts, normals = geom.verts.copy(), geom.normals.copy()
    verts[:n], normals[:n] = geom.verts[order], geom.normals[order]
    verts[n:], normals[n:] = verts[n - 1], normals[n - 1]
    return dataclasses.replace(geom, verts=verts, normals=normals)


def build(cfg: dict, size: dict, device):
    """The port's api.World of the scene, compiled on `device`."""
    from box2d_tpu_torch import api, geometry, types

    scale = size["scale"]
    w = api.World(types.WorldDef(gravity=tuple(cfg["gravity"])),
                  device=device)
    tank = w.create_body(types.BodyDef(type=types.STATIC))
    lo, hi = ref.tank(cfg, scale)
    middle = (lo + hi) / 2
    for c, h in ref.boxes(cfg, scale):
        geom = geometry.box(h[0], h[1], center=c)
        if cfg.get("box_first_vertex") == "inner_face":
            geom = inner_first(geom, middle)
        w.create_polygon_shape(tank, types.ShapeDef(), geom)
    ps = w.create_particle_system(radius=cfg["radius"],
                                  density=cfg["density"])
    center, half = ref.column(cfg, scale)
    ps.create_group_box(center=center, half_w=half[0], half_h=half[1])
    w.compile()
    its = w._step.particle_cfg.iterations
    if its != cfg["iterations"]:
        raise ValueError(f"the port steps {its} particle iterations, the "
                         f"configuration {cfg['iterations']}")
    for key in ref.PARAMS:
        w.state = replace_leaf(
            w.state, "particles.params." + key,
            torch.tensor(np.float32(cfg[key]), device=w.device))
    return w
