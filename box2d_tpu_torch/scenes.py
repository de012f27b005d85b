"""Benchmark scenes: the pyramid, the tumbler, the joint farm, the bullet
barrage and the dam break.

Port of box2d_tpu/scenes.py `pyramid` (:19-36), `tumbler` (:39-63),
`joint_farm` (:65-106), `bullet_barrage` (:109-126), `dam_break`
(:128-145) and `replicate` (:148-234), the flat batch.
The other scenes come with the slices that step them (ROADMAP.md queue).
Like every entry point of the port, a scene is built on the card unless the
caller names another device.
"""

from __future__ import annotations

import math

import numpy as np

from . import geometry as g
from . import types as t
from .api import World


def pyramid(rows: int = 20, substeps: int = 4, box_half: float = 0.5,
            device="cuda") -> World:
    """Pyramid of boxes on static ground (classic stacking benchmark)."""
    w = World(substeps=substeps, device=device)
    ground = w.create_body(t.BodyDef(type=t.STATIC, position=(0.0, -0.5)))
    w.create_polygon_shape(ground, t.ShapeDef(), g.box(4.0 * rows, 0.5))
    sd = t.ShapeDef(density=1.0)
    sd.material.friction = 0.6
    h = box_half
    shift = 1.0 * h
    for i in range(rows):
        y = (2.0 * h) * i + h
        n = rows - i
        x0 = -shift * n + shift
        for j in range(n):
            b = w.create_body(t.BodyDef(type=t.DYNAMIC,
                                        position=(x0 + 2.0 * shift * j, y)))
            w.create_polygon_shape(b, sd, g.box(h, h))
    return w


def tumbler(count: int = 800, substeps: int = 4, device="cuda") -> World:
    """Rotating kinematic container churning dynamic boxes (dense contact
    graph)."""
    w = World(substeps=substeps, device=device)
    drum = w.create_body(t.BodyDef(type=t.KINEMATIC, position=(0.0, 10.0),
                                   angular_velocity=0.25 * math.pi))
    sd = t.ShapeDef(density=50.0)
    w.create_polygon_shape(drum, sd, g.box(0.5, 10.0, center=(10.0, 0.0)))
    w.create_polygon_shape(drum, sd, g.box(0.5, 10.0, center=(-10.0, 0.0)))
    w.create_polygon_shape(drum, sd, g.box(10.0, 0.5, center=(0.0, 10.0)))
    w.create_polygon_shape(drum, sd, g.box(10.0, 0.5, center=(0.0, -10.0)))
    bd = t.ShapeDef(density=1.0)
    side = int(math.ceil(math.sqrt(count)))
    n = 0
    for i in range(side):
        for j in range(side):
            if n >= count:
                break
            b = w.create_body(t.BodyDef(type=t.DYNAMIC, position=(
                -4.0 + 0.4 * j, 10.0 - 4.0 + 0.4 * i)))
            w.create_polygon_shape(b, bd, g.box(0.125, 0.125))
            n += 1
    return w


def joint_farm(ragdolls: int = 100, substeps: int = 4,
               device="cuda") -> World:
    """Grid of simple 4-link ragdolls: revolute + distance + prismatic
    mix with motors, hanging from static anchors."""
    w = World(substeps=substeps, device=device)
    sd = t.ShapeDef(density=1.0)
    cols = int(math.ceil(math.sqrt(ragdolls)))
    for r in range(ragdolls):
        cx = (r % cols) * 5.0
        cy = (r // cols) * 6.0 + 5.0
        anchor = w.create_body(t.BodyDef(type=t.STATIC, position=(cx, cy)))
        # torso hangs from anchor by revolute with motor
        torso = w.create_body(t.BodyDef(type=t.DYNAMIC,
                                        position=(cx, cy - 1.0)))
        w.create_capsule_shape(torso, sd, (0.0, -0.5), (0.0, 0.5), 0.15)
        w.create_joint(t.RevoluteJointDef(
            body_a=anchor, body_b=torso,
            local_anchor_a=(0.0, 0.0), local_anchor_b=(0.0, 1.0),
            enable_motor=True, max_motor_torque=10.0, motor_speed=0.5))
        # arm by revolute with limit
        arm = w.create_body(t.BodyDef(type=t.DYNAMIC,
                                      position=(cx + 0.6, cy - 1.0)))
        w.create_capsule_shape(arm, sd, (-0.3, 0.0), (0.3, 0.0), 0.1)
        w.create_joint(t.RevoluteJointDef(
            body_a=torso, body_b=arm,
            local_anchor_a=(0.15, 0.0), local_anchor_b=(-0.45, 0.0),
            enable_limit=True, lower_angle=-0.5 * math.pi,
            upper_angle=0.5 * math.pi))
        # leg by prismatic with motor
        leg = w.create_body(t.BodyDef(type=t.DYNAMIC,
                                      position=(cx, cy - 2.2)))
        w.create_capsule_shape(leg, sd, (0.0, -0.3), (0.0, 0.3), 0.1)
        w.create_joint(t.PrismaticJointDef(
            body_a=torso, body_b=leg,
            local_anchor_a=(0.0, -0.5), local_anchor_b=(0.0, 0.5),
            local_axis_a=(0.0, 1.0), enable_limit=True,
            lower_translation=-0.2, upper_translation=0.2,
            enable_motor=True, max_motor_force=5.0))
        # counterweight by distance spring
        ball = w.create_body(t.BodyDef(type=t.DYNAMIC,
                                       position=(cx - 1.0, cy - 1.5)))
        w.create_circle_shape(ball, sd, (0.0, 0.0), 0.15)
        w.create_joint(t.DistanceJointDef(
            body_a=torso, body_b=ball,
            local_anchor_a=(0.0, 0.0), local_anchor_b=(0.0, 0.0),
            length=1.2, enable_spring=True, hertz=3.0, damping_ratio=0.5))
    return w


def bullet_barrage(bullets: int = 50, substeps: int = 4,
                   device="cuda") -> World:
    """High-speed small circles fired at thin static walls (continuous
    collision)."""
    w = World(substeps=substeps, device=device)
    ground = w.create_body(t.BodyDef(type=t.STATIC, position=(0.0, -0.5)))
    w.create_polygon_shape(ground, t.ShapeDef(), g.box(100.0, 0.5))
    for i in range(4):
        wall = w.create_body(t.BodyDef(type=t.STATIC,
                                       position=(20.0 + 10.0 * i, 5.0)))
        w.create_polygon_shape(wall, t.ShapeDef(), g.box(0.05, 5.0))
    sd = t.ShapeDef(density=5.0)
    for i in range(bullets):
        b = w.create_body(t.BodyDef(
            type=t.DYNAMIC, position=(-10.0, 1.0 + 0.3 * i),
            linear_velocity=(150.0 + i, 0.0), is_bullet=True,
            gravity_scale=0.0))
        w.create_circle_shape(b, sd, (0.0, 0.0), 0.1)
    return w


def dam_break(particles_target: int = 2000, substeps: int = 4,
              radius: float = 0.05, device="cuda") -> World:
    """LiquidFun dam break: a particle column collapses in a static
    three-box tank (BASELINE.json config 5)."""
    w = World(substeps=substeps, device=device)
    tank = w.create_body(t.BodyDef(type=t.STATIC))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(4.0, 0.25, center=(0, -0.25)))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(0.25, 3.0, center=(-4.0, 2.75)))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(0.25, 3.0, center=(4.0, 2.75)))
    ps = w.create_particle_system(radius=radius)
    # size the column to roughly hit the particle target
    stride = 0.75 * 2.0 * radius
    side = math.sqrt(particles_target) * stride
    ps.create_group_box(center=(-4.0 + side / 2 + 0.3, side / 2 + 0.05),
                        half_w=side / 2, half_h=side / 2)
    return w


def replicate(base: World, n: int, spacing: float | None = None) -> World:
    """Tile `n` copies of a scene into ONE world, spatially offset: the flat
    batch. It steps as one world through the same step and kernels; the
    copies never overlap, so the broadphase finds no pair across copies
    and the particle cell keys none either. Copy k holds the bodies,
    shapes and joints of index range k * (n_bodies, n_shapes, n_joints)
    of the base scene, and its particles and groups likewise.

    The copies sit on a near-square grid, not a line: the grid broadphase
    sorts by cell row, and a line of copies would put every copy's boxes
    into the same rows, where the block-tile window overflows once a row
    run passes Capacity.bp_tile."""
    bb = base.builder
    pb = bb._particle_builder
    lo_y, hi_y = 1e30, -1e30
    for b in bb._bodies:
        lo_y = min(lo_y, float(b["position"][1]))
        hi_y = max(hi_y, float(b["position"][1]))
    if pb is not None and pb.pos:
        pp = np.asarray(pb.pos, np.float32)
        lo_y = min(lo_y, float(pp[:, 1].min()))
        hi_y = max(hi_y, float(pp[:, 1].max()))
    if spacing is None:
        lo, hi = 1e30, -1e30
        for b in bb._bodies:
            lo = min(lo, float(b["position"][0]))
            hi = max(hi, float(b["position"][0]))
        if pb is not None and pb.pos:
            lo = min(lo, float(pp[:, 0].min()))
            hi = max(hi, float(pp[:, 0].max()))
        # the scene's x extent with a margin for the widest shape
        spacing = max(2.0 * (hi - lo + 10.0), 20.0)
    cols = int(math.ceil(math.sqrt(n)))
    spacing_y = max(2.0 * (hi_y - lo_y + 10.0), 20.0)

    out = World(bb.def_, substeps=base.substeps, device=base.device)
    nb = len(bb._bodies)
    for k in range(n):
        dx = (k % cols) * spacing
        dy = (k // cols) * spacing_y
        for b in bb._bodies:
            nbod = dict(b)
            nbod["position"] = b["position"] + np.array([dx, dy], np.float32)
            nbod["mass_center"] = b["mass_center"].copy()
            out.builder._bodies.append(nbod)
        off = k * nb
        for s in bb._shapes:
            ns = dict(s)
            ns["body"] = s["body"] + off
            out.builder._shapes.append(ns)
        for j in bb._joints:
            nj = dict(j)
            nj["body_a"] = j["body_a"] + off
            nj["body_b"] = j["body_b"] + off
            out.builder._joints.append(nj)

    # the particles tile the same way, one sorted particle table serving
    # every copy; each copy's pairs and triads shift with its particles
    if pb is not None:
        opb = out.builder.create_particle_system(pb.radius, pb.density)
        npart = len(pb.pos)
        ngrp = len(pb.group_flags)
        for k in range(n):
            dxy = np.array([(k % cols) * spacing,
                            (k // cols) * spacing_y], np.float32)
            off_p = k * npart
            off_g = k * ngrp
            for i in range(len(pb.pos)):
                opb.pos.append(pb.pos[i] + dxy)
                opb.vel.append(pb.vel[i])
                opb.flags.append(pb.flags[i])
                opb.group.append(pb.group[i] + off_g
                                 if pb.group[i] >= 0 else -1)
                opb.lifetime.append(pb.lifetime[i])
                opb.color.append(pb.color[i])
            opb.group_flags.extend(pb.group_flags)
            opb.group_strength.extend(pb.group_strength)
            for (pa, pb_, fl, st, dist) in pb.pairs:
                opb.pairs.append((pa + off_p, pb_ + off_p, fl, st, dist))
            for tr in pb.triads:
                opb.triads.append((tr[0] + off_p, tr[1] + off_p,
                                   tr[2] + off_p) + tuple(tr[3:]))
    return out
