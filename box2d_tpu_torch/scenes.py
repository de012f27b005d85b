"""Benchmark scenes: the pyramid, the joint farm and the dam break.

Port of box2d_tpu/scenes.py `pyramid` (:19-36), `joint_farm` (:65-106) and
`dam_break` (:128-145).
The other scenes come with the slices that step them (ROADMAP.md queue).
Like every entry point of the port, a scene is built on the card unless the
caller names another device.
"""

from __future__ import annotations

import math

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
