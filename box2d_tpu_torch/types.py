"""Host-side definition structs: world, bodies, shapes, chains and joints.

Copies of the box2d_tpu/types.py dataclasses that bodies, shapes, chains
and joints need (ref: include/Types.cs — WorldDef :77-144, BodyDef
:170-223, Filter :226-258, SurfaceMaterial :300-318, ShapeDef :307-344,
ChainDef :359-376, QueryFilter :261-269, ExplosionDef :649-664, joint
defs :460-646). Defaults match the reference so scenes port 1:1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from . import constants as k
from .state import (DYNAMIC, JOINT_DISTANCE, JOINT_FILTER, JOINT_MOTOR,
                    JOINT_MOUSE, JOINT_PRISMATIC, JOINT_REVOLUTE, JOINT_WELD,
                    JOINT_WHEEL, KINEMATIC, STATIC)

__all__ = [
    "WorldDef", "BodyDef", "Filter", "QueryFilter", "SurfaceMaterial",
    "ShapeDef", "ChainDef", "ExplosionDef", "DistanceJointDef",
    "MotorJointDef", "PrismaticJointDef", "RevoluteJointDef", "WeldJointDef",
    "WheelJointDef", "FilterJointDef", "MouseJointDef",
    "STATIC", "KINEMATIC", "DYNAMIC",
]


@dataclasses.dataclass
class WorldDef:
    """ref: include/Types.cs:77-144."""

    gravity: tuple = k.DEFAULT_GRAVITY
    restitution_threshold: float = k.DEFAULT_RESTITUTION_THRESHOLD
    hit_event_threshold: float = k.DEFAULT_HIT_EVENT_THRESHOLD
    contact_hertz: float = k.DEFAULT_CONTACT_HERTZ
    contact_damping_ratio: float = k.DEFAULT_CONTACT_DAMPING_RATIO
    contact_speed: float = k.DEFAULT_CONTACT_SPEED
    maximum_linear_speed: float = k.DEFAULT_MAX_LINEAR_SPEED
    joint_hertz: float = k.DEFAULT_JOINT_HERTZ
    joint_damping_ratio: float = k.DEFAULT_JOINT_DAMPING_RATIO
    enable_sleep: bool = True
    enable_continuous: bool = True
    # mass-ratio contact softening (ref: include/Types.cs:106)
    enable_contact_softening: bool = False


@dataclasses.dataclass
class BodyDef:
    """ref: include/Types.cs:170-223."""

    type: int = STATIC
    position: tuple = (0.0, 0.0)
    angle: float = 0.0  # convenience over rotation quaternion
    linear_velocity: tuple = (0.0, 0.0)
    angular_velocity: float = 0.0
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    gravity_scale: float = 1.0
    sleep_threshold: float = 0.05 * k.LENGTH_UNITS_PER_METER
    lock_linear_x: bool = False
    lock_linear_y: bool = False
    lock_angular_z: bool = False  # aka fixed rotation
    enable_sleep: bool = True
    is_awake: bool = True
    is_bullet: bool = False
    is_enabled: bool = True
    allow_fast_rotation: bool = False
    user_data: int = 0


@dataclasses.dataclass
class Filter:
    """ref: include/Types.cs:226-258 (32-bit category/mask)."""

    category_bits: int = 0x0001
    mask_bits: int = 0xFFFFFFFF
    group_index: int = 0


@dataclasses.dataclass
class QueryFilter:
    """ref: include/Types.cs:261-269."""

    category_bits: int = 0x0001
    mask_bits: int = 0xFFFFFFFF


@dataclasses.dataclass
class SurfaceMaterial:
    """ref: include/Types.cs:300-318."""

    friction: float = 0.6
    restitution: float = 0.0
    rolling_resistance: float = 0.0
    tangent_speed: float = 0.0
    user_material_id: int = 0


@dataclasses.dataclass
class ShapeDef:
    """ref: include/Types.cs:307-344."""

    material: SurfaceMaterial = dataclasses.field(default_factory=SurfaceMaterial)
    density: float = 1.0
    filter: Filter = dataclasses.field(default_factory=Filter)
    is_sensor: bool = False
    enable_sensor_events: bool = False
    enable_contact_events: bool = False
    enable_hit_events: bool = False
    update_body_mass: bool = True


@dataclasses.dataclass
class ChainDef:
    """ref: include/Types.cs:359-376."""

    points: Sequence = ()
    materials: Sequence = (SurfaceMaterial(),)
    filter: Filter = dataclasses.field(default_factory=Filter)
    is_loop: bool = False
    enable_sensor_events: bool = False


@dataclasses.dataclass
class ExplosionDef:
    """ref: include/Types.cs:649-664."""

    position: tuple = (0.0, 0.0)
    radius: float = 1.0
    falloff: float = 0.0
    impulse_per_length: float = 0.0
    mask_bits: int = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# joint defs (ref: include/Types.cs:460-646)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _JointDefBase:
    body_a: int = -1
    body_b: int = -1
    local_anchor_a: tuple = (0.0, 0.0)
    local_anchor_b: tuple = (0.0, 0.0)
    collide_connected: bool = False
    force_threshold: float = 3.4e38
    torque_threshold: float = 3.4e38
    constraint_hertz: float = 60.0
    constraint_damping_ratio: float = 2.0


@dataclasses.dataclass
class DistanceJointDef(_JointDefBase):
    """ref: include/Types.cs DistanceJointDef."""

    length: float = 1.0
    enable_spring: bool = False
    hertz: float = 0.0
    damping_ratio: float = 0.0
    lower_spring_force: float = -3.4e38
    upper_spring_force: float = 3.4e38
    enable_limit: bool = False
    min_length: float = 0.0
    max_length: float = k.HUGE
    enable_motor: bool = False
    max_motor_force: float = 0.0
    motor_speed: float = 0.0
    _type: int = JOINT_DISTANCE


@dataclasses.dataclass
class MotorJointDef(_JointDefBase):
    """Velocity/spring drive toward a relative transform
    (ref: include/Types.cs MotorJointDef + src/joints/MotorJoint.cs)."""

    linear_velocity: tuple = (0.0, 0.0)
    angular_velocity: float = 0.0
    max_velocity_force: float = 0.0
    max_velocity_torque: float = 0.0
    linear_hertz: float = 0.0
    linear_damping_ratio: float = 0.0
    max_spring_force: float = 0.0
    angular_hertz: float = 0.0
    angular_damping_ratio: float = 0.0
    max_spring_torque: float = 0.0
    _type: int = JOINT_MOTOR


@dataclasses.dataclass
class PrismaticJointDef(_JointDefBase):
    local_axis_a: tuple = (1.0, 0.0)
    reference_angle: float = 0.0
    enable_spring: bool = False
    hertz: float = 0.0
    damping_ratio: float = 0.0
    target_translation: float = 0.0
    enable_limit: bool = False
    lower_translation: float = 0.0
    upper_translation: float = 0.0
    enable_motor: bool = False
    max_motor_force: float = 0.0
    motor_speed: float = 0.0
    _type: int = JOINT_PRISMATIC


@dataclasses.dataclass
class RevoluteJointDef(_JointDefBase):
    reference_angle: float = 0.0
    enable_spring: bool = False
    hertz: float = 0.0
    damping_ratio: float = 0.0
    target_angle: float = 0.0
    enable_limit: bool = False
    lower_angle: float = 0.0
    upper_angle: float = 0.0
    enable_motor: bool = False
    max_motor_torque: float = 0.0
    motor_speed: float = 0.0
    _type: int = JOINT_REVOLUTE


@dataclasses.dataclass
class WeldJointDef(_JointDefBase):
    reference_angle: float = 0.0
    linear_hertz: float = 0.0
    angular_hertz: float = 0.0
    linear_damping_ratio: float = 0.0
    angular_damping_ratio: float = 0.0
    _type: int = JOINT_WELD


@dataclasses.dataclass
class WheelJointDef(_JointDefBase):
    local_axis_a: tuple = (0.0, 1.0)
    enable_spring: bool = True
    hertz: float = 1.0
    damping_ratio: float = 0.7
    enable_limit: bool = False
    lower_translation: float = 0.0
    upper_translation: float = 0.0
    enable_motor: bool = False
    max_motor_torque: float = 0.0
    motor_speed: float = 0.0
    _type: int = JOINT_WHEEL


@dataclasses.dataclass
class FilterJointDef(_JointDefBase):
    """Disables collision between two bodies, no constraint
    (ref: src/joints/FilterJoint.cs:5-18)."""

    _type: int = JOINT_FILTER


@dataclasses.dataclass
class MouseJointDef(_JointDefBase):
    """Soft target dragging (ref: src/joints/MouseJoint.cs — excluded from
    the reference build but included here for API completeness)."""

    target: tuple = (0.0, 0.0)
    hertz: float = 4.0
    damping_ratio: float = 0.7
    max_force: float = 0.0
    _type: int = JOINT_MOUSE
