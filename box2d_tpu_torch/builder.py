"""Host-side scene builder: accumulate bodies and shapes, freeze to tensors.

Port of box2d_tpu/builder.py: bodies, shapes and joints. Scene data is
gathered eagerly in NumPy with exactly the JAX builder's arithmetic and
capacity sizing (box2d_tpu/builder.py:156-179), then uploaded once as a
torch WorldState on the requested device ("cuda" unless the caller names
another), so both builders produce the same state leaves bit for bit.
A particle system (particles.ParticleSystemBuilder) is frozen with the
world. Chains belong to a later slice and raise NotImplementedError naming
their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import geometry as g
from . import types as t
from .state import (ALLOW_FAST_ROTATION, DYNAMIC, ENABLE_SLEEP, IS_BULLET,
                    JOINT_DISTANCE, JOINT_MOUSE, JOINT_PRISMATIC,
                    JOINT_REVOLUTE, JOINT_WELD, JOINT_WHEEL,
                    LOCK_ANGULAR_Z, LOCK_LINEAR_X, LOCK_LINEAR_Y, Bodies,
                    Capacity, Joints, Shapes, Tuning, WorldState,
                    zero_broadphase, zero_events, zero_profile)


class WorldBuilder:
    """Accumulates a scene and freezes it into a WorldState."""

    def __init__(self, def_: t.WorldDef | None = None):
        self.def_ = def_ or t.WorldDef()
        self._bodies: list[dict] = []
        self._shapes: list[dict] = []
        self._joints: list[dict] = []
        self._particle_builder = None

    # -- bodies ------------------------------------------------------------

    def create_body(self, def_: t.BodyDef | None = None, **overrides) -> int:
        d = dataclasses.replace(def_ or t.BodyDef(), **overrides)
        flags = (
            (LOCK_LINEAR_X if d.lock_linear_x else 0)
            | (LOCK_LINEAR_Y if d.lock_linear_y else 0)
            | (LOCK_ANGULAR_Z if d.lock_angular_z else 0)
            | (IS_BULLET if d.is_bullet else 0)
            | (ALLOW_FAST_ROTATION if d.allow_fast_rotation else 0)
            | (ENABLE_SLEEP if d.enable_sleep else 0)
        )
        self._bodies.append(dict(
            type=d.type,
            position=np.asarray(d.position, np.float32),
            rot=np.array([math.cos(d.angle), math.sin(d.angle)], np.float32),
            v=np.asarray(d.linear_velocity, np.float32),
            w=float(d.angular_velocity),
            linear_damping=float(d.linear_damping),
            angular_damping=float(d.angular_damping),
            gravity_scale=float(d.gravity_scale),
            sleep_threshold=float(d.sleep_threshold),
            flags=flags,
            awake=bool(d.is_awake),
            enabled=bool(d.is_enabled),
            user_data=int(d.user_data),
            mass=0.0, inertia_origin=0.0, mass_center=np.zeros(2, np.float64),
            local_center=np.zeros(2, np.float32),
        ))
        return len(self._bodies) - 1

    # -- shapes ------------------------------------------------------------

    def create_shape(self, body: int, def_: t.ShapeDef,
                     geom: g.ShapeGeom) -> int:
        """ref: api/Shape.cs:8-24 CreateShape + UpdateBodyMassData."""
        d = def_
        self._shapes.append(dict(
            body=int(body), geom=geom,
            friction=d.material.friction, restitution=d.material.restitution,
            rolling_resistance=d.material.rolling_resistance,
            tangent_speed=d.material.tangent_speed,
            user_material=d.material.user_material_id,
            density=d.density,
            filter_category=d.filter.category_bits,
            filter_mask=d.filter.mask_bits,
            filter_group=d.filter.group_index,
            is_sensor=d.is_sensor,
            enable_contact_events=d.enable_contact_events,
            enable_hit_events=d.enable_hit_events,
            enable_sensor_events=d.enable_sensor_events,
        ))
        if d.update_body_mass:
            self._accumulate_mass(body, geom, d.density)
        return len(self._shapes) - 1

    def create_chain(self, body: int, def_) -> list[int]:
        raise NotImplementedError(
            "chain shapes: ROADMAP.md queue 10 (CCD, sensors and queries)")

    def create_joint(self, def_) -> int:
        self._joints.append(dataclasses.asdict(def_) | {"_type": def_._type})
        return len(self._joints) - 1

    def create_particle_system(self, radius: float, density: float = 1.0):
        """ref: api/Particle.cs:9-38 CreateParticleSystem (one per world; a
        second call replaces the first, as in box2d_tpu/builder.py:40-45)."""
        from .particles import ParticleSystemBuilder

        self._particle_builder = ParticleSystemBuilder(radius, density)
        return self._particle_builder

    def _accumulate_mass(self, body: int, geom: g.ShapeGeom, density: float):
        """ref: src/Body.cs:255-353."""
        b = self._bodies[body]
        if b["type"] != DYNAMIC:
            return
        md = g.compute_mass(geom, density)
        b["mass"] += md.mass
        b["mass_center"] = b["mass_center"] + md.mass * md.center.astype(
            np.float64)
        b["inertia_origin"] += md.rotational_inertia + md.mass * float(
            md.center @ md.center)

    # -- freeze ------------------------------------------------------------

    def default_capacity(self) -> Capacity:
        """Capacity sizing identical to box2d_tpu/builder.py:156-205."""
        nb, ns, nj = len(self._bodies), len(self._shapes), len(self._joints)
        exts = []
        for s in self._shapes:
            v = s["geom"].verts[:max(int(s["geom"].count), 1)]
            exts.append(float(np.max(np.ptp(v, axis=0), initial=0.0))
                        + 2.0 * float(s["geom"].radius))
        n_big = 0
        if exts:
            med = float(np.median(exts))
            n_big = int(np.sum(np.asarray(exts) > 4.0 * max(med, 1e-3)))
        return Capacity(
            max_bodies=max(nb, 1),
            max_shapes=max(ns, 1),
            max_joints=max(nj, 1),
            max_contact_pairs=max(4 * ns, 64),
            max_verts=max([2] + [int(s["geom"].count) for s in self._shapes]),
            big_shape_cap=min(max(16, ((n_big + 7) // 8) * 8),
                              max(ns - 1, 1), 4096),
        )

    def build(self, capacity: Capacity | None = None,
              device="cuda") -> tuple[WorldState, Capacity]:
        nb = len(self._bodies)
        ns = len(self._shapes)
        nj = len(self._joints)
        device = torch.device(device)
        if capacity is None:
            capacity = self.default_capacity()
        if capacity.fast_cap == 0:
            n_bullet_shapes = sum(
                1 for s in self._shapes
                if self._bodies[s["body"]]["flags"] & IS_BULLET)
            n_dyn = sum(1 for b in self._bodies if b["type"] == DYNAMIC)
            capacity = dataclasses.replace(
                capacity,
                fast_cap=min(max(len(self._shapes), 1),
                             max(64, ((n_bullet_shapes
                                       + min(256, max(16, n_dyn // 8))
                                       + 7) // 8) * 8)))
        capacity = dataclasses.replace(
            capacity,
            has_filters=any(
                int(s["filter_category"]) != 1
                or int(s["filter_mask"]) != 0xFFFFFFFF
                or int(s["filter_group"]) != 0
                for s in self._shapes),
            has_joint_exclusions=any(
                not j.get("collide_connected", False)
                for j in self._joints))
        Nb, S, J = capacity.max_bodies, capacity.max_shapes, capacity.max_joints
        if nb > Nb or ns > S or nj > J:
            raise ValueError(f"{nb} bodies / {ns} shapes / {nj} joints do "
                             f"not fit {capacity}")

        def up(a):
            return torch.from_numpy(np.array(a)).to(device)

        def farr(key, shape=(), fill=0.0, dtype=np.float32, src=None, n=Nb):
            src = self._bodies if src is None else src
            out = np.full((n,) + shape, fill, dtype)
            for i, e in enumerate(src):
                out[i] = e[key]
            return up(out)

        local_center = np.zeros((Nb, 2), np.float32)
        mass = np.zeros(Nb, np.float32)
        inertia = np.zeros(Nb, np.float32)
        inv_mass = np.zeros(Nb, np.float32)
        inv_inertia = np.zeros(Nb, np.float32)
        center = np.zeros((Nb, 2), np.float32)
        rot = np.zeros((Nb, 2), np.float32)
        rot[:, 0] = 1.0
        for i, b in enumerate(self._bodies):
            m_ = b["mass"]
            if b["type"] == DYNAMIC:
                if m_ > 0:
                    lc = (b["mass_center"] / m_).astype(np.float32)
                    ic = b["inertia_origin"] - m_ * float(lc @ lc)
                    locked = b["flags"] & LOCK_ANGULAR_Z
                    mass[i] = m_
                    inv_mass[i] = 1.0 / m_
                    if ic > 0 and not locked:
                        inertia[i] = ic
                        inv_inertia[i] = 1.0 / ic
                    local_center[i] = lc
                else:
                    mass[i] = 1.0
                    inv_mass[i] = 1.0
            rot[i] = b["rot"]
            c, s = b["rot"]
            center[i] = b["position"] + np.array(
                [c * local_center[i, 0] - s * local_center[i, 1],
                 s * local_center[i, 0] + c * local_center[i, 1]])

        min_extent = np.full(Nb, 1e8, np.float32)
        max_extent = np.zeros(Nb, np.float32)
        for s in self._shapes:
            geom: g.ShapeGeom = s["geom"]
            bi = s["body"]
            lc = local_center[bi]
            vs = geom.verts[: geom.count]
            reach = float(np.max(np.hypot(*(vs - lc).T))) + geom.radius
            max_extent[bi] = max(max_extent[bi], reach)
            if geom.count >= 3:
                offs = [float((vs[i] - geom.centroid) @ geom.normals[i])
                        for i in range(geom.count)]
                mine = min(offs) + geom.radius
            else:
                mine = geom.radius
            min_extent[bi] = min(min_extent[bi], mine)

        bodies = Bodies(
            center=up(center), rot=up(rot),
            v=farr("v", (2,)), w=farr("w"),
            force=up(np.zeros((Nb, 2), np.float32)),
            torque=up(np.zeros(Nb, np.float32)),
            local_center=up(local_center),
            inv_mass=up(inv_mass), inv_inertia=up(inv_inertia),
            mass=up(mass), inertia=up(inertia),
            linear_damping=farr("linear_damping"),
            angular_damping=farr("angular_damping"),
            gravity_scale=farr("gravity_scale"),
            type=farr("type", dtype=np.int32),
            flags=farr("flags", dtype=np.int32),
            sleep_time=up(np.zeros(Nb, np.float32)),
            sleep_threshold=farr("sleep_threshold"),
            min_extent=up(min_extent),
            max_extent=up(max_extent),
            island_label=up(np.arange(Nb, dtype=np.int32)),
            island_fresh=up(np.arange(Nb, dtype=np.int32)),
            island_dirty=up(np.asarray(True)),
            island_split_pending=up(np.asarray(False)),
            awake=farr("awake", dtype=bool),
            enabled=farr("enabled", dtype=bool),
            user_data=farr("user_data", dtype=np.int32),
        )

        sv = np.zeros((S, 8, 2), np.float32)
        sn = np.zeros((S, 8, 2), np.float32)
        scount = np.zeros(S, np.int32)
        stype = np.zeros(S, np.int32)
        sradius = np.zeros(S, np.float32)
        scentroid = np.zeros((S, 2), np.float32)
        sg1 = np.zeros((S, 2), np.float32)
        sg2 = np.zeros((S, 2), np.float32)
        for i, s in enumerate(self._shapes):
            geom: g.ShapeGeom = s["geom"]
            sv[i] = geom.verts
            sn[i] = geom.normals
            scount[i] = geom.count
            stype[i] = geom.type
            sradius[i] = geom.radius
            scentroid[i] = geom.centroid
            if geom.ghost1 is not None:
                sg1[i] = geom.ghost1
                sg2[i] = geom.ghost2
        scount[ns:] = 1  # keep padded lanes harmless

        def sarr(key, fill=0.0, dtype=np.float32):
            return farr(key, (), fill, dtype, src=self._shapes, n=S)

        shapes = Shapes(
            body=sarr("body", dtype=np.int32), type=up(stype),
            verts=up(sv), normals=up(sn), count=up(scount),
            radius=up(sradius), centroid=up(scentroid),
            ghost1=up(sg1), ghost2=up(sg2),
            friction=sarr("friction"), restitution=sarr("restitution"),
            rolling_resistance=sarr("rolling_resistance"),
            tangent_speed=sarr("tangent_speed"),
            user_material=sarr("user_material", dtype=np.int32),
            density=sarr("density"),
            filter_category=sarr("filter_category", dtype=np.uint32),
            filter_mask=sarr("filter_mask", dtype=np.uint32),
            filter_group=sarr("filter_group", dtype=np.int32),
            is_sensor=sarr("is_sensor", dtype=bool),
            enable_contact_events=sarr("enable_contact_events", dtype=bool),
            enable_hit_events=sarr("enable_hit_events", dtype=bool),
            enable_sensor_events=sarr("enable_sensor_events", dtype=bool),
            enabled=up(np.arange(S) < ns),
            table=None,
        )
        from .narrowphase import build_static_table, empty_cache
        shapes = dataclasses.replace(
            shapes, table=build_static_table(
                shapes, max(2, min(capacity.max_verts, 8))))

        d = self.def_
        f32 = lambda x: up(np.asarray(x, np.float32))
        tuning = Tuning(
            gravity=f32(d.gravity),
            restitution_threshold=f32(d.restitution_threshold),
            hit_event_threshold=f32(d.hit_event_threshold),
            contact_hertz=f32(d.contact_hertz),
            contact_damping_ratio=f32(d.contact_damping_ratio),
            contact_speed=f32(d.contact_speed),
            max_linear_speed=f32(d.maximum_linear_speed),
            joint_hertz=f32(d.joint_hertz),
            joint_damping_ratio=f32(d.joint_damping_ratio),
            enable_sleep=up(np.asarray(bool(d.enable_sleep))),
            enable_continuous=up(np.asarray(bool(d.enable_continuous))),
            enable_warm_starting=up(np.asarray(True)),
            enable_speculative=up(np.asarray(True)),
            enable_contact_softening=up(
                np.asarray(bool(d.enable_contact_softening))),
        )
        state = WorldState(
            bodies=bodies, shapes=shapes,
            contacts=empty_cache(capacity.max_contact_pairs, device),
            joints=self._build_joints(J, up), tuning=tuning,
            events=zero_events(capacity, device),
            profile=zero_profile(device),
            sensor_overlap=up(np.full(capacity.sensor_pair_capacity, -1,
                                      np.int32)),
            particles=(None if self._particle_builder is None
                       else self._particle_builder.build(device=device)),
            step_count=up(np.asarray(0, np.int32)),
            broadphase=zero_broadphase(S, capacity.max_contact_pairs, device),
        )
        return state, capacity

    def _build_joints(self, J: int, up) -> Joints:
        """Convert v2-style defs (anchor/axis/reference-angle) to the v3
        frame representation (ref: include/Types.cs:440-441 localFrameA/B),
        with the arithmetic of box2d_tpu/builder.py:394-483."""

        def col(key, default=0.0, dtype=np.float32, shape=()):
            out = np.full((J,) + shape, default, dtype)
            for i, j in enumerate(self._joints):
                if key in j and j[key] is not None:
                    out[i] = j[key]
            return out

        def z(shape=()):
            return up(np.zeros((J,) + shape, np.float32))

        fa_p = np.zeros((J, 2), np.float32)
        fb_p = np.zeros((J, 2), np.float32)
        fa_q = np.zeros((J, 2), np.float32)
        fb_q = np.zeros((J, 2), np.float32)
        fa_q[:, 0] = 1.0
        fb_q[:, 0] = 1.0
        lower = np.zeros(J, np.float32)
        upper = np.zeros(J, np.float32)
        max_motor = np.zeros(J, np.float32)
        spring_target = np.zeros(J, np.float32)
        for i, j in enumerate(self._joints):
            ty = j["_type"]
            fa_p[i] = j.get("local_anchor_a", (0.0, 0.0))
            fb_p[i] = j.get("local_anchor_b", (0.0, 0.0))
            ref = float(j.get("reference_angle", 0.0) or 0.0)
            if ty in (JOINT_PRISMATIC, JOINT_WHEEL):
                ax, ay = j.get("local_axis_a", (1.0, 0.0))
                aang = math.atan2(ay, ax)
                fa_q[i] = (math.cos(aang), math.sin(aang))
                fb_q[i] = (math.cos(aang - ref), math.sin(aang - ref))
                lower[i] = j.get("lower_translation", 0.0) or 0.0
                upper[i] = j.get("upper_translation", 0.0) or 0.0
                spring_target[i] = j.get("target_translation", 0.0) or 0.0
            elif ty in (JOINT_REVOLUTE, JOINT_WELD):
                fa_q[i] = (math.cos(ref), math.sin(ref))
                lower[i] = j.get("lower_angle", 0.0) or 0.0
                upper[i] = j.get("upper_angle", 0.0) or 0.0
                spring_target[i] = j.get("target_angle", 0.0) or 0.0
            elif ty == JOINT_DISTANCE:
                lower[i] = max(j.get("min_length", 0.0) or 0.0, 0.005)
                upper[i] = j.get("max_length", 1e5) or 1e5
            elif ty == JOINT_MOUSE:
                fa_p[i] = j.get("target", (0.0, 0.0))
            max_motor[i] = (j.get("max_motor_force", 0.0) or 0.0) + (
                j.get("max_motor_torque", 0.0) or 0.0)

        c = lambda *a, **kw: up(col(*a, **kw))
        return Joints(
            type=c("_type", -1, np.int32),
            enabled=up(np.arange(J) < len(self._joints)),
            body_a=c("body_a", -1, np.int32),
            body_b=c("body_b", -1, np.int32),
            frame_a_p=up(fa_p), frame_a_q=up(fa_q),
            frame_b_p=up(fb_p), frame_b_q=up(fb_q),
            collide_connected=c("collide_connected", False, bool),
            constraint_hertz=c("constraint_hertz", 60.0),
            constraint_damping_ratio=c("constraint_damping_ratio", 2.0),
            hertz=c("hertz"),
            damping_ratio=c("damping_ratio"),
            enable_spring=c("enable_spring", False, bool),
            enable_limit=c("enable_limit", False, bool),
            enable_motor=c("enable_motor", False, bool),
            lower=up(lower),
            upper=up(upper),
            motor_speed=c("motor_speed"),
            max_motor_force=up(max_motor),
            length=c("length", 1.0),
            lower_spring_force=c("lower_spring_force", -3.4e38),
            upper_spring_force=c("upper_spring_force", 3.4e38),
            spring_target=up(spring_target),
            angular_hertz=c("angular_hertz"),
            angular_damping_ratio=c("angular_damping_ratio"),
            linear_velocity=c("linear_velocity", 0.0, np.float32, (2,)),
            angular_velocity=c("angular_velocity"),
            max_velocity_force=up(col("max_velocity_force")
                                  + col("max_force")),
            max_velocity_torque=c("max_velocity_torque"),
            max_spring_force=c("max_spring_force"),
            max_spring_torque=c("max_spring_torque"),
            force_threshold=c("force_threshold", 3.4e38),
            torque_threshold=c("torque_threshold", 3.4e38),
            color=up(np.full(J, -1, np.int32)),
            impulse=z((2,)),
            spring_impulse=z(),
            spring_impulse2=z((2,)),
            motor_impulse=z(),
            lower_impulse=z(),
            upper_impulse=z(),
            angular_impulse=z(),
        )
