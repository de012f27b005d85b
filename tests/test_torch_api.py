"""The host API: the port's World against the JAX package's.

port_fixtures.api_scene (all_types_scene, a pyramid of 8 rows, every joint
type, every shape class, a sensor and a filtered shape, so that no call
remakes the JAX World's step) is stepped 5 times by the port; the JAX
World takes the same state (state_to_numpy). Then one scripted sequence of
getters and setters (bodies, world tuning, joints, shapes, queries) runs
on both worlds: each return value must match (integers, flags, handles
and ids exactly, floats to 1e-5) and so must every state leaf after each
call. The JAX World is never stepped. `validate()` and `draw_data` are
held to the JAX package's; the query wrappers and `explode` to the
port's queries module (tests/test_torch_queries.py holds it to the JAX package);
`contact_data`, `counters`, `profile_phases` and
`run(collect_events=True)` to the port's own step phases on pyramid-5
(tests/test_torch_phases.py holds those to the JAX package). Also: a state
that an earlier step returned is unchanged by later setters, every public
method of box2d_tpu.api.World exists on the port's World (the particle
methods are held to the JAX World in tests/test_torch_particle_groups.py),
and the host-side particle queries.
"""

import copy
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import draw as jdraw
from box2d_tpu import geometry as jg
from box2d_tpu import types as jt
from box2d_tpu import validate as jvalidate
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import draw as tdraw
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import queries as tq
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as tt
from box2d_tpu_torch.state import state_to_numpy
from box2d_tpu_torch.world import StepStats, _step_work
from port_fixtures import api_scene
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

ATOL = 1e-5
# public methods of box2d_tpu.api.World the port leaves out: none
DEFERRED: set = set()

# handles of api_scene: bodies, shapes and joints in creation order
CHASSIS, WHEEL, PUCK, BALL, PYR = 3, 4, 5, 6, 20
PEND, SLIDER, ODD = 45, 46, 49
S_BOX, S_WHEEL, S_PEND, S_SEGMENT, S_SENSOR = 20, 4, 44, 48, 51
J_WELD, J_WHEEL, J_MOTOR, J_MOUSE, J_DIST, J_REV, J_PRISM = range(7)


@pytest.fixture(scope="module")
def worlds():
    tw = api_scene(tapi.World, tt, tg, device="cpu")
    tw.compile()
    tw.run(5)
    jw = api_scene(japi.World, jt, jg)
    jw.compile()
    jw.state = to_jax_state(jw.state, state_to_numpy(tw.state))
    return tw, jw


def same(a, b, name):
    """Equal results: exact for integers, flags and strings, 1e-5 for
    floats; recurses into tuples, lists, dicts and dataclasses."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    if isinstance(a, dict):
        assert set(a) == set(b), name
        for k in a:
            same(a[k], b[k], f"{name}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), (name, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{name}[{i}]")
    elif dataclasses.is_dataclass(a):
        same(dataclasses.asdict(a), dataclasses.asdict(b), name)
    elif a is None or isinstance(a, (bool, str, np.bool_)):
        assert a == b, (name, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind in "biu" and b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a.astype(np.float64), b, atol=ATOL,
                                       rtol=0, err_msg=name)


def same_state(tw, jw, name):
    a = state_to_numpy(tw.state)
    b = state_to_numpy(jw.state)
    assert set(a) == set(b)
    for k in a:
        same(a[k], b[k], f"{name}: {k}")


GETTERS = [
    ("body_position", (PYR,)), ("body_angle", (CHASSIS,)),
    ("body_linear_velocity", (WHEEL,)), ("body_angular_velocity", (PUCK,)),
    ("body_transform", (PEND,)), ("body_mass", (CHASSIS,)),
    ("body_rotational_inertia", (CHASSIS,)),
    ("body_local_center", (PEND,)), ("body_world_center", (PEND,)),
    ("body_is_awake", (PYR,)), ("local_point", (CHASSIS, (5.5, 2.5))),
    ("world_point", (CHASSIS, (0.3, -0.2))),
    ("local_vector", (WHEEL, (1.0, 2.0))),
    ("world_vector", (WHEEL, (1.0, 2.0))),
    ("world_point_velocity", (PUCK, (-5.0, 3.5))),
    ("local_point_velocity", (PUCK, (0.2, 0.1))),
    ("body_mass_data", (SLIDER,)), ("body_motion_locks", (SLIDER,)),
    ("is_bullet", (BALL,)), ("body_user_data", (BALL,)),
    ("body_shapes", (0,)), ("body_joints", (CHASSIS,)),
    ("body_compute_aabb", (0,)),
    ("joint_param", (J_WHEEL, "motor_speed")),
    ("joint_param", (J_MOTOR, "linear_velocity")),
    ("joint_constraint_force", (J_REV,)), ("joint_bodies", (J_PRISM,)),
    ("distance_joint_current_length", (J_DIST,)),
    ("revolute_joint_angle", (J_REV,)),
    ("prismatic_joint_translation", (J_PRISM,)),
    ("wheel_joint_translation", (J_WHEEL,)),
    ("joint_linear_separation", (J_WELD,)),
    ("joint_angular_separation", (J_WELD,)),
    ("joint_local_frames", (J_MOUSE,)), ("joint_user_data", (J_DIST,)),
    ("shape_aabb", (S_PEND,)), ("shape_body", (S_WHEEL,)),
    ("shape_friction", (S_BOX,)), ("shape_restitution", (S_BOX,)),
    ("shape_density", (S_BOX,)), ("shape_surface_material", (S_BOX,)),
    ("shape_filter", (52,)), ("shape_geometry", (S_PEND,)),
    ("shape_ray_cast", (S_PEND, (-14.0, 6.0), (4.0, 0.0))),
    ("shape_ray_cast", (S_SEGMENT, (-27.0, 3.0), (0.0, -4.0))),
    ("shape_closest_point", (S_BOX, (30.0, 3.0))),
    ("shape_closest_point", (S_WHEEL, (7.0, 2.0))),
    ("counters", ()), ("byte_count", ()), ("body_move_events", ()),
]

SETTERS = [
    ("set_linear_velocity", (PYR, (0.5, 1.0))),
    ("set_angular_velocity", (PYR + 1, 2.0)),
    ("apply_force_to_center", (PYR + 2, (10.0, 5.0))),
    ("apply_linear_impulse_to_center", (PYR + 3, (1.0, 2.0))),
    ("apply_torque", (PYR + 4, 3.5)),
    ("apply_force", (CHASSIS, (4.0, -2.0), (5.5, 2.2))),
    ("clear_forces", (PYR + 2,)),
    ("apply_angular_impulse", (WHEEL, 0.7)),
    ("apply_linear_impulse", (PUCK, (0.3, 0.1), (-5.1, 3.1))),
    ("set_mass_data", (SLIDER, 2.0, (0.1, 0.0), 0.4)),
    ("apply_mass_from_shapes", (SLIDER,)),
    ("set_body_motion_locks", (PEND, True, False, True)),
    ("set_bullet", (BALL, True)), ("set_body_user_data", (BALL, 77)),
    ("set_sleep_threshold", (PYR, 0.1)),
    ("set_linear_damping", (PYR, 0.2)),
    ("set_angular_damping", (PYR, 0.3)),
    ("set_gravity_scale", (PUCK, 0.5)),
    ("wake_touching", (PYR + 5,)),
    ("set_target_transform", (PYR + 6, (26.0, 3.0), 0.4, 1.0 / 60.0)),
    ("set_transform", (ODD, (-23.0, 2.0), 0.3)),
    ("wake_body", (PYR + 7,)), ("set_body_enabled", (PYR + 8, False)),
    ("set_gravity", ((0.0, -9.0),)),
    ("set_contact_tuning", (25.0, 5.0, 2.0)),
    ("set_restitution_threshold", (0.5,)),
    ("set_hit_event_threshold", (0.7,)),
    ("set_maximum_linear_speed", (100.0,)),
    ("enable_sleep", (False,)), ("enable_warm_starting", (False,)),
    ("set_contact_softening", (True,)),
    ("enable_joint_motor", (J_REV, False)),
    ("set_joint_motor_speed", (J_WHEEL, -2.0)),
    ("set_joint_max_motor_force", (J_WHEEL, 12.0)),
    ("enable_joint_limit", (J_PRISM, False)),
    ("set_joint_limits", (J_REV, -0.5, 0.5)),
    ("enable_joint_spring", (J_WHEEL, False)),
    ("set_joint_spring_hertz", (J_PRISM, 3.0)),
    ("set_joint_spring_damping_ratio", (J_PRISM, 0.9)),
    ("set_joint_spring_target", (J_REV, 0.25)),
    ("set_joint_angular_spring", (J_WELD, 5.0, 0.5)),
    ("set_distance_joint_length", (J_DIST, 1.3)),
    ("set_distance_joint_spring_forces", (J_DIST, -4.0, 6.0)),
    ("set_motor_joint_velocity", (J_MOTOR, (0.0, 1.0), -0.5)),
    ("set_motor_joint_max_force", (J_MOTOR, 8.0, 3.0)),
    ("set_joint_thresholds", (J_WELD, 5.0, 4.0)),
    ("set_joint_enabled", (J_WELD, False)),
    ("set_joint_enabled", (J_WELD, True)),
    ("set_mouse_target", (J_MOUSE, (-6.0, 5.0))),
    ("set_joint_local_frames", (J_DIST, (0.1, 0.0), (0.0, 0.1))),
    ("set_joint_user_data", (J_DIST, 9)),
    ("set_friction", (S_BOX, 0.3)), ("set_restitution", (S_BOX, 0.4)),
    ("set_density", (S_PEND, 2.5)),
    ("set_surface_material", (S_BOX + 1, 0.2, 0.1, 0.05, 0.5, 4)),
    ("enable_shape_contact_events", (S_BOX, True)),
    ("enable_shape_hit_events", (S_BOX, True)),
    ("enable_shape_sensor_events", (S_BOX + 2, True)),
    ("apply_wind_force", (S_BOX + 3, (8.0, 1.0), 1.0, 0.3)),
    ("apply_wind_force", (S_WHEEL, (8.0, 1.0), 1.0, 0.3)),
    ("apply_wind_force", (S_SEGMENT, (8.0, 1.0), 1.0, 0.3)),
    ("apply_wind_force", (S_PEND, (8.0, 1.0), 1.0, 0.3)),
]


def test_getters_and_setters_match_jax(worlds):
    tw, jw = worlds
    same_state(tw, jw, "start")
    for name, args in GETTERS:
        same(getattr(tw, name)(*args), getattr(jw, name)(*args),
             f"{name}{args}")
    # the JAX World's test_point compiles its GJK loop on every call: once
    center = tuple(tw.body_world_center(tw.shape_body(S_BOX)))
    inside = tw.test_point(S_BOX, center)
    assert inside == jw.test_point(S_BOX, center) and inside
    assert not tw.test_point(S_BOX, (25.0, 9.0))
    for name, args in SETTERS:
        same(getattr(tw, name)(*args), getattr(jw, name)(*args),
             f"{name}{args}")
        same_state(tw, jw, f"after {name}{args}")
    for name, args in GETTERS:
        same(getattr(tw, name)(*args), getattr(jw, name)(*args),
             f"{name}{args} after the setters")


def test_query_wrappers(worlds):
    """The World's query wrappers give what box2d_tpu_torch.queries gives
    (tests/test_torch_queries.py holds each query to the JAX package)."""
    tw, _ = worlds
    st = tw.state
    ray = ((-30.0, 0.4), (80.0, 0.0))
    same(tw.cast_ray_closest(*ray), tq.cast_ray_closest(st, *ray),
         "cast_ray_closest")
    hits = tw.cast_ray_all(*ray, 6)
    ref = tq.cast_ray_all(st, *ray, 6)
    n = int(ref.count)
    assert n > 2
    same(hits, {"shape": ref.shape[:n], "point": ref.point[:n],
                "normal": ref.normal[:n], "fraction": ref.fraction[:n]},
         "cast_ray_all")
    same(tw.overlap_point((25.0, 0.5)), tq.overlap_point(st, (25.0, 0.5)),
         "overlap_point")
    box = (20.0, 0.0, 30.0, 2.0)
    same(tw.overlap_aabb(box), tq.overlap_aabb(st, box), "overlap_aabb")
    mover = ((-28.0, 0.7), (-28.0, 1.5), 0.5)
    same(tw.cast_mover(*mover, (10.0, 0.0)),
         float(tq.cast_mover(st, *mover, (10.0, 0.0))), "cast_mover")
    same(tw.collide_mover(*mover), tq.collide_mover(st, *mover),
         "collide_mover")
    tw.explode((25.0, 1.0), 3.0, 2.0)
    ref = tq.explode(st, (25.0, 1.0), 3.0, 2.0)
    same(tw.state.bodies.v, ref.bodies.v, "explode")
    assert not torch.equal(ref.bodies.v, st.bodies.v)
    tw.state = st


def test_validate_and_draw_match_jax(worlds):
    tw, jw = worlds
    assert tw.validate() == jvalidate.validate_world(jw) == []
    for color_by in ("state", "island", "graph_color"):
        same(tdraw.draw_data(tw.state, color_by),
             jdraw.draw_data(jw.state, color_by), f"draw_data {color_by}")
    # a violation is reported with the JAX package's message
    bad = copy.copy(tw)
    bad.state = dataclasses.replace(tw.state, bodies=dataclasses.replace(
        tw.state.bodies, inv_mass=tw.state.bodies.inv_mass + 1.0))
    out = bad.validate(raise_on_error=False)
    assert "static/kinematic body with nonzero inv_mass" in out
    with pytest.raises(AssertionError):
        bad.validate()


def test_output_against_the_port_phases():
    """contact_data and counters from the port's narrow phase and state;
    run(collect_events=True) stacks what step() gives frame by frame;
    profile_phases times every prefix."""
    w = tscenes.pyramid(rows=5, device="cpu")
    w.compile()
    w.run(4)
    d = _step_work(w.state, 1 / 60, w.capacity, w._classes, w.substeps,
                   False, StepStats(), until="narrow")
    pc = d.manifold.point_count.numpy()
    cd = w.contact_data()
    keep = pc > 0
    np.testing.assert_array_equal(cd["shape_a"], d.shape_a.numpy()[keep])
    np.testing.assert_array_equal(cd["shape_b"], d.shape_b.numpy()[keep])
    np.testing.assert_array_equal(cd["point"], d.manifold.point.numpy()[keep])
    assert keep.sum() > 10
    # body_contact_data: the body's rows of contact_data (the JAX
    # package's version raises, ROADMAP.md §3)
    mine = {w._sid(h) for h in w.body_shapes(1)}
    rows = w.body_contact_data(1)
    want = [(int(a), int(b)) for a, b in zip(cd["shape_a"], cd["shape_b"])
            if int(a) in mine or int(b) in mine]
    assert [(r[0], r[1]) for r in rows] == want and want
    c = w.counters()
    assert c["body_count"] == 16 and c["shape_count"] == 16
    assert c["joint_count"] == 0
    assert c["contact_count"] == int(w.state.contacts.touching.sum())

    s0 = w.state
    stepped = []
    for _ in range(3):
        w.step()
        stepped.append(w.state.events)
    w.state = s0
    state, ev = w.run(3, collect_events=True)
    for f in dataclasses.fields(ev):
        want = torch.stack([getattr(e, f.name) for e in stepped])
        assert torch.equal(getattr(ev, f.name), want), f.name
    assert ev.body_move_count.shape == (3,)
    assert int(ev.contact_begin_count.sum()) >= 0
    assert w.profile is state.profile and w.events is state.events
    ph = w.profile_phases(n=1)
    assert set(ph) == {"aabbs", "pairs", "narrow", "colors", "prepare",
                       "layout", "kernel", "store", "events", "continuous",
                       "finalize", "sleep", "total"}
    assert ph["total"] > 0
    assert w.state is state       # profile_phases changes no state


def test_a_returned_state_is_never_changed():
    """The snapshot a step returned stays as it was through every setter,
    spawn and destroy (the JAX package's states are immutable)."""
    w = api_scene(tapi.World, tt, tg, device="cpu")
    cap = w.builder.default_capacity()
    w.compile(dataclasses.replace(cap, max_bodies=cap.max_bodies + 4,
                                  max_shapes=cap.max_shapes + 4,
                                  max_joints=cap.max_joints + 2))
    snap = w.step()
    before = {k: v.copy() for k, v in state_to_numpy(snap).items()}
    for name, args in SETTERS:
        getattr(w, name)(*args)
    b = w.create_body(tt.BodyDef(type=2, position=(0.0, 9.0)))
    w.create_polygon_shape(b, tt.ShapeDef(), tg.box(0.2, 0.2))
    w.set_body_type(PYR, 0)
    w.set_filter(S_BOX, tt.Filter(group_index=-1))
    w.destroy_body(PYR + 1)
    w.destroy_joint(J_DIST)
    w.create_joint(tt.RevoluteJointDef(body_a=0, body_b=b))
    after = state_to_numpy(snap)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert not np.array_equal(state_to_numpy(w.state)["bodies.v"],
                              before["bodies.v"])


def test_the_surface_matches_jax():
    """Every public method and property of box2d_tpu.api.World exists on
    the port's World."""
    def public(cls):
        return {n for n, _ in inspect.getmembers(cls)
                if not n.startswith("_")}

    ref = public(japi.World)
    assert DEFERRED <= ref
    missing = ref - DEFERRED - public(tapi.World)
    assert not missing, sorted(missing)


def test_particle_host_queries_match_jax():
    """overlap_particles and cast_ray_particles on one particle box."""
    def make(World, t, g, **kw):
        w = World(t.WorldDef(enable_continuous=False), **kw)
        ground = w.create_body(t.BodyDef(type=0))
        w.create_polygon_shape(ground, t.ShapeDef(),
                               g.box(3.0, 0.2, center=(0.0, -0.2)))
        ps = w.create_particle_system(radius=0.1)
        ps.create_group_box(center=(0.0, 1.0), half_w=0.6, half_h=0.5)
        return w

    tw = make(tapi.World, tt, tg, device="cpu")
    tw.compile()
    jw = make(japi.World, jt, jg)
    jw.compile()
    same(state_to_numpy(tw.state)["particles.pos"],
         np.asarray(jw.state.particles.pos), "particles.pos")
    for lo, hi in (((-0.3, 0.6), (0.3, 1.2)), ((5.0, 5.0), (6.0, 6.0))):
        same(tw.overlap_particles(lo, hi), jw.overlap_particles(lo, hi),
             f"overlap_particles {lo} {hi}")
    for o, d in (((-2.0, 1.0), (4.0, 0.1)), ((0.0, 5.0), (0.0, 1.0))):
        same(tw.cast_ray_particles(o, d), jw.cast_ray_particles(o, d),
             f"cast_ray_particles {o} {d}")


def _keep_pair(a, b):
    return (a + b) % 3 != 0


def _one_way(state, a, b, manifold):
    """Drop the upward-facing manifolds of odd shape_a lanes (a one-way
    rule over the lanes; the same code runs on torch and JAX arrays)."""
    return (manifold.normal[:, 1] < 0.9) | (a % 2 == 0)


@pytest.fixture(scope="module")
def hook_world():
    import jax
    import jax.numpy as jnp

    from box2d_tpu import narrowphase as jnarrow
    from box2d_tpu import scenes as jscenes
    from box2d_tpu.world import _step_work as jax_step_work

    tw = tscenes.pyramid(rows=4, device="cpu")
    tw.compile()
    tw.run(10)
    warm = state_to_numpy(tw.state)
    pushed = {k: v.copy() for k, v in warm.items()}
    pushed["bodies.center"][-1, 0] += 0.3     # escapes its fat AABB
    dirty = dict(warm)
    dirty["broadphase.dirty"] = np.asarray(True)
    jw = jscenes.pyramid(rows=4)
    template, cap = jw.builder.build()
    classes = jnarrow.classes_for_shape_types(
        s["geom"].type for s in jw.builder._shapes)
    fn = jax.jit(lambda st: jax_step_work(
        st, jnp.float32(1 / 60), cap, classes, 4, until="narrow",
        custom_filter=lambda s, a, b: _keep_pair(a, b),
        pre_solve=_one_way))
    return tw, template, fn, {"pushed": pushed, "dirty": dirty}


@pytest.mark.parametrize("tier", ["dirty", "pushed"])
def test_hooks_match_jax(hook_world, tier):
    """The custom filter where pairs are built (a full rebuild, the new
    pairs of a repair) and the pre-solve mask on the fresh manifolds, at
    the JAX package's narrow-phase prefix."""
    from box2d_tpu_torch.state import state_from_numpy
    from box2d_tpu_torch.world import Hooks

    tw, template, fn, states = hook_world
    leaves = states[tier]
    ref = fn(to_jax_state(template, leaves))
    ts = state_from_numpy(leaves, "cpu")

    def narrow(hooks):
        return _step_work(ts, 1 / 60, tw.capacity, tw._classes, 4, False,
                          StepStats(), until="narrow", hooks=hooks)

    out = narrow(Hooks(lambda s, a, b: _keep_pair(a, b), _one_way))
    for name in ("shape_a", "shape_b"):
        same(getattr(out, name), np.asarray(getattr(ref, name)), name)
    for name in ("point_count", "normal", "point", "separation"):
        same(getattr(out.manifold, name),
             np.asarray(getattr(ref.manifold, name)), name)
    plain = narrow(Hooks())
    pc, pc0 = out.manifold.point_count, plain.manifold.point_count
    assert (pc0 > 0).sum() > (pc > 0).sum() > 0
    if tier == "dirty":      # the filter dropped pairs of the rebuild
        def n_pairs(hooks):
            pairs, _ = _step_work(ts, 1 / 60, tw.capacity, tw._classes, 4,
                                  False, StepStats(), until="pairs",
                                  hooks=hooks)
            return int(pairs.valid.sum())

        kept = n_pairs(Hooks(lambda s, a, b: _keep_pair(a, b)))
        assert 0 < kept < n_pairs(Hooks())


def test_world_hooks_remake_the_step():
    """set_custom_filter / set_pre_solve make a new step that carries the
    hooks, keeps the state and the StepStats, and steps with them."""
    w = tscenes.pyramid(rows=4, device="cpu")
    w.compile()
    w.run(3)
    stats, state = w.stats, w.state
    w.set_custom_filter(lambda s, a, b: _keep_pair(a, b))
    w.set_pre_solve(_one_way)
    assert w.stats is stats and w.state.bodies is not None
    assert w._step.hooks.pre_solve is _one_way
    assert torch.equal(w.state.bodies.center, state.bodies.center)
    assert bool(w.state.broadphase.dirty)
    w.run(2)
    assert w.stats.steps == 5
    touching = w.state.contacts.touching
    ka, kb = w.state.contacts.key_a, w.state.contacts.key_b
    assert not (touching & ((ka + kb) % 3 == 0)).any()
