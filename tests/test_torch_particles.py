"""The particle slice of the port against the JAX package.

The same particle state, built by the JAX builder and advanced by the JAX
kernel-path `particle_step` (`use_window_kernel=True, rank_repair=True`,
Pallas kernels in interpret mode, one jit per scene), is carried into the
port with `state_from_numpy`, and one more step of each package is
compared: positions to 1e-5 and velocities to 1e-4 (the neighbour sums run
in another order), body impulses to 1e-5, overflow and stuck counts
exactly. Two scenes: a dam_break of 500 particles after 3 steps, and a
light box resting on a particle column at spawn (body coupling, lifetimes
and deaths; the JAX particle step alone does not move the box, so the
particles leave it within a few steps). The port's World is
stepped from spawn against the same JAX trajectory (the tank is static, so
the rigid pass moves nothing), and the 50-particle column is held against
the scalar oracle of tests/oracle_particles.py. Each flag-gated pass alone,
and the windowed neighbour pipeline, is held to the JAX package on
port_fixtures.every_gate_tank with every other flag masked off
(test_particle_paths_match_jax), and each pair or triad builder to the JAX
builder.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import geometry as jgeo
from box2d_tpu import particles as jpart
from box2d_tpu import scenes as jscenes
from box2d_tpu import types as jtypes
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import particles as tpart
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as ttypes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

DT = 1 / 60
STEPS = 4       # JAX particle steps from the built state
# JAX particle steps before the compared one
WARM = {"dam_break": 3, "floating_box": 0}


def floating_box(api, t, g, **kw):
    """The scene of tests/test_particles.py test_particles_push_floating_box
    with the light box resting on the column, so that it couples from the
    first step, plus a short-lived coloured group that dies during the
    compared step. Built through the api/types/geometry modules given, so
    that both packages build it. Continuous collision is off: the first
    steps throw the box up fast enough to open the CCD gate."""
    w = api.World(t.WorldDef(enable_continuous=False), **kw)
    tank = w.create_body(t.BodyDef(type=t.STATIC))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(6.0, 0.25, center=(0, -0.25)))
    box = w.create_body(t.BodyDef(type=t.DYNAMIC, position=(-1.0, 2.2)))
    w.create_polygon_shape(box, t.ShapeDef(density=0.2), g.box(0.2, 0.2))
    ps = w.create_particle_system(radius=0.08)
    ps.create_group_box(center=(-1.0, 1.0), half_w=0.8, half_h=1.0)
    ps.create_group_box(center=(1.5, 0.4), half_w=0.3, half_h=0.3,
                        velocity=(-0.5, 0.25), lifetime=0.01,
                        color=(0.2, 0.4, 0.6, 1.0))
    return w


SCENES = {
    "dam_break": (lambda: jscenes.dam_break(500),
                  lambda: tscenes.dam_break(500, device="cpu")),
    "floating_box": (lambda: floating_box(japi, jtypes, jgeo),
                     lambda: floating_box(tapi, ttypes, tgeo, device="cpu")),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """The JAX builder's state and STEPS JAX particle steps from it."""
    make_j, make_t = SCENES[request.param]
    jstate, _ = make_j().builder.build()
    tw = make_t()
    tw.compile()
    tcfg = tw._step.particle_cfg._replace(rank_repair=True)
    jcfg = jpart.ParticleConfig(**tcfg._asdict())
    step = jax.jit(jpart.particle_step, static_argnums=(3,))
    pts, outs = [jstate.particles], []
    for _ in range(STEPS):
        pt, dv, dw, ov = step(pts[-1], jstate, jnp.float32(DT), jcfg)
        pts.append(pt)
        outs.append((np.asarray(dv), np.asarray(dw), int(ov)))
    return dict(name=request.param, jstate=jstate, tcfg=tcfg, pts=pts,
                outs=outs, make_t=make_t)


def _leaves(pt):
    """{field: numpy array} of a Particles tree of either package."""
    return {f.name: np.asarray(getattr(pt, f.name))
            for f in dataclasses.fields(pt) if f.name != "params"}


def _check_particles(got, want, tag):
    alive = want["alive"]
    np.testing.assert_array_equal(got["alive"], alive, err_msg=tag)
    np.testing.assert_allclose(got["pos"][alive], want["pos"][alive],
                               rtol=0, atol=1e-5, err_msg=tag)
    np.testing.assert_allclose(got["vel"][alive], want["vel"][alive],
                               rtol=0, atol=1e-4, err_msg=tag)
    np.testing.assert_allclose(got["expiration"], want["expiration"],
                               rtol=0, atol=1e-6, err_msg=tag)
    np.testing.assert_array_equal(got["consecutive_contact_steps"],
                                  want["consecutive_contact_steps"],
                                  err_msg=tag)
    for key in ("force", "flags", "group", "color", "static_pressure"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_particle_step_matches_jax(scene):
    jstate = scene["jstate"]
    warm = WARM[scene["name"]]
    start = dataclasses.replace(jstate, particles=scene["pts"][warm])
    tstate = state_from_numpy(state_to_numpy(start), "cpu")
    stats = tworld.StepStats()
    pt, dv, dw, ov = tpart.particle_step(tstate.particles, tstate, DT,
                                         scene["tcfg"], stats)
    want_dv, want_dw, want_ov = scene["outs"][warm]
    _check_particles(_leaves(pt), _leaves(scene["pts"][warm + 1]),
                     scene["name"])
    np.testing.assert_allclose(dv.numpy(), want_dv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-5, atol=1e-5)
    assert int(ov) == want_ov
    assert stats.rank_repairs > 0, "the rank repair never engaged"
    assert stats.rank_repairs + stats.full_sorts == scene["tcfg"].iterations
    if scene["name"] == "floating_box":
        assert np.abs(want_dv).max() > 1e-3, "no body coupling"
        died = _leaves(scene["pts"][warm])["alive"] & ~_leaves(pt)["alive"]
        assert died.sum() > 0, "no particle reached its lifetime"


def test_world_from_spawn_matches_particle_steps(scene):
    """The port's World from spawn against the JAX particle steps (the
    scenes' static bodies take no impulse, so the rigid pass moves
    nothing): the particle gate runs the rigid pipeline on the first,
    dirty step only (the floating box is awake, so there it runs every
    step) and carries the particle overflow into the profile."""
    tw = scene["make_t"]()
    tw.compile()
    for i in range(STEPS):
        tw.step(DT)
        st = tw.stats
        if i == 0:
            first_syncs = st.syncs
        rigid_steps = st.steps - st.idle_steps
        if scene["name"] == "dam_break":
            assert rigid_steps == 1, (i, rigid_steps)
        else:
            assert rigid_steps == i + 1, (i, rigid_steps)
        assert int(tw.state.profile.overflow_particles) == \
            scene["outs"][i][2]
        assert int(tw.state.step_count) == i + 1
    assert st.rank_repairs == 0      # fewer than 2048 particles
    if scene["name"] == "dam_break":
        _check_particles(_leaves(tw.state.particles),
                         _leaves(scene["pts"][STEPS]), "world")
        # a skipped step reads the device once: the gate
        assert st.syncs == first_syncs + STEPS - 1
    else:
        box = tw.state.bodies
        assert bool(box.awake[1]) and float(box.v[1, 1]) != 0.0


@pytest.mark.parametrize("skipped", [False, True], ids=["rigid", "skip"])
def test_gate_carries_particle_overflow(skipped):
    """Nearby shapes beyond max_body_shapes are counted into
    profile.overflow_particles on both branches of the particle gate."""
    tw = tscenes.dam_break(200, device="cpu")
    tw.compile()
    if skipped:
        tw.step(DT)
    step = tw._step
    # the floor and the left wall are near the column; one slot for two
    cfg = step.particle_cfg._replace(max_body_shapes=1)
    stats = tworld.StepStats()
    out = tworld._step(tw.state, DT, step.capacity, step.classes,
                       step.substeps, step.continuous, stats,
                       particle_cfg=cfg)
    assert stats.idle_steps == int(skipped)
    assert int(out.profile.overflow_particles) == 1


def test_builder_leaves_bit_identical_with_group_options():
    """create_particle and create_group_box with velocity, lifetime, colour
    and group flags: every particles.* leaf equal to the JAX builder's."""
    def build(api, t, g, **kw):
        w = api.World(**kw)
        ground = w.create_body(t.BodyDef(type=t.STATIC))
        w.create_polygon_shape(ground, t.ShapeDef(), g.box(3.0, 0.25))
        ps = w.create_particle_system(radius=0.07, density=1.3)
        ps.create_particle((0.1, 0.9), velocity=(1.0, -2.0), lifetime=0.5,
                           color=(1.0, 0.0, 0.0, 0.5))
        ps.create_group_box(center=(0.3, 1.1), half_w=0.41, half_h=0.27,
                            group_flags=tpart.G_SOLID, strength=0.7,
                            velocity=(0.25, 0.5), lifetime=3.0,
                            color=(0.1, 0.2, 0.3, 0.4))
        ps.create_group_box(center=(-1.2, 0.6), half_w=0.2, half_h=0.33)
        return w

    jstate, _ = build(japi, jtypes, jgeo).builder.build()
    tw = build(tapi, ttypes, tgeo, device="cpu")
    tstate, _ = tw.builder.build(device="cpu")
    a, b = state_to_numpy(jstate), state_to_numpy(tstate)
    keys = [k for k in a if k.startswith("particles.")]
    assert sorted(keys) == sorted(k for k in b if k.startswith("particles."))
    for key in keys:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["particles.pos"].shape[0] > 20


GATES = ["viscous", "repulsive", "powder", "tensile", "static_pressure",
         "colormix", "elastic", "spring", "barrier", "solid", "rigid", "wall"]
# the particle flag (or group flag) each gate's pass reads
GATE_BITS = {"viscous": tpart.P_VISCOUS, "repulsive": tpart.P_REPULSIVE,
             "powder": tpart.P_POWDER, "tensile": tpart.P_TENSILE,
             "static_pressure": tpart.P_STATIC_PRESSURE,
             "colormix": tpart.P_COLOR_MIXING, "elastic": tpart.P_ELASTIC,
             "spring": tpart.P_SPRING, "barrier": tpart.P_BARRIER,
             "wall": tpart.P_WALL, "solid": tpart.G_SOLID,
             "rigid": tpart.G_RIGID}


@pytest.fixture(scope="module")
def small_world():
    tw = tscenes.dam_break(100, device="cpu")
    tw.compile()
    return tw


@pytest.fixture(scope="module")
def gate_tank():
    """port_fixtures.every_gate_tank: the JAX state, the JAX particle step
    with every gate on (one jit, at the shapes of
    tests/test_torch_particle_groups.py) and its particles after 3 steps,
    and the port's config with every gate off."""
    from port_fixtures import every_gate_tank

    jstate, _ = every_gate_tank(japi.World, jtypes, jgeo).builder.build()
    tw = every_gate_tank(tapi.World, ttypes, tgeo, device="cpu")
    tw.compile()
    tcfg = tw._step.particle_cfg
    jcfg = jpart.ParticleConfig(**tcfg._asdict())
    jstep = jax.jit(jpart.particle_step, static_argnums=(3,))
    pt = jstate.particles
    for _ in range(3):
        pt = jstep(pt, jstate, jnp.float32(DT), jcfg)[0]
    plain = tcfg._replace(**{f: False for f in tcfg._fields
                             if f.startswith("has_")})
    return dict(jstate=jstate, pt=pt, jcfg=jcfg, plain=plain,
                step=lambda p: jstep(p, jstate, jnp.float32(DT), jcfg))


def _only(pt, what):
    """The JAX particles with every flag but the gate's masked off (the
    same shapes; "windowed": none left). A solid group is flagged to
    derive its depth again. The barrier line keeps its P_WALL: a moving
    barrier takes the reference's cancelling quadratic root, where one
    rounding stops a particle far from the segment (ROADMAP.md section
    3)."""
    bit = GATE_BITS.get(what, 0)
    if what == "barrier":
        bit |= tpart.P_WALL
    keep = 0 if what in ("solid", "rigid") else bit
    gkeep = bit if what in ("solid", "rigid") else 0
    gflags = np.asarray(pt.group_flags) & gkeep
    if what == "solid":
        gflags = np.where(gflags != 0, gflags | tpart.G_NEEDS_DEPTH, 0)
    return dataclasses.replace(
        pt, flags=pt.flags & keep, pair_flags=pt.pair_flags & keep,
        triad_flags=pt.triad_flags & keep,
        group_flags=jnp.asarray(gflags.astype(np.int32)))


@pytest.mark.parametrize("what", GATES + ["windowed", "culling",
                                          "non_polygon"])
def test_particle_paths_match_jax(gate_tank, small_world, what):
    """Each gated pass alone, and the windowed neighbour pipeline
    (use_window_kernel=False), against the JAX package: every_gate_tank
    after 3 JAX steps with every flag but the gate's masked off, one step
    through the JAX all-gates trace (its windowed pipeline) and through
    the port with only that gate on; tests/test_torch_particle_groups.py's
    bounds. The anti-tunnel ray against non-polygon shapes (queue 10b):
    forced on the polygon dam_break, its branch (queries.ray_shape_analytic)
    gives what the polygon branch gives. Per-block shape culling (queue
    12): with two slots a block for the tank's three shapes, the culled
    step gives what the dense one gives, to the bound of
    tests/test_particles.py:304-332."""
    if what in ("non_polygon", "culling"):
        cfg = small_world._step.particle_cfg
        state = small_world.state
        other = (cfg._replace(geom_types=frozenset({0, 3}))
                 if what == "non_polygon" else
                 cfg._replace(block_shape_slots=2))
        a = tpart.particle_step(state.particles, state, DT, other)
        b = tpart.particle_step(state.particles, state, DT, cfg)
        tol = (dict(atol=1e-5, rtol=0) if what == "non_polygon" else
               dict(atol=5e-5, rtol=1e-5))
        torch.testing.assert_close(a[0].pos, b[0].pos, **tol)
        torch.testing.assert_close(a[0].vel, b[0].vel, **tol)
        if what == "culling":
            assert cfg.max_body_shapes > 2, "the culled path is not taken"
            torch.testing.assert_close(a[1], b[1], **tol)
            assert int(a[3]) == int(b[3]) == 0
        return
    from test_torch_particle_groups import check_step

    start_j = _only(gate_tank["pt"], what)
    want, want_dv, want_dw, want_ov = gate_tank["step"](start_j)
    start = state_from_numpy(state_to_numpy(dataclasses.replace(
        gate_tank["jstate"], particles=start_j)), "cpu")
    cfg = (gate_tank["plain"]._replace(use_window_kernel=False)
           if what == "windowed" else
           gate_tank["plain"]._replace(**{"has_" + what: True}))
    if what == "barrier":
        cfg = cfg._replace(has_wall=True)
    stats = tworld.StepStats()
    got, dv, dw, ov = tpart.particle_step(start.particles, start, DT, cfg,
                                          stats)
    check_step(_leaves(got), _leaves(want), what, dv.numpy(), dw.numpy(),
               np.asarray(want_dv), np.asarray(want_dw))
    assert int(ov) == int(want_ov)
    # K3 and K4 only where no gate needs the flat pair view or the remap
    assert stats.full_sorts == cfg.iterations
    if what == "solid":
        assert stats.rounds["depth"] > 0 and got.depth.max() > 0


@pytest.mark.parametrize("flags", [tpart.P_SPRING, tpart.P_ELASTIC,
                                   tpart.P_BARRIER])
def test_pairs_and_triads_match_jax_builder(flags):
    """A spring, elastic or barrier group box: the builder's particles,
    pairs and triads bit for bit the JAX builder's (its native path)."""
    from box2d_tpu import native as jnative

    assert jnative._load() is not None, "the JAX builder took its fallback"
    jps = jpart.ParticleSystemBuilder(0.1)
    tps = tpart.ParticleSystemBuilder(0.1)
    for ps in (jps, tps):
        ps.create_group_box((0.0, 1.0), 0.3, 0.3, flags=flags, strength=0.8)
    a = _leaves(jps.build())
    b = _leaves(tps.build(device="cpu"))
    for key, v in a.items():
        assert b[key].dtype == v.dtype, key
        np.testing.assert_array_equal(b[key], v, err_msg=key)
    made = (b["triad_a"] if flags == tpart.P_ELASTIC else b["pair_a"])
    assert made.shape[0] > 10


def test_gated_flag_compiles_and_steps():
    """A World with a viscous group compiles (every gate passes compile)
    and steps, taking the windowed pipeline."""
    w = tapi.World(device="cpu")
    ps = w.create_particle_system(radius=0.1)
    ps.create_group_box((0.0, 1.0), 0.3, 0.3, flags=tpart.P_VISCOUS)
    w.compile()
    assert w._step.particle_cfg.has_viscous
    w.run(2)
    assert torch.isfinite(w.state.particles.pos).all()
    assert w.stats.full_sorts == 8 and w.stats.rank_repairs == 0


def _oracle_run(boxes, pts, radius, steps):
    import oracle_particles as op

    w = tapi.World(ttypes.WorldDef(enable_sleep=False,
                                   enable_continuous=False), device="cpu")
    tank = w.create_body(ttypes.BodyDef(type=ttypes.STATIC))
    for c, h in boxes:
        w.create_polygon_shape(tank, ttypes.ShapeDef(),
                               tgeo.box(h[0], h[1], center=c))
    ps = w.create_particle_system(radius=radius)
    for p in pts:
        ps.create_particle(p)
    w.compile()
    pw = op.PWorld(boxes, radius=radius)
    pos = np.asarray(pts, np.float32)
    vel = np.zeros_like(pos)
    for _ in range(steps):
        w.step(DT)
        pos, vel = pw.step(pos, vel, DT)
    return w.state.particles.pos.numpy()[:len(pts)], pos


def test_particle_column_oracle_exact():
    """The 50-particle column of tests/test_oracle.py
    test_particle_column_oracle_exact, stepped by the port, against the
    scalar LiquidFun transliteration: the JAX test's bound, 1e-6 over 2
    steps."""
    boxes = [((0.0, -0.25), (1.0, 0.25)),
             ((-1.0, 1.0), (0.25, 1.5)),
             ((1.0, 1.0), (0.25, 1.5))]
    radius = 0.05
    stride = 0.75 * 2 * radius
    pts = [(-0.5 + c * stride, 0.06 + r * stride)
           for r in range(10) for c in range(5)]
    eng, pos = _oracle_run(boxes, pts, radius, 2)
    drift = np.max(np.abs(eng - pos))
    assert drift < 1e-6, f"particle column early drift {drift}"


@pytest.mark.slow
def test_particle_bed_oracle_drift():
    """The 2-layer bed of tests/test_oracle.py test_particle_bed_oracle_drift
    over its 1000 steps, at the JAX test's 1e-2 drift bound (slow: about 80
    s on the CPU, where the K3 twin walks each neighbour range in lane
    order)."""
    boxes = [((0.0, -0.25), (1.2, 0.25)),
             ((-1.2, 1.0), (0.25, 1.5)),
             ((1.2, 1.0), (0.25, 1.5))]
    radius = 0.05
    stride = 0.75 * 2 * radius
    pts = [(-0.9 + c * stride, 0.05 + r * stride)
           for r in range(2) for c in range(25)]
    t0 = time.perf_counter()
    eng, pos = _oracle_run(boxes, pts, radius, 1000)
    drift = np.max(np.abs(eng - pos))
    assert drift < 1e-2, f"particle bed drift {drift}"
    print(f"bed drift {drift:.3e} in {time.perf_counter() - t0:.1f} s")
