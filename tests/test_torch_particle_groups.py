"""The gated particle passes, pairs, triads and groups of the port against
the JAX package.

The scene is port_fixtures.every_gate_tank at about 700 particles: a small
group for every particle flag that gates a pass, a solid and a rigid
group, a P_BARRIER | P_WALL line and a light dynamic box. The JAX
`particle_step` is jitted once, with every gate on (its windowed
pipeline, as on the CPU), at one particle, pair, triad and group count;
tests/test_torch_particles.py's per-gate cases reuse the same shapes. Its
warm states are carried into the port with `state_from_numpy`, and one
whole step (four sub-iterations) of each package is compared: positions
1e-5, velocities 1e-4, body impulses 1e-5, colours and depths 1e-6,
alive, group flags, overflow and stuck counts exactly (the bounds of
tests/test_torch_particles.py). The builder's pairs and triads must be
bit for bit the JAX builder's, with the JAX side on its native path.
Single functions (the windowed neighbour search and its sums, the barrier,
the rigid-group statistics) are compared with their JAX twins jitted
alone, and the six particle methods of World with the JAX World's state
edits.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import geometry as jgeo
from box2d_tpu import native as jnative
from box2d_tpu import particles as jpart
from box2d_tpu import types as jtypes
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import particles as tpart
from box2d_tpu_torch import types as ttypes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy
from port_fixtures import PARTICLE_API, every_gate_tank, particle_api_case

torch.set_num_threads(1)

DT = 1 / 60
WARM = 3
SEED = 9


def _leaves(pt):
    """{field: numpy array} of a Particles tree of either package."""
    return {f.name: np.asarray(getattr(pt, f.name))
            for f in dataclasses.fields(pt) if f.name != "params"}


def check_step(got, want, tag, dv=None, dw=None, want_dv=None,
               want_dw=None):
    """One particle step of the port (got: leaves) against the JAX one."""
    alive = want["alive"]
    np.testing.assert_array_equal(got["alive"], alive, err_msg=tag)
    np.testing.assert_allclose(got["pos"][alive], want["pos"][alive],
                               rtol=0, atol=1e-5, err_msg=tag)
    np.testing.assert_allclose(got["vel"][alive], want["vel"][alive],
                               rtol=0, atol=1e-4, err_msg=tag)
    for key in ("color", "depth", "expiration"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=f"{tag} {key}")
    np.testing.assert_allclose(got["static_pressure"][alive],
                               want["static_pressure"][alive], rtol=1e-5,
                               atol=1e-4, err_msg=tag)
    for key in ("group_flags", "consecutive_contact_steps", "force",
                "flags", "group", "pair_a", "pair_b", "triad_a", "triad_b",
                "triad_c"):
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{tag} {key}")
    if dv is not None:
        np.testing.assert_allclose(dv, want_dv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dw, want_dw, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tank():
    """Both packages' every_gate_tank, the JAX all-gates step (one jit)
    and the JAX particles after WARM steps."""
    jw = every_gate_tank(japi.World, jtypes, jgeo)
    jstate, _ = jw.builder.build()
    tw = every_gate_tank(tapi.World, ttypes, tgeo, device="cpu")
    tw.compile()
    tcfg = tw._step.particle_cfg
    jcfg = jpart.ParticleConfig(**tcfg._asdict())
    jstep = jax.jit(jpart.particle_step, static_argnums=(3,))

    def step(pt):
        out = jstep(pt, jstate, jnp.float32(DT), jcfg)
        return out[0], np.asarray(out[1]), np.asarray(out[2]), int(out[3])

    pt = jstate.particles
    for _ in range(WARM):
        pt = step(pt)[0]
    return dict(jstate=jstate, tw=tw, tcfg=tcfg, step=step, warm=pt)


def _port_state(jstate, pt):
    return state_from_numpy(state_to_numpy(
        dataclasses.replace(jstate, particles=pt)), "cpu")


def test_builder_pairs_and_triads_bit_identical(tank):
    """Spring, elastic and barrier groups: every particles.* leaf equal to
    the JAX builder's, pairs and triads included (its native path)."""
    assert jnative._load() is not None, "the JAX builder took its fallback"
    a = state_to_numpy(tank["jstate"])
    b = state_to_numpy(tank["tw"].state)
    keys = sorted(k for k in a if k.startswith("particles."))
    assert keys == sorted(k for k in b if k.startswith("particles."))
    for key in keys:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    flags = a["particles.pair_flags"]
    assert (flags & tpart.P_SPRING).any() and (flags & tpart.P_BARRIER).any()
    assert (a["particles.triad_flags"] & tpart.P_ELASTIC).sum() > 20


def test_every_gate_step_matches_jax(tank):
    """One whole particle step of every gate from the warm JAX state."""
    tcfg = tank["tcfg"]
    want, want_dv, want_dw, want_ov = tank["step"](tank["warm"])
    start = _port_state(tank["jstate"], tank["warm"])
    stats = tworld.StepStats()
    got, dv, dw, ov = tpart.particle_step(start.particles, start, DT, tcfg,
                                          stats)
    check_step(_leaves(got), _leaves(want), "every gate", dv.numpy(),
               dw.numpy(), want_dv, want_dw)
    assert int(ov) == want_ov
    assert np.abs(want_dv).max() > 1e-4, "the box takes no impulse"
    assert stats.full_sorts == tcfg.iterations and stats.rank_repairs == 0


def test_world_steps_and_matches_its_particle_step():
    """A port World with every flag and both group types, two steps from
    spawn: it runs, stays finite, and each step's particles are its own
    particle_step's from the step's start."""
    tw = every_gate_tank(tapi.World, ttypes, tgeo, device="cpu")
    tw.compile()
    cfg = tw._step.particle_cfg
    assert all(getattr(cfg, f) for f in cfg._fields if f.startswith("has_"))
    for i in range(2):
        before = tw.state
        want = tpart.particle_step(before.particles, before, DT, cfg)[0]
        tw.step(DT)
        got = _leaves(tw.state.particles)
        for key, v in _leaves(want).items():
            np.testing.assert_array_equal(got[key], v, err_msg=f"{i} {key}")
        assert np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()
    # the solid group's depth was derived on the first step, its flag cleared
    gflags = tw.state.particles.group_flags.numpy()
    assert not (gflags & tpart.G_NEEDS_DEPTH).any()
    assert tw.state.particles.depth.numpy().max() > 0
    assert tw.stats.rounds["depth"] > 0


def test_culled_rigid_step_matches_dense(tank):
    """Two rigid groups (one touching the dynamic box) under per-block
    culling: the port's culled step against the JAX dense step and the
    port's dense step. The JAX culled path is not a reference here: its
    impulse sum reads the block rows by closure, and the rigid pass rebinds
    those names (box2d_tpu/particles.py:992-994, :1267)."""
    warm = tank["warm"]
    gflags = np.asarray(warm.group_flags).copy()
    gflags[5] |= tpart.G_RIGID
    start_j = dataclasses.replace(warm, group_flags=jnp.asarray(gflags))
    want, want_dv, want_dw, _ = tank["step"](start_j)
    start = _port_state(tank["jstate"], start_j)
    dense_cfg = tank["tcfg"]
    assert dense_cfg.block_shape_slots >= dense_cfg.max_body_shapes
    # three slots: fewer than the four nearby shapes, but as many as any
    # block of 256 sorted particles overlaps
    culled_cfg = dense_cfg._replace(block_shape_slots=3)
    dense = tpart.particle_step(start.particles, start, DT, dense_cfg)
    culled = tpart.particle_step(start.particles, start, DT, culled_cfg)
    assert int(culled[3]) == int(dense[3]) == 0
    check_step(_leaves(culled[0]), _leaves(want), "culled vs JAX dense",
               culled[1].numpy(), culled[2].numpy(), want_dv, want_dw)
    assert np.abs(want_dv).max() > 1e-4, "the box takes no impulse"
    for i in range(1, 3):
        torch.testing.assert_close(culled[i], dense[i], rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(culled[0].vel, dense[0].vel, rtol=0,
                               atol=1e-4)


def test_depth_checks_every_few_rounds_like_every_round(tank, monkeypatch):
    """The depth relaxation reads the device every CHECK_EVERY rounds; the
    result is bit for bit that of a read every round (the JAX loop's),
    converged or stopped at a cap that is no multiple of CHECK_EVERY."""
    warm = tank["warm"]
    gflags = np.asarray(warm.group_flags) | np.int32(tpart.G_NEEDS_DEPTH)
    gflags = np.where(gflags & tpart.G_SOLID, gflags,
                      gflags & ~np.int32(tpart.G_NEEDS_DEPTH))
    start = _port_state(tank["jstate"], dataclasses.replace(
        warm, group_flags=jnp.asarray(gflags)))
    # one sub-iteration: the depth pass runs in the first and clears the
    # flag it runs on
    for cap in (tank["tcfg"].depth_iterations, 3):
        cfg = tank["tcfg"]._replace(depth_iterations=cap, iterations=1)
        runs = []
        for every in (tpart.CHECK_EVERY, 1):
            monkeypatch.setattr(tpart, "CHECK_EVERY", every)
            stats = tworld.StepStats()
            runs.append((tpart.particle_step(start.particles, start, DT,
                                             cfg, stats)[0], stats))
        (a, sa), (b, sb) = runs
        assert torch.equal(a.depth, b.depth) and torch.equal(a.vel, b.vel)
        assert a.depth.max() > 0
        assert sa.rounds["depth"] <= cap and sb.rounds["depth"] <= cap
        if cap == 3:
            assert sa.rounds["depth"] == sb.rounds["depth"] == 3
        else:
            assert sa.rounds["reads"] < sb.rounds["reads"]


def _windows_input(n=300, dead=17):
    """Cell-sorted positions crowded enough that same-row and row-above
    spans exceed the 12-lane windows, with some dead lanes."""
    rng = np.random.default_rng(SEED)
    pos = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(0.1, 0.4, n)],
                   axis=1).astype(np.float32)
    alive = np.ones(n, bool)
    alive[rng.choice(n, dead, replace=False)] = False
    key = np.asarray(jpart._cell_key(jnp.asarray(pos), jnp.asarray(alive),
                                     jnp.float32(0.1)))
    order = np.argsort(key, kind="stable")
    return pos[order], alive[order], key[order]


def test_windowed_neighbours_and_sums_match_jax():
    """_find_contacts_sorted (windows and overflow exact, weights and
    normals 1e-6) and _pair_accum (1e-6), each jitted alone."""
    pos, alive, skey = _windows_input()
    cfg = tpart.ParticleConfig()
    jw, jover = jax.jit(jpart._find_contacts_sorted, static_argnums=(4,))(
        jnp.asarray(pos), jnp.asarray(alive), jnp.asarray(skey),
        jnp.float32(0.1), jpart.ParticleConfig())
    tw, tover = tpart._find_contacts_sorted(
        torch.from_numpy(pos), torch.from_numpy(alive),
        torch.from_numpy(skey), torch.tensor(np.float32(0.1)), cfg)
    assert int(tover) == int(jover) > 0, "no window overflows"
    for name in ("cand_up", "v_same", "v_up"):
        np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                      np.asarray(getattr(jw, name)), name)
    for name in ("n_same", "n_up", "w_same", "w_up"):
        np.testing.assert_allclose(getattr(tw, name).numpy(),
                                   np.asarray(getattr(jw, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    rng = np.random.default_rng(SEED + 1)
    n, ks, ku = pos.shape[0], cfg.k_same, cfg.k_up
    args = [rng.uniform(-1, 1, shape).astype(np.float32)
            for shape in ((n, ks, 2), (n, ku, 2), (n, ks, 2), (n, ku, 2))]
    want = jax.jit(jpart._pair_accum, static_argnums=(5,))(
        *map(jnp.asarray, args), jw.cand_up, n)
    got = tpart._pair_accum(*map(torch.from_numpy, args), tw.cand_up, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_segment_plans_follow_the_sort():
    """The SegmentPlans a step builds once over original lanes: the rows of
    a plan onto particles, taken at the sorted lanes' originals, are the
    plan of the remapped targets lane for lane; a plan over particle
    contributions, its lanes renamed, holds each target's lanes; a wider
    plan sums to the same bits."""
    rng = np.random.default_rng(SEED)
    n, m, ng = 60, 150, 5
    idx = torch.from_numpy(rng.integers(0, n, m))
    ok = torch.from_numpy(rng.random(m) < 0.8)
    s2o = torch.from_numpy(rng.permutation(n))
    inv = torch.empty_like(s2o)
    inv[s2o] = torch.arange(n)
    width = int(tpart._fan_in(idx, n, ok).max())
    plan0 = tpart._segment_plan(idx, tpart._fan_in(idx, n, ok), width, ok)
    fresh = tpart._segment_plan(inv[idx], tpart._fan_in(inv[idx], n, ok),
                                width, ok)
    assert torch.equal(plan0.lanes[s2o], fresh.lanes)
    v = torch.from_numpy(rng.normal(size=(m, 2)).astype(np.float32))
    v = torch.where(ok[:, None], v, 0.0)
    x = torch.zeros((n, 2))
    wide = tpart.SegmentPlan(torch.cat(
        [plan0.lanes, torch.full((n, 37), m)], dim=1), m)
    assert torch.equal(tpart._segment_add(x, plan0, v),
                       tpart._segment_add(x, wide, v))
    group = torch.from_numpy(rng.integers(0, ng, n))
    g_plan = tpart._segment_plan_of(group, ng)
    renamed = torch.cat([inv, torch.tensor([n])])[g_plan.lanes]
    sorted_plan = tpart._segment_plan_of(group[s2o], ng)
    for t in range(ng):
        a, b = renamed[t], sorted_plan.lanes[t]
        assert torch.equal(a[a < n].sort().values, b[b < n])
    vp = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    torch.testing.assert_close(
        tpart._segment_add(torch.zeros((ng, 3)),
                           tpart.SegmentPlan(renamed, n), vp),
        torch.zeros((ng, 3)).index_add(0, group[s2o], vp),
        rtol=1e-6, atol=1e-6)


def _small_groups(pkg, flags_a, gflags=(0, 0, 0)):
    """A ParticleSystemBuilder of three groups (the first with flags_a),
    built in package `pkg`, with seeded velocities."""
    ps = pkg.ParticleSystemBuilder(0.05)
    ps.create_group_box((0.0, 0.2), 0.4, 0.0375, flags=flags_a,
                        group_flags=gflags[0])
    ps.create_group_box((-0.2, 0.35), 0.2, 0.1, group_flags=gflags[1])
    ps.create_group_box((0.3, 0.35), 0.15, 0.1, group_flags=gflags[2])
    kw = {} if pkg is jpart else {"device": "cpu"}
    return ps.build(**kw)


def test_barrier_matches_jax():
    """_solve_barrier: a static barrier line and two groups falling onto it
    fast enough that some particles cross a segment within dt, some come
    within one radius."""
    jp = _small_groups(jpart, jpart.P_BARRIER)
    tp = _small_groups(tpart, tpart.P_BARRIER)
    n = jp.pos.shape[0]
    rng = np.random.default_rng(SEED)
    vel = np.zeros((n, 2), np.float32)
    vel[:, 1] = -rng.uniform(5.0, 25.0, n)
    group = np.asarray(jp.group)
    vel[group == 0] = 0.0
    pos = np.asarray(jp.pos).copy()
    fall = group > 0
    pos[fall, 1] -= 0.06
    dt = np.float32(1 / 240)
    want = jax.jit(jpart._solve_barrier)(jp, jnp.asarray(pos),
                                         jnp.asarray(vel), dt, 1 / dt,
                                         jnp.float32(0.0))
    got = tpart._solve_barrier(tp.pair_a, tp.pair_b, tp.pair_flags,
                               tp.group, tp.alive, tp.params.radius,
                               torch.from_numpy(pos), torch.from_numpy(vel),
                               float(dt))
    changed = np.abs(np.asarray(want) - vel).max(axis=1) > 1e-3
    assert changed.sum() > 5, "no particle met the barrier"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_rigid_group_stats_and_solve_rigid_match_jax():
    """_rigid_group_stats and _solve_rigid on two rigid groups and a plain
    one, random positions and velocities, one dead lane."""
    g = (jpart.G_RIGID, 0, jpart.G_RIGID)
    jp = _small_groups(jpart, 0, g)
    tp = _small_groups(tpart, 0, g)
    n = jp.pos.shape[0]
    rng = np.random.default_rng(SEED)
    pos = (np.asarray(jp.pos) + rng.normal(0, 0.01, (n, 2))).astype(
        np.float32)
    vel = rng.normal(0, 1.0, (n, 2)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[3] = False
    jp = dataclasses.replace(jp, alive=jnp.asarray(alive))
    tp = dataclasses.replace(tp, alive=torch.from_numpy(alive))
    mass = np.float32(0.0078539)
    want = jax.jit(jpart._rigid_group_stats)(jp, jnp.asarray(pos),
                                             jnp.asarray(vel), mass)
    got = tpart._rigid_group_stats(tp.group, tp.group_flags, tp.alive,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(vel),
                                   torch.tensor(mass))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == want[1] == 3
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    want_v = jax.jit(jpart._solve_rigid)(jp, jnp.asarray(pos),
                                         jnp.asarray(vel), mass,
                                         jnp.float32(1 / 240),
                                         jnp.float32(240))
    got_v = tpart._solve_rigid(tp.group, tp.group_flags, tp.alive,
                               torch.from_numpy(pos), torch.from_numpy(vel),
                               torch.tensor(mass))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def api_worlds():
    jw = every_gate_tank(japi.World, jtypes, jgeo)
    jw.compile()
    tw = every_gate_tank(tapi.World, ttypes, tgeo, device="cpu")
    tw.compile()
    return jw, tw


@pytest.mark.parametrize("name", PARTICLE_API)
def test_particle_api_matches_jax(api_worlds, name):
    """Each particle method of World against the JAX World's: the returned
    values and every particles.* leaf after the call, exactly (floats
    1e-5). Each case works on copies of the two compiled worlds (the
    methods replace a world's state, never change it)."""
    jw, tw = (copy.copy(w) for w in api_worlds)
    r_j = particle_api_case(jw, name, np.asarray, jnp.asarray)
    r_t = particle_api_case(tw, name, lambda x: x.numpy(), torch.from_numpy)
    if isinstance(r_j, list):
        assert len(r_j) == len(r_t)
        for a, b in zip(r_t, r_j):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert r_t == r_j
    a = state_to_numpy(tw.state)
    b = state_to_numpy(jw.state)
    for key in sorted(k for k in b if k.startswith("particles.")):
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        if a[key].dtype.kind == "f":
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    if name == "join_particle_groups":
        assert a["particles.pair_a"].shape[0] > 257, "no seam springs"
        assert a["particles.triad_a"].shape[0] > 98, "no seam triads"
    if name == "split_particle_group":
        assert len(r_t) == 2
    if name == "stuck_particles":
        assert len(r_t[0]) > len(r_t[1]) > 0
