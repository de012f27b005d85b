"""Batched particle worlds: the port against the JAX package and itself.

- `world.make_batched_step(..., particle_cfg=)` (box2d_tpu_torch/batch.py)
  on three perturbed worlds of `port_fixtures.box_tank` (289 particles,
  a dynamic box; each world's particles jittered and its pressure,
  damping and density scaled apart) against `jax.jit(jax.vmap)` of the
  JAX `_step` with `use_window_kernel=True, rank_repair=False` (the
  Pallas window pass in interpret mode, as the JAX package runs it on the
  CPU, box2d_tpu/particles.py:849-877), four steps:
  tests/test_torch_particles.py's bounds (positions 1e-5, velocities
  1e-4, expiration 1e-6, the other particle leaves exact), bodies within
  1e-5 (the body impulses sum in another order), awake flags, pair counts,
  step counts and overflow exact. World 1's box sleeps (it takes the
  particle gate's skip branch from the second step); world 2's box sits
  on the column, one nearby shape more than max_body_shapes (its own
  overflow). The JAX step compiles once, in the module fixture.
- The batched step against the port's single-world step, world by world,
  bit for bit: the window-kernel path (dense coupling, per-block culled
  coupling, the analytic anti-tunnel ray) and the gated path with groups
  and a barrier (port_fixtures.every_gate_tank).
- K3 batched's twin against W calls of the single twin, bit for bit,
  with a scalar row a world; no particle sees another world's
  neighbour; a step's device reads do not grow with the worlds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import geometry as jgeo
from box2d_tpu import particles as jpart
from box2d_tpu import types as jtypes
from box2d_tpu.world import _step as jax_step
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import particles_kernels as tpk
from box2d_tpu_torch import types as ttypes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.state import (state_from_numpy, state_to_numpy,
                                   unstack_state)
from port_fixtures import (box_tank, every_gate_tank, obstacle_tank,
                           perturbed_leaves)

torch.set_num_threads(1)

DT = 1 / 60
STEPS = 4
N_W = 3
PARTICLES = 300
BOX = 1                 # box_tank's dynamic box
ASLEEP = 1              # the world whose box sleeps
ON_COLUMN = 2           # the world whose box sits on the column
# the box on the column's top row (the column is 1.3 m square, its left
# edge 0.3 m from the wall's inner face)
ON_COLUMN_AT = (-3.05, 1.45)


def _leaves(n_worlds, seed):
    """Perturbed box_tank worlds (see the module docstring) as leaves of
    both packages' builders."""
    jw = box_tank(japi.World, jtypes, jgeo, particles=PARTICLES)
    jstate, jcap = jw.builder.build()
    leaves = perturbed_leaves(
        state_to_numpy(jstate), n_worlds, seed=seed, asleep=(ASLEEP,),
        fast=(ON_COLUMN, BOX, (0.0, 0.0), ON_COLUMN_AT),
        particle_jitter=0.005, param_spread=0.2)
    return jstate, jcap, leaves


def _port_world(make, **kw):
    w = make(tapi.World, ttypes, tgeo, device="cpu", **kw)
    w.compile()
    return w


def _jax_batch(template, leaves, prefix=""):
    """The JAX state tree of `template` with every leaf from leaves."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        key = prefix + f.name
        if v is None:
            kw[f.name] = None
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _jax_batch(v, leaves, key + ".")
        else:
            kw[f.name] = jnp.asarray(leaves[key])
    return dataclasses.replace(template, **kw)


@pytest.fixture(scope="module")
def traj():
    """STEPS steps of the perturbed batch by the vmapped JAX step and by
    the port's batched step, every step's leaves of both."""
    jstate, jcap, leaves = _leaves(N_W, seed=3)
    tw = _port_world(box_tank, particles=PARTICLES)
    assert dataclasses.asdict(jcap) == dataclasses.asdict(tw.capacity)
    # two shapes a world at most: world 2's box is a third near the water
    cfg = tw._step.particle_cfg._replace(rank_repair=False,
                                         max_body_shapes=2)
    jcfg = jpart.ParticleConfig(**cfg._asdict())
    classes = tw._classes

    def one(s):
        return jax_step(s, jnp.float32(DT), jcap, classes, 4, frozenset(),
                        (), False, jcfg, 0)

    # the inner jit is traced once and then batched
    vstep = jax.jit(jax.vmap(jax.jit(one)))
    bstep = tworld.make_batched_step(tw.capacity, classes, 4, False,
                                     particle_cfg=cfg)
    jb, tb = _jax_batch(jstate, leaves), state_from_numpy(leaves, "cpu")
    out = []
    for _ in range(STEPS):
        jb, tb = vstep(jb), bstep(tb, DT)
        out.append((state_to_numpy(jb), state_to_numpy(tb)))
    return dict(out=out, stats=bstep.stats, cfg=cfg)


def test_batched_particle_step_matches_vmap(traj):
    for k, (want, got) in enumerate(traj["out"]):
        tag = f"step {k + 1}"
        alive = want["particles.alive"]
        np.testing.assert_array_equal(got["particles.alive"], alive,
                                      err_msg=tag)
        for key, atol in (("particles.pos", 1e-5), ("particles.vel", 1e-4)):
            np.testing.assert_allclose(got[key][alive], want[key][alive],
                                       rtol=0, atol=atol,
                                       err_msg=f"{tag} {key}")
        np.testing.assert_allclose(got["particles.expiration"],
                                   want["particles.expiration"], rtol=0,
                                   atol=1e-6, err_msg=tag)
        for key in ("bodies.center", "bodies.v", "bodies.w"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5, err_msg=f"{tag} {key}")
        for key in ("particles.consecutive_contact_steps",
                    "particles.force", "particles.flags", "particles.group",
                    "particles.color", "particles.static_pressure",
                    "bodies.awake", "profile.pair_count",
                    "profile.overflow_particles", "step_count"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{tag} {key}")
    assert traj["stats"].full_sorts == STEPS * traj["cfg"].iterations
    assert traj["stats"].rank_repairs == 0


def test_overflow_and_skip_branch_by_world(traj):
    """Each world keeps its own particle overflow, in both branches; the
    world whose box sleeps takes the skip branch (no pairs, no events)
    from the second step, beside live worlds, as the JAX select does: the
    box on the ground keeps its contact pairs, the box on the column
    moves."""
    y = None
    for k, (want, got) in enumerate(traj["out"]):
        ov = got["profile.overflow_particles"]
        assert ov[ON_COLUMN] == 1 and ov[0] == 0 and ov[ASLEEP] == 0, ov
        assert not got["bodies.awake"][ASLEEP, BOX]
        assert got["bodies.awake"][0, BOX] and got["bodies.awake"][
            ON_COLUMN, BOX]
        if k > 0:
            assert got["profile.pair_count"][ASLEEP] == 0, k
            assert got["events.contact_begin_count"][ASLEEP] == 0, k
            assert got["bodies.center"][ON_COLUMN, BOX, 1] != y, k
        y = got["bodies.center"][ON_COLUMN, BOX, 1]
        assert got["profile.pair_count"][0] > 0, k
        np.testing.assert_array_equal(got["step_count"], k + 1)
    assert traj["stats"].idle_steps == 0


def _against_single_worlds(w, leaves, cfg, steps):
    """The batched step of `w`'s configuration on leaves, and the
    single-world step on each world, compared leaf by leaf, bit for bit,
    after every step. Returns the batched step."""
    n_w = leaves["step_count"].shape[0]
    bstep = tworld.make_batched_step(w.capacity, w._classes, 4,
                                     w._step.continuous,
                                     joint_types=w._jtypes,
                                     particle_cfg=cfg)
    tb = state_from_numpy(leaves, "cpu")
    singles = [unstack_state(tb, k) for k in range(n_w)]
    one = [tworld.make_step(w.capacity, w._classes, 4, w._step.continuous,
                            w._jtypes, cfg) for _ in range(n_w)]
    for s in range(steps):
        tb = bstep(tb, DT)
        for k in range(n_w):
            singles[k] = one[k](singles[k], DT)
            a = state_to_numpy(unstack_state(tb, k))
            b = state_to_numpy(singles[k])
            assert sorted(a) == sorted(b)
            for key in b:
                assert a[key].tobytes() == b[key].tobytes(), (
                    f"step {s + 1} world {k} {key}")
    return bstep


@pytest.mark.parametrize("case", ["dense", "culled", "analytic ray"])
def test_batched_particle_step_matches_single_world(case):
    """The window-kernel path, world by world, bit for bit: dense
    coupling; per-block culled coupling (one slot a block, so blocks
    overflow, each world counting its own); the analytic anti-tunnel ray
    (a circle and a capsule in the tank)."""
    if case == "analytic ray":
        w = _port_world(lambda *a, **kw: obstacle_tank(PARTICLES, *a, **kw))
        leaves = perturbed_leaves(state_to_numpy(w.state), N_W, seed=5,
                                  particle_jitter=0.005, param_spread=0.2)
    else:
        w = _port_world(box_tank, particles=PARTICLES)
        leaves = _leaves(N_W, seed=5)[2]
    cfg = w._step.particle_cfg._replace(rank_repair=False)
    if case == "culled":
        cfg = cfg._replace(block_shape_slots=1)
    bstep = _against_single_worlds(w, leaves, cfg, 3)
    assert bstep.stats.full_sorts == 3 * cfg.iterations


def test_gated_batch_matches_single_world():
    """The gated path (every flag, spring, elastic and barrier groups, a
    solid and a rigid group, a box on the rigid group), world by world,
    bit for bit: the windowed neighbour search, the SegmentPlans, the
    barrier against its own world's particles only."""
    w = _port_world(every_gate_tank, particles=300)
    cfg = w._step.particle_cfg
    assert cfg.has_barrier and cfg.has_rigid and cfg.has_solid
    leaves = perturbed_leaves(state_to_numpy(w.state), 2, seed=7,
                              particle_jitter=0.005, param_spread=0.2)
    bstep = _against_single_worlds(w, leaves, cfg, 2)
    assert bstep.stats.rounds["depth"] > 0


def _two_tables(seed, n=600):
    """Two worlds' K3 inputs of n particles each (about three a cell on a
    2 m x 1 m field of 0.1 m cells, cell-sorted), each with its own scalar
    row."""
    from box2d_tpu_torch.particles import _cell_key

    d = 0.1
    out = []
    for k in range(2):
        rng = np.random.default_rng(seed + k)
        pos = torch.tensor(rng.uniform((0.0, 0.0), (2.0, 1.0), (n, 2)),
                           dtype=torch.float32)
        alive = torch.tensor(rng.uniform(size=n) > 0.05)
        key = _cell_key(pos, alive, 1.0 / d)
        order = torch.argsort(key, stable=True)
        p01 = torch.tensor(rng.normal(size=(2, n)), dtype=torch.float32)
        sc = torch.tensor([1.0 / d, d * d, 1.0 + k, 0.7 - 0.2 * k,
                           0.5 + 0.3 * k, 0.0, 0.0, 0.0])
        out.append((pos[order].contiguous(), key[order].contiguous(),
                    alive[order].contiguous(), p01[0, order].contiguous(),
                    p01[1, order].contiguous(), sc))
    return out


@pytest.mark.parametrize("phase", [0, 1, 2],
                         ids=["weight", "pressure", "damping"])
def test_window_pass_batched_twin_matches_single(phase):
    """window_pass_batched on the CPU (its twin) equals window_pass on each
    world's table and scalar row, bit for bit, and counts the blocks of
    both worlds."""
    a, b = _two_tables(11)
    stacked = [torch.stack([x, y]) for x, y in zip(a, b)]
    paths = torch.zeros(2, dtype=torch.int32)
    out = tpk.window_pass_batched(*stacked, phase, paths=paths)
    for k, table in enumerate((a, b)):
        assert torch.equal(out[k], tpk.window_pass(*table, phase)), k
    assert out[0].abs().max() > 0
    want = [x + y for x, y in zip(tpk.k3_block_paths(a[1], a[2]),
                                  tpk.k3_block_paths(b[1], b[2]))]
    assert paths.tolist() == want


def test_no_neighbour_across_worlds():
    """Two worlds with the same cell keys and other positions: each world
    sums its own neighbours only, where one table holding both worlds'
    particles would mix them."""
    from box2d_tpu_torch.particles import _cell_key

    a, _ = _two_tables(13)
    pos, skey, alive, p0, p1, sc = a
    # every particle moved elsewhere inside its own cell
    d = 0.1
    u = torch.tensor(np.random.default_rng(13).uniform(
        0.1 * d, 0.9 * d, tuple(pos.shape)), dtype=torch.float32)
    moved = torch.floor(pos * sc[0]) * d + u
    assert torch.equal(_cell_key(moved, alive, sc[0]), skey)
    b = (moved, skey, alive, p0.flip(0), p1, sc)
    stacked = [torch.stack([x, y]) for x, y in zip(a, b)]
    for phase in range(3):
        out = tpk.window_pass_batched(*stacked, phase)
        assert torch.equal(out[0], tpk.window_pass(*a, phase))
        assert torch.equal(out[1], tpk.window_pass(*b, phase))
    order = torch.argsort(torch.cat([skey, skey]), stable=True)
    both = [torch.cat([x, y])[order] for x, y in zip(a[:5], b[:5])]
    mixed = tpk.window_pass(*both, sc, 0)
    first = torch.argsort(order)[:skey.shape[0]]
    assert not torch.equal(mixed[first], tpk.window_pass(*a, 0))


def test_reads_do_not_grow_with_worlds():
    """A step of 4 worlds reads the device as often as a step of 2."""
    w = _port_world(box_tank, particles=PARTICLES)
    cfg = w._step.particle_cfg._replace(rank_repair=False)
    reads = []
    for n_w in (2, 4):
        bstep = tworld.make_batched_step(w.capacity, w._classes, 4, False,
                                         particle_cfg=cfg)
        tb = state_from_numpy(perturbed_leaves(
            state_to_numpy(w.state), n_w, seed=9, particle_jitter=0.005),
            "cpu")
        per_step = []
        for _ in range(3):
            r0 = bstep.stats.syncs
            tb = bstep(tb, DT)
            per_step.append(bstep.stats.syncs - r0)
        reads.append(per_step)
    assert reads[0] == reads[1], reads
