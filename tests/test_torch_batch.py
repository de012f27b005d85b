"""Batched worlds and flat batches: the port against the JAX package.

- `scenes.replicate` builds leaves bit-identical to the JAX package's.
- `world.make_batched_step` (box2d_tpu_torch/batch.py) on three perturbed
  pyramid-8 worlds (one kicked, one asleep) against `jax.jit(jax.vmap)` of
  the JAX `_step`, as the JAX package's bench vmaps it (bench.py:143-149;
  Capacity.batched, bp_repair_cap 0), traced without its continuous pass
  (the port's own CCD gate is asserted shut): centres 1e-4, velocities
  2e-3, awake flags and pair counts exact, every world at every step
  (test_torch_step.py's bounds). The JAX package on the CPU takes the XLA
  path, which sweeps the overflow tail as one window; pyramid-8's live
  tail fits one.
- The batched step against the port's single-world step, world by world,
  with a sleeping world and a world whose CCD gate alone opens: discrete
  outputs exact, floats within 1e-6, reads per step at most the single
  worlds'.
- The batched solver twin against per-world calls of the single twin, on
  the layouts the batched step packs (which equal the single step's).
- The RL loop of tests/test_rl_demo.py on a flat batch of 8 ragdolls.
Jointed, sensor and hooked batches against jax.vmap of the JAX step:
tests/test_torch_batch_features.py; particle worlds:
tests/test_torch_batch_particles.py.
Worlds differ from a numpy seed (port_fixtures.perturbed_leaves): identical
worlds would hide a wrong offset between them. The JAX step compiles once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import scenes as jscenes
from box2d_tpu.narrowphase import classes_for_shape_types as jclasses
from box2d_tpu.world import _step as jax_step
from box2d_tpu_torch import contact_solver as cs
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.batch import batched_kernel_args
from box2d_tpu_torch.state import (Capacity, broadcast_state, stack_states,
                                   state_from_numpy, state_to_numpy,
                                   unstack_state)
from port_fixtures import perturbed_leaves

torch.set_num_threads(1)

DT = 1 / 60
STEPS = 10
ROWS = 8
# pyramid(8): body 0 is the ground (32 m wide), 1-8 the bottom row, 36 the
# top box
KICK = (1, 7, (2.0, 1.0))
FAST = (3, 36, (0.0, -40.0), (20.0, 3.0))   # dropped fast onto the ground


@pytest.fixture(scope="module")
def base():
    """pyramid-8 built by the JAX builder, with the vmapped bench's
    capacity, and the same capacity for the port."""
    jw = jscenes.pyramid(rows=ROWS)
    jstate, jcap = jw.builder.build()
    jcap = dataclasses.replace(jcap, bp_repair_cap=0, batched=True)
    classes = frozenset(jclasses(s["geom"].type for s in jw.builder._shapes))
    tcap = Capacity(**{f.name: getattr(jcap, f.name)
                       for f in dataclasses.fields(jcap)})
    return dict(jstate=jstate, jcap=jcap, tcap=tcap, classes=classes,
                leaves=state_to_numpy(jstate))


def _jax_batch(template, leaves, prefix=""):
    """The JAX state tree of `template` with every leaf taken from
    {dotted path: array}."""
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


@pytest.mark.parametrize("scene, n, kw", [
    ("pyramid", 3, dict(rows=3)),
    ("joint_farm", 4, dict(ragdolls=1)),
    ("dam_break", 9, dict(particles_target=60)),
], ids=["pyramid", "joint_farm", "dam_break"])
def test_replicate_matches_jax(scene, n, kw):
    """The port's flat batch builds every leaf bit for bit as the JAX
    package's, and the same capacity."""
    jw = jscenes.replicate(getattr(jscenes, scene)(**kw), n)
    tw = tscenes.replicate(getattr(tscenes, scene)(**kw, device="cpu"), n)
    jstate, jcap = jw.builder.build()
    tstate, tcap = tw.builder.build(device="cpu")
    a, b = state_to_numpy(jstate), state_to_numpy(tstate)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert dataclasses.asdict(jcap) == dataclasses.asdict(tcap)
    assert len(tw.builder._bodies) == n * len(
        getattr(tscenes, scene)(**kw, device="cpu").builder._bodies)


def test_batched_step_matches_vmap(base):
    """make_batched_step against jax.vmap of the JAX step: a jittered
    world, a kicked one and a sleeping one, 10 steps."""
    leaves = perturbed_leaves(base["leaves"], 3, seed=10, kick=KICK,
                              asleep=(2,))
    jcap, classes = base["jcap"], base["classes"]

    def one(s):
        return jax_step(s, jnp.float32(DT), jcap, classes, 4, frozenset(),
                        (), False, None, 0)

    # the inner jit is traced once and then batched, which traces faster
    # than vmap through the whole step
    vstep = jax.jit(jax.vmap(jax.jit(one)))
    jb = _jax_batch(base["jstate"], leaves)
    bstep = tworld.make_batched_step(base["tcap"], classes, 4, True)
    tb = state_from_numpy(leaves, "cpu")
    for k in range(STEPS):
        jb = vstep(jb)
        tb = bstep(tb, DT)
        a, b = state_to_numpy(jb), state_to_numpy(tb)
        tag = f"step {k + 1}"
        np.testing.assert_allclose(b["bodies.center"], a["bodies.center"],
                                   rtol=0, atol=1e-4, err_msg=tag)
        np.testing.assert_allclose(b["bodies.v"], a["bodies.v"], rtol=0,
                                   atol=2e-3, err_msg=tag)
        for key in ("bodies.awake", "profile.pair_count", "step_count"):
            np.testing.assert_array_equal(b[key], a[key],
                                          err_msg=f"{tag} {key}")
    assert bstep.stats.ccd_gate_openings == 0
    assert int(tb.profile.pair_count[2]) == 0, "the asleep world worked"
    assert int(tb.profile.pair_count[0]) > 0


def _check_world(got, want, tag):
    """Every leaf of two single-world states: discrete leaves exact, float
    leaves within 1e-6."""
    a, b = state_to_numpy(got), state_to_numpy(want)
    assert sorted(a) == sorted(b), tag
    for key in b:
        assert a[key].shape == b[key].shape, f"{tag} {key}"
        if b[key].dtype.kind == "f":
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-6,
                                       err_msg=f"{tag} {key}")
        else:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{tag} {key}")


def test_batched_step_matches_single_world(base):
    """World by world against the port's single-world step: a jittered
    world, a kicked one, a sleeping one (the idle branch's output, next
    to awake worlds) and one whose top box, moved clear of the pile, is
    driven at the ground fast enough to open the CCD gate (its TOI sweep
    runs alone and hits)."""
    n_w = 4
    leaves = perturbed_leaves(base["leaves"], n_w, seed=20, kick=KICK,
                              asleep=(2,), fast=FAST)
    cap, classes = base["tcap"], base["classes"]
    bstep = tworld.make_batched_step(cap, classes, 4, True)
    steps = [tworld.make_step(cap, classes, 4, True) for _ in range(n_w)]
    assert all(s.tail_w == bstep.tail_w for s in steps)
    tb = state_from_numpy(leaves, "cpu")
    singles = [unstack_state(tb, w) for w in range(n_w)]
    for k in range(STEPS):
        reads0 = bstep.stats.syncs
        single_reads = []
        tb = bstep(tb, DT)
        for w in range(n_w):
            r0 = steps[w].stats.syncs
            singles[w] = steps[w](singles[w], DT)
            single_reads.append(steps[w].stats.syncs - r0)
            _check_world(unstack_state(tb, w), singles[w],
                         f"step {k + 1} world {w}")
        assert bstep.stats.syncs - reads0 <= max(single_reads), k
    assert steps[2].stats.idle_steps == STEPS - 1   # dirty at spawn
    assert steps[3].stats.ccd_gate_openings > 0
    assert steps[3].stats.toi_hits > 0
    assert all(steps[w].stats.ccd_gate_openings == 0 for w in range(3))
    assert bstep.stats.ccd_world_calls == steps[3].stats.ccd_gate_openings
    assert bstep.stats.ccd_gate_openings == bstep.stats.ccd_world_calls


def test_identical_worlds_stay_identical(base):
    """A batch of copies of one world stays a batch of equal worlds, bit
    for bit on the CPU; stacking its worlds again gives the batch."""
    state = state_from_numpy(base["leaves"], "cpu")
    bstep = tworld.make_batched_step(base["tcap"], base["classes"], 4, True)
    tb = broadcast_state(state, 3)
    for _ in range(5):
        tb = bstep(tb, DT)
    for key, v in state_to_numpy(tb).items():
        assert (v == v[:1]).all(), key
    again = stack_states([unstack_state(tb, w) for w in range(3)])
    for key, v in state_to_numpy(again).items():
        assert np.array_equal(v, state_to_numpy(tb)[key]), key


def test_batched_twin_matches_single_twins(base):
    """The batched step's solver inputs equal each world's single-world
    inputs, and the batched twin on them equals the single twin world by
    world, bit for bit."""
    leaves = perturbed_leaves(base["leaves"], 3, seed=30, kick=KICK)
    cap, classes = base["tcap"], base["classes"]
    bstep = tworld.make_batched_step(cap, classes, 4, True)
    tb = state_from_numpy(leaves, "cpu")
    for _ in range(3):
        tb = bstep(tb, DT)
    args = batched_kernel_args(tb, DT, bstep)
    ob, oa = cs.contact_solve_batched(*args)
    single = tworld.make_step(cap, classes, 4, True)
    for w in range(3):
        one = tworld._step_work(unstack_state(tb, w), DT, cap, classes, 4,
                                True, tworld.StepStats(), until="layout")
        for a, b in zip(args[:6], one[:6]):
            assert torch.equal(a[w], b)
        assert tuple(args[6:11]) == tuple(one[6:10]) + (single.tail_w,)
        rb, ra = cs.contact_solve_reference(*one[:10], single.tail_w)
        assert torch.equal(ob[w], rb) and torch.equal(oa[w], ra), w
    assert int((args[1][:, 0] >= 0).sum()) > 0


def test_rl_loop_flat_batch():
    """tests/test_rl_demo.py on the CPU at 8 worlds and 32 steps: the
    ragdolls tiled into one world (scenes.replicate), a per-world motor
    speed written into the joint arrays every step, rewards from the event
    surface; the actions reach the dynamics (the torso angular velocities
    split by the parity of their world)."""
    n_w, steps = 8, 32
    base = tscenes.joint_farm(ragdolls=1, device="cpu")
    w = tscenes.replicate(base, n_w)
    w.compile()
    n_joints = len(base.builder._joints)
    n_bodies = len(base.builder._bodies)
    n_shapes = len(base.builder._shapes)
    motor_lanes = torch.arange(n_w) * n_joints
    world_of_body = torch.arange(w.state.bodies.center.shape[0]) // n_bodies
    t_idx = torch.arange(steps, dtype=torch.float32)[:, None]
    w_idx = torch.arange(n_w, dtype=torch.float32)[None]
    actions = 2.0 * torch.sin(0.05 * t_idx + w_idx) + torch.where(
        w_idx % 2 == 0, 1.5, -1.5)
    rewards = torch.zeros((steps, n_w))
    for k in range(steps):
        s = w.state
        w.state = dataclasses.replace(s, joints=dataclasses.replace(
            s.joints, motor_speed=s.joints.motor_speed.index_put(
                (motor_lanes,), actions[k])))
        w.step(DT)
        ev = w.state.events
        moved = torch.zeros(n_w).index_add(0, world_of_body,
                                           ev.body_moved.float())
        cb_ok = torch.arange(ev.contact_begin.shape[0]) < \
            ev.contact_begin_count
        cb_world = torch.where(cb_ok, ev.contact_begin[:, 0] // n_shapes,
                               n_w).long()
        contacts = torch.zeros(n_w + 1).index_add(0, cb_world,
                                                  torch.ones(len(cb_world)))
        rewards[k] = moved + 0.1 * contacts[:n_w]
    r = rewards.numpy()
    assert np.isfinite(r).all() and r.sum() > 0.0
    assert torch.equal(w.state.joints.motor_speed[motor_lanes], actions[-1])
    w_t = w.state.bodies.w.numpy()[1::n_bodies]
    even, odd = w_t[0::2], w_t[1::2]
    assert even.mean() > odd.mean() + 0.1, (even.mean(), odd.mean())
    assert np.isfinite(w.state.bodies.center.numpy()).all()


def _layout_plain(color, n_colors, n_ovf, max_colors, chunk):
    """The color-bucket layout of one world, lane by lane in numpy."""
    p = len(color)
    l0 = max_colors * chunk
    ovf_cap = ((min(p, 2 * chunk) + chunk - 1) // chunk) * chunk
    out = np.full(p, l0 + ovf_cap)
    rank = np.zeros(max_colors, np.int64)
    tail = 0
    for i, c in enumerate(color):
        if c < 0:
            continue
        rank[c] += 1
        if (c == n_colors - 1 and n_ovf > 0) or rank[c] > chunk:
            if tail < ovf_cap:
                out[i] = l0 + tail
            tail += 1
        else:
            out[i] = c * chunk + rank[c] - 1
    return out


def _relax_plain(ovf, ba, bb):
    """The overflow color's mass splitting of one world in numpy."""
    deg = {}
    for i in np.nonzero(ovf)[0]:
        for body in (ba[i], bb[i]):
            deg[body] = deg.get(body, 0) + 1
    return np.array([1.0 / max(deg.get(ba[i], 0), deg.get(bb[i], 0), 1)
                     if ovf[i] else 1.0 for i in range(len(ovf))],
                    np.float32)


@pytest.mark.parametrize("overflow", [False, True])
def test_layout_and_relax_by_world(overflow):
    """world.color_layout and world.overflow_relax, which the single-world
    step calls with one world and the batched step with W, give each
    world of a (W, P) batch its own layout and mass splitting: against a
    lane-by-lane numpy version, with buckets past their chunk and, in
    some worlds, an overflow color."""
    rng = np.random.default_rng(5)
    n_w, p, max_colors, chunk, nb = 3, 40, 4, 8, 12
    color = rng.integers(-1, 4, (n_w, p))
    n_colors = color.max(axis=1) + 1
    n_ovf = (np.array([3, 0, 5]) if overflow else np.zeros(n_w, np.int64))
    ba = rng.integers(0, nb, (n_w, p))
    bb = rng.integers(0, nb, (n_w, p))
    ovf = (color == (n_colors - 1)[:, None]) & (n_ovf > 0)[:, None]
    got, l0, layout_len = tworld.color_layout(
        torch.tensor(color, dtype=torch.int32), torch.tensor(n_colors),
        torch.tensor(n_ovf, dtype=torch.int32), max_colors, chunk)
    off = (np.arange(n_w) * nb)[:, None]
    relax = tworld.overflow_relax(torch.tensor(ovf), torch.tensor(ba + off),
                                  torch.tensor(bb + off), n_w * nb)
    assert l0 == max_colors * chunk
    for w in range(n_w):
        want = _layout_plain(color[w], n_colors[w], n_ovf[w], max_colors,
                             chunk)
        np.testing.assert_array_equal(got[w].numpy(), want)
        np.testing.assert_array_equal(
            relax[w].numpy(), _relax_plain(ovf[w], ba[w], bb[w]))
    assert (got < layout_len).any() and (got >= l0).any()
