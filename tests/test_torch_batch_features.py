"""Batched jointed, sensor and hooked worlds: the port against the JAX
package and against its own single-world step.

- `world.make_batched_step` on three perturbed copies of
  port_fixtures.api_scene (every joint type, a sensor box, a filtered box,
  an open chain; one copy kicked, one asleep) with the default repair
  cap, Capacity.batched, both hooks of tests/test_torch_api.py and no
  continuous pass, against `jax.jit(jax.vmap)` of the JAX `_step` traced
  with the same hooks (compiled once), at max_verts 8 (ROADMAP.md §3: the
  JAX step traces chains beside polygons only at that width). Both
  builders turn on contact, hit and sensor events on every shape and
  give the joints thresholds their reactions cross, so every event kind
  fires. Bounds of tests/test_torch_joint_solver.py: centres 1e-4,
  velocities 2e-3, joint impulses 5e-3; discrete outputs (awake flags,
  joint colors, pair buffers, tiers, events) exact. The JAX step on the
  CPU takes the XLA path, which sweeps the overflow tail as one window:
  every world's live tail is asserted to fit one of the port's windows.
- The batched step against the port's single-world Step, world by world,
  every leaf bit for bit: the api_scene batch with both hooks, and 8
  joint_farm(1) ragdolls with per-world motor speeds written each step
  (the repair tier on, and bp_repair_cap 0).
- The batched solver twin with joint regions against per-world single
  twins, bit for bit, on the layouts the batched step packs, among them
  hub worlds whose coloring overflows beside one that does not.
- A hook that torch.func.vmap cannot map raises, naming it.
Worlds differ from a numpy seed (port_fixtures.perturbed_leaves): identical
worlds would hide a wrong offset between them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import geometry as jg
from box2d_tpu import state as jstate_mod
from box2d_tpu import types as jt
from box2d_tpu.world import _step as jax_step
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import contact_solver as cs
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import types as tt
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.batch import batched_kernel_args
from box2d_tpu_torch.joints import JointRows, joint_types_present
from box2d_tpu_torch.narrowphase import classes_for_shape_types
from box2d_tpu_torch.sensors import sensor_shape_ids
from box2d_tpu_torch.state import (state_from_numpy, state_to_numpy,
                                   unstack_state)
from port_fixtures import (api_scene, hub_scene, perturbed_leaves,
                           with_all_events)
from test_torch_batch import _jax_batch

torch.set_num_threads(1)

DT = 1 / 60
STEPS = 6
N_W = 3
KICK = (1, 7, (2.0, 1.0))     # world 1's body 7 kicked
THRESHOLD = 0.5               # joint force and torque event thresholds
FARM_WORLDS = 8
FARM_STEPS = 5


def _keep_pair(state, a, b):
    return (a + b) % 3 != 0


def _one_way(state, a, b, manifold):
    """tests/test_torch_api.py's pre-solve hook: drop the upward-facing
    manifolds of odd shape_a lanes."""
    return (manifold.normal[:, 1] < 0.9) | (a % 2 == 0)


def _statics(builder):
    return (classes_for_shape_types(s["geom"].type for s in builder._shapes),
            joint_types_present(j["_type"] for j in builder._joints),
            sensor_shape_ids(builder._shapes))


def _api_batch():
    """api_scene built by the port at max_verts 8 with the default repair
    cap, Capacity.batched and every event kind on: its capacity, three
    perturbed copies' leaves and its statics."""
    tw = with_all_events(api_scene(tapi.World, tt, tg, device="cpu"),
                         THRESHOLD)
    cap = dataclasses.replace(tw.builder.default_capacity(), max_verts=8,
                              batched=True)
    state, cap = tw.builder.build(cap, device="cpu")
    assert cap.bp_repair_cap > 0
    leaves = perturbed_leaves(state_to_numpy(state), N_W, seed=3, kick=KICK,
                              asleep=(2,))
    return cap, leaves, _statics(tw.builder)


@pytest.fixture(scope="module")
def api_port():
    """The api_scene batch stepped STEPS times by the port's batched step
    with both hooks: each step's leaves, reads and largest live tail."""
    cap, leaves, statics = _api_batch()
    classes, jtypes, sensors = statics
    bstep = tworld.make_batched_step(cap, classes, 4, False,
                                     joint_types=jtypes, sensor_ids=sensors,
                                     custom_filter=_keep_pair,
                                     pre_solve=_one_way)
    tb = state_from_numpy(leaves, "cpu")
    ttraj, tails, reads = [], [], []
    for _ in range(STEPS):
        args = batched_kernel_args(tb, DT, bstep)
        l0 = args[8]
        tails.append(max(int((args[1][w, 0, l0:] >= 0).sum())
                         for w in range(N_W)))
        r0 = bstep.stats.syncs
        tb = bstep(tb, DT)
        reads.append(bstep.stats.syncs - r0)
        ttraj.append(state_to_numpy(tb))
    return dict(ttraj=ttraj, tails=tails, reads=reads, bstep=bstep,
                leaves=leaves, statics=statics, cap=cap, last=tb)


@pytest.fixture(scope="module")
def api_run(api_port):
    """api_port with the same batch stepped by jax.vmap of the JAX step
    (one compile), each step's leaves."""
    cap, leaves = api_port["cap"], api_port["leaves"]
    classes, jtypes, sensors = api_port["statics"]
    jw = with_all_events(api_scene(japi.World, jt, jg), THRESHOLD)
    jstate, jcap = jw.builder.build(
        jstate_mod.Capacity(**dataclasses.asdict(cap)))
    assert dataclasses.asdict(jcap) == dataclasses.asdict(cap)
    assert _statics(jw.builder) == api_port["statics"]

    def one(s):
        return jax_step(s, jnp.float32(DT), jcap, classes, 4, jtypes,
                        sensors, False, None, False, _keep_pair, _one_way)

    # the inner jit (make_step's) is traced once and then batched, which
    # traces faster than vmap through the whole step
    vstep = jax.jit(jax.vmap(jax.jit(one)))
    jb = _jax_batch(jstate, leaves)
    jtraj = []
    for _ in range(STEPS):
        jb = vstep(jb)
        jtraj.append(state_to_numpy(jb))
    return dict(api_port, jtraj=jtraj)


def _bodies(a, b, tag):
    np.testing.assert_allclose(b["bodies.center"], a["bodies.center"],
                               rtol=0, atol=1e-4, err_msg=tag)
    np.testing.assert_allclose(b["bodies.v"], a["bodies.v"], rtol=0,
                               atol=2e-3, err_msg=tag)
    np.testing.assert_allclose(b["bodies.w"], a["bodies.w"], rtol=0,
                               atol=2e-3, err_msg=tag)
    for key in ("bodies.awake", "bodies.island_label", "step_count",
                "profile.color_count", "profile.overflow_colors"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=f"{tag} {key}")


def _joints(a, b, tag):
    for key in ("impulse", "motor_impulse", "spring_impulse",
                "spring_impulse2", "lower_impulse", "upper_impulse",
                "angular_impulse"):
        np.testing.assert_allclose(b[f"joints.{key}"], a[f"joints.{key}"],
                                   rtol=0, atol=5e-3, err_msg=f"{tag} {key}")
    np.testing.assert_array_equal(b["joints.color"], a["joints.color"],
                                  err_msg=tag)


def _events(prefix, fields):
    def check(a, b, tag):
        for f in fields:
            key = f"events.{prefix}{f}"
            np.testing.assert_array_equal(b[key], a[key],
                                          err_msg=f"{tag} {key}")
    return check


def _contact_events(a, b, tag):
    _events("contact_", ("begin", "begin_count", "end", "end_count"))(
        a, b, tag)
    for key in ("events.hit_count", "events.hit_shapes",
                "events.body_moved", "events.body_fell_asleep",
                "profile.events_dropped"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=f"{tag} {key}")
    for key in ("events.hit_point", "events.hit_normal", "events.hit_speed"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=2e-3,
                                   err_msg=f"{tag} {key}")


def _pair_buffer(a, b, tag):
    for key in ("broadphase.shape_a", "broadphase.shape_b",
                "broadphase.valid", "broadphase.count",
                "broadphase.overflow", "broadphase.dirty",
                "profile.pair_rebuild", "profile.pair_count",
                "contacts.key_a", "contacts.key_b", "contacts.touching"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=f"{tag} {key}")


def _custom_filter(a, b, tag):
    # the pairs a rebuild or a repair builds, judged at local ids: both
    # packages keep the same lanes, and none that the filter drops
    for key in ("broadphase.valid", "broadphase.count", "profile.pair_count",
                "profile.pair_rebuild"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=f"{tag} {key}")
    sa, sb = b["broadphase.shape_a"], b["broadphase.shape_b"]
    assert not (b["broadphase.valid"] & ((sa + sb) % 3 == 0)).any(), tag


def _pre_solve(a, b, tag):
    # the manifolds the hook drops are zeroed: the same contact points,
    # touching lanes and stored impulses
    for key in ("profile.contact_point_count", "contacts.touching"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=f"{tag} {key}")
    for key in ("contacts.normal_impulse", "contacts.tangent_impulse"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=2e-3,
                                   err_msg=f"{tag} {key}")
    ka, kb = b["contacts.key_a"], b["contacts.key_b"]
    assert not (b["contacts.touching"] & ((ka + kb) % 3 == 0)).any(), tag


CASES = {
    "bodies": _bodies,
    "joints": _joints,
    "sensor_events": _events("sensor_", ("begin", "begin_count", "end",
                                         "end_count")),
    "joint_events": _events("joint_force", ("", "_count")),
    "contact_events": _contact_events,
    "pair_buffer": _pair_buffer,
    "custom_filter": _custom_filter,
    "pre_solve": _pre_solve,
}


def _pre_solve_drops(run):
    """Contact points the pre_solve hook removed at the first step: the
    batched step without it, from the same state, finds more."""
    classes, jtypes, sensors = run["statics"]
    plain = tworld.make_batched_step(run["cap"], classes, 4, False,
                                     joint_types=jtypes, sensor_ids=sensors,
                                     custom_filter=_keep_pair)
    out = plain(state_from_numpy(run["leaves"], "cpu"), DT)
    return (int(out.profile.contact_point_count.sum())
            - int(run["ttraj"][0]["profile.contact_point_count"].sum()))


@pytest.mark.parametrize("case", list(CASES))
def test_batch_features_match_vmap(api_run, case):
    """make_batched_step against jax.vmap of the JAX step on the api_scene
    batch, every world at every step, one group of outputs a case."""
    for k, (a, b) in enumerate(zip(api_run["jtraj"], api_run["ttraj"])):
        CASES[case](a, b, f"step {k + 1}")
    # each world's live contact tail fits one window, so the XLA path's
    # single window sweeps it alike
    assert max(api_run["tails"]) <= api_run["bstep"].tail_w
    last = api_run["ttraj"]
    kinds = np.stack([t["profile.pair_rebuild"] for t in last])
    if case == "bodies":
        assert api_run["bstep"].stats.ccd_gate_openings == 0
        assert int(last[-1]["profile.pair_count"][2]) == 0, "asleep world"
    elif case == "joints":
        assert np.abs(last[-1]["joints.impulse"]).max() > 1e-3
    elif case == "sensor_events":
        assert sum(int(t["events.sensor_begin_count"].sum())
                   for t in last) > 0
    elif case == "joint_events":
        assert sum(int(t["events.joint_force_count"].sum())
                   for t in last) > 0
    elif case == "contact_events":
        assert sum(int(t["events.contact_begin_count"].sum())
                   + int(t["events.hit_count"].sum()) for t in last) > 0
    elif case == "pair_buffer":
        # a step where one world repairs and another keeps its pairs
        assert ((kinds == 1).any(axis=1) & (kinds == 0).any(axis=1)).any()
        assert (kinds[0] == 2).all()
    elif case == "custom_filter":
        # the filter dropped pairs of the first step's full rebuild: its
        # candidates (pair_count) outnumber the valid lanes
        first = last[0]
        assert (first["broadphase.valid"].sum(axis=1)
                < first["profile.pair_count"])[:2].all()
    elif case == "pre_solve":
        # the hook dropped touching manifolds: upward normals of odd
        # shape_a lanes, which the step without it solves
        one = _pre_solve_drops(api_run)
        assert one > 0, one


def _farm_batch(repair: bool):
    """joint_farm(1) with Capacity.batched (and the repair tier, or
    bp_repair_cap 0): its capacity, FARM_WORLDS perturbed copies' leaves
    (the last world's torso kicked) and its statics."""
    w = tscenes.joint_farm(ragdolls=1, device="cpu")
    state, cap = w.builder.build(device="cpu")
    cap = dataclasses.replace(cap, batched=True,
                              **({} if repair else dict(bp_repair_cap=0)))
    leaves = perturbed_leaves(state_to_numpy(state), FARM_WORLDS, seed=40,
                              kick=(FARM_WORLDS - 1, 1, (2.0, 1.0)))
    return cap, leaves, _statics(w.builder)


def _motor_actions(n_w, steps):
    """tests/test_rl_demo.py's action schedule: a torso motor speed a world
    a step, whose sign follows the parity of the world."""
    t_idx = torch.arange(steps, dtype=torch.float32)[:, None]
    w_idx = torch.arange(n_w, dtype=torch.float32)[None]
    return 2.0 * torch.sin(0.05 * t_idx + w_idx) + torch.where(
        w_idx % 2 == 0, 1.5, -1.5)


@pytest.mark.parametrize("scene", ["api_scene", "joint_farm",
                                   "joint_farm-repair0"])
def test_batched_step_matches_single_step(request, scene):
    """World by world against the port's single-world Step, every leaf bit
    for bit, and no more reads a step than the worst single world. The
    api_scene batch is the one api_port stepped (both hooks)."""
    if scene == "api_scene":
        run = request.getfixturevalue("api_port")
        cap, leaves, batch_traj = run["cap"], run["leaves"], run["ttraj"]
        classes, jtypes, sensors = run["statics"]
        hooks = dict(custom_filter=_keep_pair, pre_solve=_one_way)
        n_w, steps, actions = N_W, STEPS, None
    else:
        cap, leaves, (classes, jtypes, sensors) = _farm_batch(
            scene == "joint_farm")
        hooks, batch_traj = {}, None
        n_w, steps = FARM_WORLDS, FARM_STEPS
        actions = _motor_actions(n_w, steps)
    kw = dict(joint_types=jtypes, sensor_ids=sensors, **hooks)
    bstep = (run["bstep"] if scene == "api_scene" else
             tworld.make_batched_step(cap, classes, 4, False, **kw))
    singles = [tworld.make_step(cap, classes, 4, False, **kw)
               for _ in range(n_w)]
    assert all(s.tail_w == bstep.tail_w for s in singles)
    tb = state_from_numpy(leaves, "cpu")
    ws = [unstack_state(tb, w) for w in range(n_w)]
    kinds = set()
    for k in range(steps):
        if actions is not None:
            # the torso motor (joint 0) of each world, in the (W, J) arrays
            tb = dataclasses.replace(tb, joints=dataclasses.replace(
                tb.joints, motor_speed=tb.joints.motor_speed.index_put(
                    (torch.arange(n_w), torch.zeros(n_w, dtype=torch.long)),
                    actions[k])))
            ws = [dataclasses.replace(s, joints=dataclasses.replace(
                s.joints, motor_speed=s.joints.motor_speed.index_put(
                    (torch.tensor([0]),), actions[k, w:w + 1])))
                for w, s in enumerate(ws)]
        if batch_traj is None:
            reads0 = bstep.stats.syncs
            tb = bstep(tb, DT)
            got, batch_reads = state_to_numpy(tb), bstep.stats.syncs - reads0
        else:
            got, batch_reads = batch_traj[k], run["reads"][k]
        reads = []
        for w in range(n_w):
            r0 = singles[w].stats.syncs
            ws[w] = singles[w](ws[w], DT)
            reads.append(singles[w].stats.syncs - r0)
            for key, b in state_to_numpy(ws[w]).items():
                np.testing.assert_array_equal(
                    got[key][w], b, err_msg=f"step {k + 1} world {w} {key}")
        assert batch_reads <= max(reads), k
        kinds.update(got["profile.pair_rebuild"].tolist())
    if scene == "joint_farm-repair0":
        assert kinds <= {0, 2}
    else:
        assert 1 in kinds
    if actions is not None:
        w_t = tb.bodies.w[:, 1].numpy()
        assert w_t[0::2].mean() > w_t[1::2].mean(), w_t


def _hub_batch():
    """Three hub worlds (port_fixtures.hub_scene, whose coloring overflows
    into the last color), world 1 with all but three of its joints
    disabled: its coloring does not overflow, and its live joints are
    fewer under the same LJ."""
    w = hub_scene(tapi.World, tt, tg, device="cpu")
    state, cap = w.builder.build(device="cpu")
    cap = dataclasses.replace(cap, batched=True)
    leaves = perturbed_leaves(state_to_numpy(state), 3, seed=50,
                              kick=(2, 1, (0.0, 1.0)))
    leaves["joints.enabled"][1, 3:] = False
    return cap, leaves, _statics(w.builder)


@pytest.mark.parametrize("scene", ["api_scene", "joint_farm", "hub"])
def test_batched_joint_twin_matches_single_twins(request, scene):
    """The batched step's solver inputs, joint regions included, equal each
    world's single-world inputs, and the batched twin on them equals the
    single twin world by world, bit for bit (api_scene: at the state
    api_port left, hooks on)."""
    hooks = {}
    if scene == "api_scene":
        run = request.getfixturevalue("api_port")
        cap, (classes, jtypes, sensors) = run["cap"], run["statics"]
        hooks = dict(custom_filter=_keep_pair, pre_solve=_one_way)
        tb, steps = run["last"], 0
    elif scene == "joint_farm":
        cap, leaves, (classes, jtypes, sensors) = _farm_batch(True)
        steps = 5
    else:
        cap, leaves, (classes, jtypes, sensors) = _hub_batch()
        steps = 2
    kw = dict(joint_types=jtypes, sensor_ids=sensors, **hooks)
    bstep = tworld.make_batched_step(cap, classes, 4, False, **kw)
    single = tworld.make_step(cap, classes, 4, False, **kw)
    if steps:
        tb = state_from_numpy(leaves, "cpu")
    for _ in range(steps):
        tb = bstep(tb, DT)
    args = batched_kernel_args(tb, DT, bstep)
    jr = args[11]
    out = cs.contact_solve_batched(*args)
    n_w = args[0].shape[0]
    for w in range(n_w):
        one = tworld._step_work(unstack_state(tb, w), DT, cap, classes, 4,
                                False, tworld.StepStats(), until="layout",
                                joint_types=jtypes, hooks=single.hooks)
        for a, b in zip(args[:6], one[:6]):
            assert torch.equal(a[w], b)
        assert tuple(args[6:11]) == tuple(one[6:11])
        ja = JointRows(jr.idx[w], jr.data[w], jr.acc[w], jr.type[w],
                       jr.offsets[w], bool(jr.overflow[w]))
        for name in ("idx", "data", "acc", "type", "offsets", "overflow"):
            a, b = getattr(ja, name), getattr(one[11], name)
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), (
                w, name)
        ref = cs.contact_solve_reference(*one)
        for a, b in zip(out, ref):
            assert torch.equal(a[w], b), w
    if scene == "hub":
        assert jr.overflow.tolist() == [1, 0, 1]
        live = (jr.idx[:, 0] >= 0).sum(dim=1).tolist()
        assert live[1] < live[0] and live[1] < live[2]


def test_unmappable_hook_raises():
    """A hook that torch.func.vmap cannot map over the world axis (here a
    host read) raises, naming the hook."""
    cap, leaves, (classes, jtypes, sensors) = _farm_batch(True)

    def reads_host(state, a, b):
        return a >= int(b.max())

    bstep = tworld.make_batched_step(cap, classes, 4, False,
                                     joint_types=jtypes,
                                     custom_filter=reads_host)
    with pytest.raises(RuntimeError, match="custom_filter"):
        bstep(state_from_numpy(leaves, "cpu"), DT)
