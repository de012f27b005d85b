"""Each phase of the port's step against the same phase of the JAX step.

The same JAX state goes through both packages phase by phase: pyramid-8 at
spawn, after 15 JAX steps (warm contacts), after 15 steps with one box
pushed out of its fat AABB (the broadphase's incremental repair tier), and
after 15 steps with the broadphase marked dirty (a full rebuild that
re-aligns a live contact cache), and a warm state with contact and hit
events switched on, the top box lifted off and another thrown down.
Discrete outputs (pair lanes, hash slots, colors, layout indices, awake
flags, island labels, counts) must match exactly; floats to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import broadphase as jbp
from box2d_tpu import manifold as jmf
from box2d_tpu import narrowphase as jnp_phase
from box2d_tpu import scenes as jscenes
from box2d_tpu import solver as jsolver
from box2d_tpu.joints import prepare_joints
from box2d_tpu.world import _step_tail as jax_step_tail
from box2d_tpu.world import _step_work as jax_step_work
from box2d_tpu.world import make_step as jax_make_step
from box2d_tpu_torch import broadphase as tbp
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy
from box2d_tpu_torch.world import StepStats
from box2d_tpu_torch.world import _step_tail as torch_step_tail
from box2d_tpu_torch.world import _step_work as torch_step_work

torch.set_num_threads(1)

DT = 1 / 60
NSUB = 4
ATOL = 1e-5
PREFIXES = ("aabbs", "pairs", "narrow", "colors", "prepare", "layout")


def to_jax_state(template, leaves):
    """The JAX state `template` with every leaf taken from `leaves`
    ({dotted path: array}, see box2d_tpu_torch.state.state_to_numpy)."""
    def walk(obj, prefix):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = prefix + f.name
            if dataclasses.is_dataclass(v):
                kw[f.name] = walk(v, key + ".")
            elif v is not None:
                kw[f.name] = jnp.asarray(leaves[key])
        return dataclasses.replace(obj, **kw)
    return walk(template, "")


def check(name, a, b, atol=ATOL):
    """Exact for integer/bool leaves, atol for floats; recurses into
    dataclasses, NamedTuples and tuples."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            check(f"{name}.{f.name}", getattr(a, f.name), getattr(b, f.name),
                  atol)
        return
    if isinstance(a, tuple):
        assert len(a) == len(b), name
        fields = getattr(a, "_fields", None) or range(len(a))
        for i, f in enumerate(fields):
            check(f"{name}.{f}", a[i], b[i], atol)
        return
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def world():
    jw = jscenes.pyramid(rows=8)
    jstate0, cap = jw.builder.build()
    classes = jnp_phase.classes_for_shape_types(
        s["geom"].type for s in jw.builder._shapes)
    tw = tscenes.pyramid(rows=8, device="cpu")
    tw.compile()
    step = jax_make_step(cap, classes, NSUB, frozenset(), (), True, None, 0)
    s = jstate0
    for _ in range(15):
        s = step(s, jnp.float32(DT))
    warm = state_to_numpy(s)
    pushed = {k: v.copy() for k, v in warm.items()}
    pushed["bodies.center"][-1, 0] += 0.3     # escapes its fat AABB
    dirty = dict(warm)
    dirty["broadphase.dirty"] = np.asarray(True)
    # contact and hit events on; the top box lifted off its supports (end
    # events) and a box below it thrown down onto its own (hit events)
    events = {k: v.copy() for k, v in warm.items()}
    events["bodies.center"][-1, 1] += 0.3
    events["bodies.v"][-2] = (0.0, -3.0)
    V = (events["shapes.table"].shape[1] - 14) // 4
    for col, key in ((4 * V + 11, "enable_contact_events"),
                     (4 * V + 12, "enable_hit_events")):
        events[f"shapes.{key}"][:] = True
        events["shapes.table"][:, col] = 1.0
    states = {"spawn": state_to_numpy(jstate0), "warm": warm,
              "pushed": pushed, "dirty": dirty, "events": events}
    fns = {u: jax.jit(lambda st, u=u: jax_step_work(
        st, jnp.float32(DT), cap, classes, NSUB, frozenset(), (), True,
        None, 1, until=u)) for u in PREFIXES}
    dt = jnp.float32(DT)
    h = dt / NSUB
    fns["find_pairs"] = jax.jit(
        lambda st, a: jbp.find_pairs(st, cap, a))
    fns["tail"] = jax.jit(lambda *a: jax_step_tail(
        a[0], a[1], a[2], a[3], dt, 1.0 / dt, 1.0 / h, cap, a[4], a[5],
        a[6], a[7], (), True, a[8], a[9], a[10], a[11], a[12], a[13], None,
        None, a[14]))
    return dict(template=jstate0, cap=cap, classes=classes, tw=tw,
                states=states, fns=fns)


def _both(world, name):
    leaves = world["states"][name]
    return (to_jax_state(world["template"], leaves),
            state_from_numpy(leaves, "cpu"))


def _torch_until(world, tstate, until):
    tw = world["tw"]
    return torch_step_work(tstate, DT, tw.capacity, tw._step.classes, NSUB,
                           True, StepStats(), until=until)


STATES = ["spawn", "warm", "pushed", "dirty", "events"]


@pytest.mark.parametrize("phase", PREFIXES)
@pytest.mark.parametrize("name", STATES)
def test_phase_matches_jax(world, name, phase):
    jstate, tstate = _both(world, name)
    ref = world["fns"][phase](jstate)
    out = _torch_until(world, tstate, phase)
    if phase == "pairs":
        kind = _torch_until(world, tstate, "tail")[-1][4]
        assert int(kind) == {"spawn": 2, "warm": 0, "pushed": 1,
                             "dirty": 2, "events": 1}[name]
    elif phase == "prepare":
        assert out[1] is None                 # a joint-free world prepares none
        ref, out = ref[0], out[0]
    elif phase == "layout":
        ref = (ref[2], ref[0], ref[1])        # idx, data, acc
        out = out[1:4]
    check(phase, ref, out)


@pytest.mark.parametrize("name", ["spawn", "warm"])
def test_full_rebuild_matches_jax(world, name):
    """find_pairs (the full rebuild) on the same state and AABBs."""
    jstate, tstate = _both(world, name)
    cap = world["cap"]
    aabbs = jbp.compute_shape_aabbs(jstate, cap.max_verts)
    ref = world["fns"]["find_pairs"](jstate, aabbs)
    out = tbp.find_pairs(tstate, world["tw"].capacity,
                         torch.from_numpy(np.array(aabbs)))
    check("find_pairs", ref, out)
    assert int(out.count) > 0


def _to_jax_tuple(cls, x):
    return cls(*[jnp.asarray(v.cpu().numpy()) for v in x])


@pytest.mark.parametrize("name", STATES)
def test_step_tail_matches_jax(world, name):
    """_step_tail on the port's own tail inputs, converted for JAX."""
    _, tstate = _both(world, name)
    (st, data, bs, dt, inv_dt, cap_t, pairs, num_colors, overflow_colors,
     touching, continuous, color_store, ni, ti, roll, tni, relv,
     orphan_info) = _torch_until(world, tstate, "tail")
    jst = to_jax_state(world["template"], state_to_numpy(st))
    j = lambda v: jnp.asarray(v.cpu().numpy())
    jdata = jnp_phase.ContactData(*[
        _to_jax_tuple(jmf.Manifold, v) if f == "manifold" else j(v)
        for f, v in zip(data._fields, data)])
    jbs = _to_jax_tuple(jsolver.BodySolverState, bs)
    h = jnp.float32(DT) / NSUB
    jc = prepare_joints(jst, jbs, jnp.full_like(jst.joints.color, -1), h,
                        1.0 / h, frozenset())
    ref = world["fns"]["tail"](
        jst, jdata, jbs, jc, _to_jax_tuple(jbp.PairBuffer, pairs),
        j(num_colors), j(overflow_colors), j(touching), j(color_store),
        j(ni), j(ti), j(roll), j(tni), j(relv),
        tuple(j(v) for v in orphan_info))
    out = torch_step_tail(st, data, bs, dt, inv_dt, cap_t, pairs, num_colors,
                          overflow_colors, touching, continuous, color_store,
                          ni, ti, roll, tni, relv, orphan_info, StepStats())
    a, b = state_to_numpy(ref), state_to_numpy(out)
    if name == "events":
        assert b["events.contact_end_count"] > 0
        assert b["events.hit_count"] > 0
    assert sorted(a) == sorted(b)
    for key in a:
        check(key, a[key], b[key])


def test_overflow_color_layout_matches_jax():
    """color_chunk=4 makes the dynamic colors overflow at spawn: the
    overflow color, its mass-splitting relax row and the tail placement
    (demoted and dropped lanes) must match the JAX layout."""
    jw = jscenes.pyramid(rows=8)
    cap = dataclasses.replace(jw.builder.build()[1], color_chunk=4)
    jstate, cap = jw.builder.build(cap)
    classes = jnp_phase.classes_for_shape_types(
        s["geom"].type for s in jw.builder._shapes)
    tw = tscenes.pyramid(rows=8, device="cpu")
    tw.compile(cap)
    for until in ("colors", "layout"):
        ref = jax.jit(lambda st: jax_step_work(
            st, jnp.float32(DT), cap, classes, NSUB, frozenset(), (), True,
            None, 1, until=until))(jstate)
        out = torch_step_work(tw.state, DT, tw.capacity, tw._step.classes,
                              NSUB, True, StepStats(), until=until)
        if until == "colors":
            check(until, ref, out)
            assert float(out[3].min()) < 1.0        # relaxed overflow lanes
        else:
            check(until, (ref[2], ref[0], ref[1]), out[1:4])
            l0 = out[8]
            assert int((out[1][0, l0:] >= 0).sum()) > 0   # live tail lanes


def test_probe_slots_match_jax():
    """The contact store's murmur hash (uint32 in JAX, int64 with masks in
    the port) on random keys, including -1 and keys near 2**31."""
    from box2d_tpu_torch import narrowphase as tnp_phase

    rng = np.random.default_rng(7)
    ka = rng.integers(-1, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    kb = rng.integers(-1, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    ka[:4] = [-1, 0, 2**31 - 1, 12345]
    kb[:4] = [-1, 2**31 - 1, 0, 12346]
    for t in (1024, 1 << 20):
        ref = jnp_phase._probe_slots(jnp.asarray(ka), jnp.asarray(kb), t)
        out = tnp_phase._probe_slots(torch.from_numpy(ka),
                                     torch.from_numpy(kb), t)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
