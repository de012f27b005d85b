"""Batches of worlds sharded over a list of devices
(box2d_tpu_torch/multichip.py), on the CPU, where a device list repeats
"cpu" as the JAX package's tests repeat their virtual CPU devices.

- The slice against the JAX package: tests/test_multichip.py's
  test_sharded_batch_matches_single_world setup (pyramid(rows=3), 8
  worlds, vx += 0.01 * (i + 1) on the dynamic bodies, 3 steps) through
  jax.jit(jax.vmap(_step)) on a batch sharded over the conftest's 8 CPU
  devices, and through the port's make_sharded_step on ["cpu"] * 4:
  discrete leaves equal, centres within that test's rtol = atol = 1e-6
  at every step, and angular velocities (1e-6) and velocities (1e-5)
  after the first step; after the second and third, velocities within
  tests/test_torch_step.py's 2e-3 (the test's docstring says why). The
  JAX step is traced without its continuous pass (its cold compile takes
  about half as long; the port's own CCD gate is asserted shut), as
  tests/test_torch_batch.py traces it.
- Bits: the port's sharded batch equals its unsharded batch world by
  world, bit for bit, for contact-only, jointed (joint_farm(1)) and
  particle (a small dam_break) worlds; the flat layout's shards each equal
  one single-world step.
- The dry run's two configurations on ["cpu"] * 2.
- Errors: an uneven split, a dry run without its devices, a hook that
  raises in one shard.
- Counters: exact under threads (a stress test), and each shard's stats
  count the solver launches of its own thread, one a rigid step.
The JAX step compiles once in this file.
"""

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from box2d_tpu import scenes as jscenes
from box2d_tpu.narrowphase import classes_for_shape_types as jclasses
from box2d_tpu.world import _step as jax_step
from box2d_tpu_torch import batch as tbatch
from box2d_tpu_torch import contact_solver as cs
from box2d_tpu_torch import counters
from box2d_tpu_torch import multichip as mc
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.narrowphase import classes_for_shape_types
from box2d_tpu_torch.state import (Capacity, state_from_numpy,
                                   state_to_numpy)
from port_fixtures import perturbed_leaves

torch.set_num_threads(1)

DT = 1 / 60
N_WORLDS = 8
CPU4 = ["cpu"] * 4


def _jax_tree(template, leaves, prefix=""):
    """The JAX state tree of `template` with every leaf from {dotted path:
    array}."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        key = prefix + f.name
        if v is None:
            kw[f.name] = None
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _jax_tree(v, leaves, key + ".")
        else:
            kw[f.name] = jnp.asarray(leaves[key])
    return dataclasses.replace(template, **kw)


def _same_bits(got, want, tag):
    """Every leaf of two states equal bit for bit."""
    a, b = state_to_numpy(got), state_to_numpy(want)
    assert sorted(a) == sorted(b), tag
    for key in b:
        assert a[key].dtype == b[key].dtype, f"{tag} {key}"
        assert a[key].shape == b[key].shape, f"{tag} {key}"
        assert a[key].tobytes() == b[key].tobytes(), f"{tag} {key}"


def _run(step, x, steps):
    for _ in range(steps):
        x = step(x, DT)
    return x


def test_sharded_batch_matches_jax():
    """The port's batch sharded over 4 CPU shards against the JAX
    package's batch sharded over its 8 CPU devices, at every step: every
    discrete leaf equal, centres within 1e-6; angular velocities within
    1e-6 and velocities within 1e-5 after the first step, within
    tests/test_torch_step.py's 2e-3 after the second and third, where
    three of the worlds part from the JAX step by up to 1.0e-4 (the
    port's single-world step parts from it alike on those worlds, and
    its batched step equals that step bit for bit)."""
    devices = jax.devices("cpu")[:N_WORLDS]
    assert len(devices) == N_WORLDS
    mesh = Mesh(np.array(devices), ("worlds",))
    shard = NamedSharding(mesh, P("worlds"))
    jw = jscenes.pyramid(rows=3)
    jstate, jcap = jw.builder.build()
    classes = frozenset(jclasses(s["geom"].type for s in jw.builder._shapes))
    base = state_to_numpy(jstate)
    leaves = {k: np.stack([v] * N_WORLDS) for k, v in base.items()}
    dyn = base["bodies.type"] == 2
    for i in range(N_WORLDS):
        leaves["bodies.v"][i, dyn, 0] += np.float32(0.01 * (i + 1))

    def one(s):
        return jax_step(s, jnp.float32(DT), jcap, classes, 4, frozenset(),
                        (), False)

    vstep = jax.jit(jax.vmap(one))
    jb = jax.tree.map(lambda x: jax.device_put(x, shard),
                      _jax_tree(jstate, leaves))
    tcap = Capacity(**dataclasses.asdict(jcap))
    with mc.make_sharded_step(tcap, classes, CPU4) as step:
        shards = mc.shard_batch(state_from_numpy(leaves, "cpu"), CPU4)
        for k in range(3):
            jb = vstep(jb)
            shards = step(shards, DT)
            got = state_to_numpy(mc.gather_batch(shards, "cpu"))
            want = state_to_numpy(jb)
            assert sorted(got) == sorted(want)
            tag = f"step {k + 1}"
            for key, v in want.items():
                if v.dtype.kind != "f":
                    np.testing.assert_array_equal(got[key], v,
                                                  err_msg=f"{tag} {key}")
            vel = (1e-6, 1e-5) if k == 0 else (2e-3, 2e-3)
            for key, tol in (("bodies.center", 1e-6), ("bodies.w", vel[0]),
                             ("bodies.v", vel[1])):
                np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                           atol=tol, err_msg=f"{tag} {key}")
    assert jb.bodies.center.sharding.is_equivalent_to(
        shard, jb.bodies.center.ndim)
    assert [int(s.bodies.center.shape[0]) for s in shards] == [2] * 4
    assert all(st.ccd_gate_openings == 0 and st.steps == 3
               for st in step.stats)


def _pyramid_batch(rows, n_w, seed):
    w = tscenes.pyramid(rows=rows, device="cpu")
    state, cap = w.builder.build(device="cpu")
    cap = dataclasses.replace(cap, bp_repair_cap=0, batched=True)
    classes = classes_for_shape_types(s["geom"].type for s in w.builder._shapes)
    leaves = perturbed_leaves(state_to_numpy(state), n_w, seed=seed,
                              kick=(n_w - 1, 5, (2.0, 1.0)))
    return state_from_numpy(leaves, "cpu"), cap, classes, {}


def _joint_batch(n_w, seed):
    from box2d_tpu_torch.joints import joint_types_present

    w = tscenes.joint_farm(ragdolls=1, device="cpu")
    state, cap = w.builder.build(device="cpu")
    cap = dataclasses.replace(cap, batched=True)
    classes = classes_for_shape_types(s["geom"].type for s in w.builder._shapes)
    kw = dict(joint_types=joint_types_present(
        j["_type"] for j in w.builder._joints))
    leaves = perturbed_leaves(state_to_numpy(state), n_w, seed=seed,
                              kick=(1, 1, (1.0, 2.0)))
    return state_from_numpy(leaves, "cpu"), cap, classes, kw


def _particle_batch(n_w, seed):
    w = tscenes.dam_break(60, device="cpu")
    w.compile()
    leaves = perturbed_leaves(state_to_numpy(w.state), n_w, seed=seed,
                              particle_jitter=0.005, param_spread=0.05)
    return (state_from_numpy(leaves, "cpu"), w.capacity, w._classes,
            dict(particle_cfg=w._step.particle_cfg))


@pytest.mark.parametrize("kind, steps", [
    ("pyramid", 4), ("joint_farm", 4), ("dam_break", 3)])
def test_sharded_equals_unsharded_bits(kind, steps):
    """Two shards of two worlds each, stepped in two threads, against the
    same four worlds as one unsharded batch: every leaf of every world
    equal bit for bit at the end."""
    n_w = 4
    batch, cap, classes, kw = {
        "pyramid": lambda: _pyramid_batch(4, n_w, 3),
        "joint_farm": lambda: _joint_batch(n_w, 5),
        "dam_break": lambda: _particle_batch(n_w, 7)}[kind]()
    whole = _run(tworld.make_batched_step(cap, classes, 4, True, **kw),
                 batch, steps)
    devices = ["cpu", "cpu"]
    with mc.make_sharded_step(cap, classes, devices, **kw) as step:
        out = _run(step, mc.shard_batch(batch, devices), steps)
    _same_bits(mc.gather_batch(out, "cpu"), whole, kind)
    assert all(st.steps == steps for st in step.stats)


def test_flat_layout_equals_single_world_step():
    """Two shards of replicate(pyramid(rows=3), 2), each stepped by the
    single-world step in its own thread, equal to that world stepped alone
    (the second shard's copy kicked apart)."""
    w = tscenes.replicate(tscenes.pyramid(rows=3, device="cpu"), 2)
    state, cap = w.builder.build(device="cpu")
    classes = classes_for_shape_types(s["geom"].type for s in w.builder._shapes)
    leaves = perturbed_leaves(state_to_numpy(state), 2, seed=9,
                              kick=(1, 3, (1.5, 0.5)))
    batch = state_from_numpy(leaves, "cpu")
    devices = ["cpu", "cpu"]
    with mc.make_sharded_step(cap, classes, devices, layout="flat") as step:
        out = _run(step, mc.shard_batch(batch, devices), 3)
    for k in range(2):
        alone = tworld.make_step(cap, classes, 4, True)
        want = _run(alone, state_from_numpy(
            {key: v[k] for key, v in leaves.items()}, "cpu"), 3)
        _same_bits(state_from_numpy({key: v[0] for key, v in
                                     state_to_numpy(out[k]).items()},
                                    "cpu"), want, f"flat shard {k}")
    a, b = (state_to_numpy(o)["bodies.center"] for o in out)
    assert not np.array_equal(a, b), "the shards stepped the same world"


def test_dryrun_on_repeated_cpu_devices(capsys):
    """dryrun_multichip's two configurations on ["cpu"] * 2, the
    counterpart of the JAX dry run on virtual CPU devices: both print
    their line."""
    mc.dryrun_multichip(2, ["cpu", "cpu"])
    out = capsys.readouterr().out
    assert "dryrun_multichip vmapped OK on 2 devices" in out
    assert "dryrun_multichip flat OK: 2 devices x (flat 8x pyramid-20" in out


def test_errors_raise():
    """An uneven split, a dry run on devices that do not exist, a flat
    block of two worlds, and a hook that raises in one shard's thread
    (raised in the caller, naming the shard, after the other shard has
    finished its step)."""
    batch, cap, classes, _ = _pyramid_batch(3, 3, 1)
    with pytest.raises(ValueError, match="do not split evenly"):
        mc.shard_batch(batch, ["cpu", "cpu"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        mc.dryrun_multichip(have + 1)
    with pytest.raises(RuntimeError, match="does not exist"):
        mc.dryrun_multichip(2, [f"cuda:{have}"] * 2)
    with pytest.raises(ValueError, match="one world a shard"):
        with mc.make_sharded_step(cap, classes, ["cpu"],
                                  layout="flat") as step:
            step([batch], DT)

    def custom_filter(state, a, b):
        if threading.current_thread().name.startswith("shard-1_"):
            raise ValueError("a hook failed in shard 1")
        return a >= 0

    batch, cap, classes, _ = _pyramid_batch(3, 2, 1)
    devices = ["cpu", "cpu"]
    with mc.make_sharded_step(cap, classes, devices,
                              custom_filter=custom_filter) as step:
        with pytest.raises(ValueError, match="a hook failed") as err:
            step(mc.shard_batch(batch, devices), DT)
        assert any("in shard 1 of 2" in n for n in err.value.__notes__)
        assert step.stats[0].steps == 1


def test_counters_exact_under_threads():
    """Twice as many threads as cores bump one counter 2,000 times each,
    each counting into its own set, with the interpreter switching threads
    every microsecond: the module total and every thread's set exact (a
    lost update would show)."""
    n = 2 * (os.cpu_count() or 4)
    ns = {"__name__": "box2d_tpu_torch.fake", "N": 0}
    sets = [{} for _ in range(n)]
    go = threading.Barrier(n)

    def work(k):
        with counters.counting(sets[k]):
            go.wait(timeout=30)
            for _ in range(2000):
                counters.bump(ns, "N")

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ns["N"] == n * 2000
    assert sets == [{"fake.N": 2000}] * n


def test_per_shard_solver_launches(monkeypatch):
    """Each shard's stats count one solver launch a rigid step of its own
    thread, and the module total sums both shards. On the CPU the solver
    takes its twin, which counts nothing, so its wrapper is wrapped here
    with the count a launch makes."""
    real = tbatch.contact_solve_batched

    def counted(*args):
        out = real(*args)
        counters.bump(vars(cs), "BATCHED_LAUNCHES")
        return out

    monkeypatch.setattr(tbatch, "contact_solve_batched", counted)
    monkeypatch.setattr(cs, "BATCHED_LAUNCHES", 0)
    batch, cap, classes, _ = _pyramid_batch(3, 4, 2)
    devices = ["cpu", "cpu"]
    with mc.make_sharded_step(cap, classes, devices) as step:
        _run(step, mc.shard_batch(batch, devices), 4)
    rigid = [st.steps - st.idle_steps for st in step.stats]
    assert all(r > 0 for r in rigid)
    assert [st.launches.get("contact_solver.BATCHED_LAUNCHES")
            for st in step.stats] == rigid
    assert cs.BATCHED_LAUNCHES == sum(rigid)
