"""The port against the scalar oracles of the C# reference (tests/oracle.py).

tests/test_oracle.py holds the JAX package to a numpy transliteration of
the reference's TGS-soft solver and joint solvers: the single-contact
scenes and the twelve joint scenes within 1e-3 over 1,000 steps
(BASELINE.json's north star), the two stacks within 1e-2 over 600. This
file runs the same scenes through `box2d_tpu_torch.api.World` on the CPU
and holds its trajectory to the same oracle trajectory at the same bounds.

The scenes are test_oracle.py's own builders, rebound to the port's World,
types and geometry modules (`_port`), so both packages build the same
bodies, shapes and joints. The oracle trajectory is made by
test_oracle._run_oracle, as that file makes it (the oracle consumes the
JAX narrow phase's manifolds of its own state, so JAX is imported here;
the port is not).

The full check, every scene at its full horizon, is `slow`. The tier-1
part runs five scenes that cover the contact solver, restitution and every
joint family's motor, spring or soft path over their first 60 steps, under
the same bounds.
"""

import functools
import types as pytypes

import numpy as np
import pytest
import torch

import test_oracle as jo
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tgeo
from box2d_tpu_torch import types as ttypes

torch.set_num_threads(1)

# test_oracle.test_oracle_drift's scenes: builder, keyword arguments
SCENES = {
    "drop": (jo._box_drop, {}),
    "bounce": (jo._box_drop, {"restitution": 0.5}),
    "slide": (jo._box_drop, {"vx": 4.0, "drop": 0.55}),
    "stack2": (jo._stack, {"n": 2}),
    "stack3": (jo._stack, {"n": 3}),
    "capsule": (jo._capsule_rest, {}),
    "pendulum": (jo._pendulum, {}),
    "pendulum_motor": (jo._pendulum, {"motor": True, "limit": True}),
    "pendulum_spring": (jo._pendulum, {"spring": True}),
    "dist_rigid": (jo._dist_bob, {}),
    "dist_spring": (jo._dist_bob, {"spring": True}),
    "slider": (jo._slider, {}),
    "slider_motor": (jo._slider, {"motor": True, "spring": True}),
    "wheel": (jo._wheel, {"limit": True}),
    "wheel_motor": (jo._wheel, {"motor": True, "limit": True}),
    "weld_rigid": (jo._weld, {}),
    "weld_soft": (jo._weld, {"soft": True}),
    "motor_joint": (jo._motor_joint, {}),
}
# test_oracle.test_oracle_drift's horizons and bounds
FULL = [(s, 600 if s.startswith("stack") else 1000,
         1e-2 if s.startswith("stack") else 1e-3) for s in SCENES]
BOUND = dict((s, b) for s, _, b in FULL)
SHORT = ["bounce", "stack3", "pendulum_motor", "slider_motor", "weld_soft"]
SHORT_STEPS = 60


def _port(fn):
    """test_oracle's builder `fn` with its module's World, types and
    geometry (and `_world`, which reads them) swapped for the port's on the
    CPU."""
    glb = dict(jo.__dict__)
    glb.update(World=functools.partial(tapi.World, device="cpu"), t=ttypes,
               g=tgeo)
    glb["_world"] = pytypes.FunctionType(jo._world.__code__, glb, "_world",
                                         jo._world.__defaults__)
    return pytypes.FunctionType(fn.__code__, glb, fn.__name__,
                                fn.__defaults__)


def _run_port(w, steps, dt=1.0 / 60.0):
    w.compile()
    for _ in range(steps):
        w.step(dt)
    return w.state.bodies.center.numpy()


def _drift(scene, steps):
    fn, kw = SCENES[scene]
    oracle_c = jo._run_oracle(fn(**kw), steps)
    port_c = _run_port(_port(fn)(**kw), steps)
    assert port_c.shape == oracle_c.shape
    return float(np.max(np.abs(oracle_c - port_c)))


def test_builders_rebind_to_the_port():
    """A rebound builder makes a port World with the JAX builder's bodies,
    shapes and joints."""
    fn, kw = SCENES["slider_motor"]
    jw, pw = fn(**kw), _port(fn)(**kw)
    assert isinstance(pw, tapi.World) and pw.device.type == "cpu"
    for kind in ("_bodies", "_shapes", "_joints"):
        assert len(getattr(pw.builder, kind)) == len(getattr(jw.builder, kind))


@pytest.mark.parametrize("scene", SHORT)
def test_port_oracle_drift_short(scene):
    drift = _drift(scene, SHORT_STEPS)
    print(f"{scene}: {SHORT_STEPS} steps, drift {drift:.3e}")
    assert drift < BOUND[scene], f"{scene}: drift {drift}"


@pytest.mark.slow
@pytest.mark.parametrize("scene,steps,bound", FULL)
def test_port_oracle_drift(scene, steps, bound):
    drift = _drift(scene, steps)
    print(f"{scene}: {steps} steps, drift {drift:.3e}")
    assert drift < bound, f"{scene}: drift {drift}"
