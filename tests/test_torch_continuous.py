"""The continuous pass: the port against the JAX package.

JAX's `continuous_pass` is compiled once and run on states that the port
warmed and carried across: a bullet at a thin wall, a fast box at a thin
ground, a bullet at a thin dynamic plate, a bullet sliding along the
ground it starts on (its TOI hits at fraction 0 and takes the core-proxy
retry), bullet_barrage(8), and a crowd of bullets with more fast shapes
than `fast_cap` and more candidates than `cand_cap`. Each is taken the
step before its sweep first hits. The advancement fractions must match
to 1e-5 and the overflow count exactly. Port-only counterparts of the
reference's tunnelling tests follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import continuous as jcont
from box2d_tpu import scenes as jscenes
from box2d_tpu import solver as jsolver
from box2d_tpu.state import Capacity as JCapacity
from box2d_tpu_torch import api, scenes
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import types as tt
from box2d_tpu_torch.continuous import continuous_pass
from box2d_tpu_torch.state import Capacity, state_to_numpy
from box2d_tpu_torch.world import StepStats, _step_work
from port_fixtures import ccd_scene
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

DT = 1 / 60
FAST_CAP, CAND_CAP = 8, 4
CAP = dict(max_bodies=16, max_shapes=16, max_joints=1, max_contact_pairs=64,
           max_verts=4, fast_cap=FAST_CAP, cand_cap=CAND_CAP)
# (scene, steps the port runs first: the sweep hits on the next step)
STATES = [("wall", 2), ("ground", 5), ("plate", 3), ("slide", 0),
          ("crowd", 0), ("barrage", 11)]


@pytest.fixture(scope="module")
def jax_pass():
    template, _ = jscenes.bullet_barrage(8).builder.build(JCapacity(**CAP))
    fn = jax.jit(lambda st, bs: jcont.continuous_pass(
        st, bs, jnp.float32(DT), FAST_CAP, CAND_CAP))
    return template, fn


def _tail_inputs(kind, warm):
    """The port's state and solved body velocities at the continuous pass
    of the step after `warm` steps."""
    w = (scenes.bullet_barrage(8, device="cpu") if kind == "barrage"
         else ccd_scene(kind, api.World, tt, tg, device="cpu"))
    w.compile(Capacity(**CAP))
    w.run(warm)
    tail = _step_work(w.state, DT, w.capacity, w._step.classes, 4, True,
                      StepStats(), until="tail")
    return tail[0], tail[2]


@pytest.mark.parametrize("kind,warm", STATES)
def test_continuous_pass_matches_jax(jax_pass, kind, warm):
    template, fn = jax_pass
    state, bs = _tail_inputs(kind, warm)
    stats = StepStats()
    adv, ovf = continuous_pass(state, bs, float(np.float32(DT)), stats,
                               FAST_CAP, CAND_CAP)
    jbs = jsolver.BodySolverState(*[jnp.asarray(v.numpy()) for v in bs])
    ref_adv, ref_ovf = fn(to_jax_state(template, state_to_numpy(state)), jbs)
    np.testing.assert_allclose(adv.numpy(), np.asarray(ref_adv), atol=1e-5,
                               rtol=0)
    assert int(ovf) == int(ref_ovf)
    assert stats.ccd_gate_openings == 1 and stats.toi_pairs > 0
    if kind == "slide":
        assert stats.toi_retries == 1
    else:
        assert (adv < 1.0).any(), "the sweep did not hit"
    assert (int(ovf) > 0) == (kind == "crowd")


def test_bullet_does_not_tunnel_thin_wall():
    """tests/test_continuous.py::test_bullet_does_not_tunnel_thin_wall."""
    w = ccd_scene("wall", api.World, tt, tg, device="cpu")
    w.compile()
    w.run(30)
    assert w.body_position(1)[0] < 10.0
    assert w.stats.ccd_gate_openings > 0


def test_bullet_barrage_stops_at_the_first_wall():
    """bullet_barrage(8), 60 steps: every bullet spawns below the walls'
    top and ends left of the first wall's far face (x = 20.05); the JAX
    package stops them at x = 19.85."""
    w = scenes.bullet_barrage(8, device="cpu")
    w.compile()
    w.run(60)
    c = w.state.bodies.center.numpy()
    dyn = w.state.bodies.type.numpy() == tt.DYNAMIC
    assert np.isfinite(c).all()
    assert c[dyn, 0].max() < 20.05
    assert int(w.state.profile.overflow_ccd) == 0
    assert w.stats.ccd_gate_openings > 0 and w.stats.toi_pairs > 0
