"""Per-block body-shape culling of the particle step against the JAX
package and against the port's own dense coupling.

A flat batch of nine dam_break(60) tanks (scenes.replicate) has 27 nearby
shapes, more than the 24 slots that the World's sizing gives a block of
256 sorted particles (api.World._particle_config, as box2d_tpu/api.py
sizes it), so body coupling and the anti-tunnel ray take the culled path.
- One particle step of the port from the JAX state after 3 JAX steps
  (`use_window_kernel=True, rank_repair=True`, the Pallas kernels in
  interpret mode, one jit), against the JAX package's culled step:
  positions 1e-5, velocities 1e-4, body impulses 1e-5, overflow exact
  (test_torch_particles.py's bounds).
- The port's culled World against its dense World (every shape in one
  block's slots) over 15 steps, to the bound of
  tests/test_particles.py:304-332 (rtol 1e-5, atol 5e-5).
- bench.py's flat particle batch, 64 x dam_break(500), one step from
  spawn: the reference's sizing gives a block 8 slots, and a block of
  sorted particles that spans several copies of one grid row overlaps
  more shapes than that, so both packages count the same overflow
  (ROADMAP.md section 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from box2d_tpu import particles as jpart
from box2d_tpu import scenes as jscenes
from box2d_tpu_torch import particles as tpart
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch import world as tworld
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

DT = 1 / 60
COPIES = 9
PARTICLES = 60
WARM = 3


def _flat_tanks(device="cpu"):
    w = tscenes.replicate(tscenes.dam_break(PARTICLES, device=device),
                          COPIES)
    w.compile()
    return w


def _jax_steps(copies, particles, tcfg, warm):
    """The JAX state of the flat batch, the particles after `warm` JAX
    culled steps, and the next step's outputs."""
    jstate, _ = jscenes.replicate(jscenes.dam_break(particles),
                                  copies).builder.build()
    jcfg = jpart.ParticleConfig(**tcfg._asdict())
    step = jax.jit(jpart.particle_step, static_argnums=(3,))
    pt = jstate.particles
    for _ in range(warm):
        pt = step(pt, jstate, jnp.float32(DT), jcfg)[0]
    return jstate, pt, step(pt, jstate, jnp.float32(DT), jcfg)


def test_culled_step_matches_jax():
    tw = _flat_tanks()
    tcfg = tw._step.particle_cfg._replace(rank_repair=True)
    assert tcfg.max_body_shapes > tcfg.block_shape_slots, (
        "the culled path is not taken")
    jstate, pt, (want, want_dv, want_dw, want_ov) = _jax_steps(
        COPIES, PARTICLES, tcfg, WARM)
    start = state_from_numpy(state_to_numpy(
        dataclasses.replace(jstate, particles=pt)), "cpu")
    stats = tworld.StepStats()
    got, dv, dw, ov = tpart.particle_step(start.particles, start, DT, tcfg,
                                          stats)
    alive = np.asarray(want.alive)
    np.testing.assert_array_equal(got.alive.numpy(), alive)
    np.testing.assert_allclose(got.pos.numpy()[alive],
                               np.asarray(want.pos)[alive], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.vel.numpy()[alive],
                               np.asarray(want.vel)[alive], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-5,
                               atol=1e-5)
    assert int(ov) == int(want_ov) == 0
    assert stats.rank_repairs + stats.full_sorts == tcfg.iterations


def test_culled_world_matches_dense_world():
    """tests/test_particles.py test_block_culled_body_coupling_matches_dense
    in the port: 15 steps of the flat batch, culled and dense."""
    culled = _flat_tanks()
    dense = _flat_tanks()
    dense._pcfg = dense._pcfg._replace(block_shape_slots=4096)
    dense._remake_step()
    assert culled._pcfg.max_body_shapes > culled._pcfg.block_shape_slots
    culled.run(15)
    dense.run(15)
    assert int(culled.state.profile.overflow_particles) == 0
    alive = culled.state.particles.alive.numpy()
    pos_c = culled.state.particles.pos.numpy()
    assert np.isfinite(pos_c[alive]).all()
    np.testing.assert_allclose(pos_c[alive],
                               dense.state.particles.pos.numpy()[alive],
                               rtol=1e-5, atol=5e-5)


def test_culling_overflow_matches_jax():
    n_w, n = 64, 500
    tw = tscenes.replicate(tscenes.dam_break(n, device="cpu"), n_w)
    tw.compile()
    tcfg = tw._step.particle_cfg
    assert (tcfg.max_body_shapes, tcfg.block_shape_slots) == (192, 8)
    jstate, _, (want, _, _, want_ov) = _jax_steps(n_w, n, tcfg, 0)
    start = state_from_numpy(state_to_numpy(jstate), "cpu")
    got, _, _, ov = tpart.particle_step(start.particles, start, DT, tcfg)
    assert int(ov) == int(want_ov) > 0
    alive = np.asarray(want.alive)
    np.testing.assert_allclose(got.pos.numpy()[alive],
                               np.asarray(want.pos)[alive], rtol=0,
                               atol=1e-5)
