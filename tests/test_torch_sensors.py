"""The sensor pass: the port against the JAX package.

port_fixtures.chain_sensor_scene (a sensor box that circles, capsules and
boxes fall through, one of them fast enough for the swept test) is
stepped by the port. At each step the JAX `sensor_pass` (compiled once)
and the port's get the same post-solve state, the pre-step poses and the
pre-step overlap store; the begin and end events and the new overlap
store must match exactly, and equal what the port's own step produced.
Then the port's counterpart of
tests/test_world.py::test_bullet_through_sensor_registers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from box2d_tpu import api as japi
from box2d_tpu import geometry as jg
from box2d_tpu import sensors as jsensors
from box2d_tpu import types as jt
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import types as tt
from box2d_tpu_torch.sensors import sensor_pass
from box2d_tpu_torch.state import state_to_numpy
from box2d_tpu_torch.world import StepStats
from port_fixtures import chain_sensor_scene
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

STEPS = 75
FIELDS = ("sensor_begin", "sensor_begin_count", "sensor_end",
          "sensor_end_count")


def test_sensor_pass_matches_jax():
    tw = chain_sensor_scene(tapi.World, tt, tg, device="cpu")
    tw.compile()
    jw = chain_sensor_scene(japi.World, jt, jg)
    template, jcap = jw.builder.build()
    sensors = tw._step.sensor_ids
    assert sensors == jsensors.sensor_shape_ids(jw.builder._shapes)
    fn = jax.jit(lambda st, po, pr: jsensors.sensor_pass(
        st, jcap, sensors, po, pr))
    begins = ends = swept = 0
    for i in range(STEPS):
        pre = tw.state
        tw.step()
        post = tw.state
        given = dataclasses.replace(post, sensor_overlap=pre.sensor_overlap)
        b = pre.bodies
        sens, store = sensor_pass(given, tw.capacity, sensors, b.origin,
                                  b.rot, 1, StepStats())
        sens = {k: v[0] for k, v in sens.items()}   # the one world
        ref = fn(to_jax_state(template, state_to_numpy(given)),
                 jnp.asarray(b.origin.numpy()), jnp.asarray(b.rot.numpy()))
        for f in FIELDS:
            a = np.asarray(getattr(ref.events, f))
            np.testing.assert_array_equal(
                sens[f].numpy(), a, err_msg=f"{f} step {i}")
            np.testing.assert_array_equal(
                getattr(post.events, f).numpy(), a, err_msg=f"{f} step {i}")
        np.testing.assert_array_equal(store[0].numpy(),
                                      np.asarray(ref.sensor_overlap))
        np.testing.assert_array_equal(post.sensor_overlap.numpy(),
                                      np.asarray(ref.sensor_overlap))
        begins += int(sens["sensor_begin_count"])
        ends += int(sens["sensor_end_count"])
        # the thrown circle crosses the sensor within one step: only the
        # swept test sees it
        if int(sens["sensor_begin_count"]):
            swept += bool((sens["sensor_begin"][:, 1] == 8).any())
    # each of the seven falling shapes that report sensor events enters
    # and leaves once; the circle that does not report never shows
    assert begins == 7 and ends == 7
    assert swept == 1


def test_bullet_through_sensor_registers():
    """tests/test_world.py::test_bullet_through_sensor_registers: a bullet
    that crosses a thin sensor within one step still begins a visit."""
    w = tapi.World(device="cpu")
    sensor_body = w.create_body(tt.BodyDef(type=tt.STATIC,
                                           position=(5.0, 0.0)))
    w.create_polygon_shape(sensor_body, tt.ShapeDef(
        is_sensor=True, enable_sensor_events=True), tg.box(0.05, 2.0))
    bullet = w.create_body(tt.BodyDef(
        type=tt.DYNAMIC, position=(0.0, 0.0),
        linear_velocity=(600.0, 0.0), gravity_scale=0.0, is_bullet=True))
    w.create_circle_shape(bullet, tt.ShapeDef(density=1.0,
                                              enable_sensor_events=True),
                          (0.0, 0.0), 0.1)
    w.compile()
    got_begin = False
    for _ in range(3):
        w.step(1 / 60)
        if int(w.state.events.sensor_begin_count) > 0:
            got_begin = True
    assert got_begin, "bullet passed through the sensor without an event"
    assert float(w.state.bodies.center[bullet, 0]) > 10.0  # truly crossed
