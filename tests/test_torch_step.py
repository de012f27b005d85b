"""The contact-only slice end to end: the port's World against the JAX
World on pyramid-8, stepped from spawn (XLA path on the CPU).

Bounds are the ones the JAX package holds its own kernel to against the
XLA path (tests/test_pallas_solver.py): centres to 1e-4, velocities to
2e-3. Awake flags and pair counts must match exactly.
"""

import numpy as np
import pytest
import torch

from box2d_tpu import scenes as jscenes
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch.state import state_to_numpy

torch.set_num_threads(1)


def _trajectories(rows, steps):
    jw = jscenes.pyramid(rows=rows)
    jw.compile()
    tw = tscenes.pyramid(rows=rows, device="cpu")
    tw.compile()
    out = []
    for _ in range(steps):
        jw.step(1 / 60)
        tw.step(1 / 60)
        out.append((state_to_numpy(jw.state), state_to_numpy(tw.state)))
    return out, tw


def _check(a, b, i):
    np.testing.assert_allclose(b["bodies.center"], a["bodies.center"],
                               atol=1e-4, rtol=0, err_msg=f"step {i}")
    np.testing.assert_allclose(b["bodies.v"], a["bodies.v"], atol=2e-3,
                               rtol=0, err_msg=f"step {i}")
    np.testing.assert_array_equal(b["bodies.awake"], a["bodies.awake"])
    assert b["profile.pair_count"] == a["profile.pair_count"], i


@pytest.fixture(scope="module")
def pyramid8():
    return _trajectories(8, 20)


def test_pyramid8_matches_jax_world(pyramid8):
    traj, _ = pyramid8
    for i, (a, b) in enumerate(traj):
        _check(a, b, i)
    last_j, last_t = traj[-1]
    assert last_t["profile.overflow_pairs"] == 0
    assert last_t["profile.store_drops"] == 0
    assert last_t["profile.events_dropped"] == 0


def test_run_loop_matches_step_loop(pyramid8):
    """World.run (light events on all but the last frame) steps the bodies
    exactly like World.step."""
    traj, _ = pyramid8
    tw = tscenes.pyramid(rows=8, device="cpu")
    tw.compile()
    tw.run(len(traj))
    a, b = traj[-1][1], state_to_numpy(tw.state)
    for key in a:
        if key.startswith(("bodies.", "contacts.", "profile.")):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert tw.stats.ccd_gate_openings == 0


@pytest.mark.slow
def test_pyramid20_trajectory_matches_jax_world():
    traj, tw = _trajectories(20, 60)
    for i, (a, b) in enumerate(traj):
        _check(a, b, i)
