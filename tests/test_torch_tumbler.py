"""The tumbler with an overflowing pair buffer: the port's step against the
JAX package's.

At the reference's own capacity rule (4 pairs a shape) the pair buffer of
tumbler(2000) overflows and its contact store drops entries, in the JAX
package as in the port (BENCH_FULL.json "tumbler": 59 overflowing pairs,
5 store drops). Here a drum of N boxes with its pair capacity cut to
PAIRS overflows in the same way: the port steps it WARM steps from spawn
(quicker here than the JAX step), then both packages take STEPS steps
from that state, the JAX step compiled once. The kinematic drum rebuilds
every pair each step. Its CCD gate stays shut (no static shape), so the
JAX step is traced without its continuous pass. Per step: the profile's
counters (pair count, overflowing pairs, store drops, dropped events), the
pair buffer and the contact store's keys exact; positions and rotations
to 1e-5 (velocities are not held: XLA's CPU backend fuses multiply-adds
and the port does not, and the two differ by up to 1e-4 there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import narrowphase as jnp_phase
from box2d_tpu import scenes as jscenes
from box2d_tpu.world import _step as jax_step
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch.state import state_to_numpy
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

DT = 1 / 60
NSUB = 4
ATOL = 1e-5
N, PAIRS = 200, 512
WARM, STEPS = 90, 6
LEAVES = {
    "counters": ("profile.pair_count", "profile.overflow_pairs",
                 "profile.store_drops", "profile.events_dropped"),
    "pairs": ("broadphase.shape_a", "broadphase.shape_b",
              "broadphase.valid", "broadphase.count"),
    "store": ("contacts.key_a", "contacts.key_b"),
    "poses": ("bodies.center", "bodies.rot"),
}


@pytest.fixture(scope="module")
def runs():
    """Both packages' states after each of STEPS steps from the port's
    warmed state."""
    jw = jscenes.tumbler(N)
    cap = dataclasses.replace(jw.builder.build()[1],
                              max_contact_pairs=PAIRS)
    jstate0, cap = jw.builder.build(cap)
    classes = jnp_phase.classes_for_shape_types(
        s["geom"].type for s in jw.builder._shapes)
    tw = tscenes.tumbler(N, device="cpu")
    tw.compile(cap)
    tw.run(WARM, DT)
    step = jax.jit(lambda s: jax_step(
        s, jnp.float32(DT), cap, classes, NSUB, frozenset(), (), False,
        None, 0))
    s = to_jax_state(jstate0, state_to_numpy(tw.state))
    jtraj, ttraj = [], []
    for _ in range(STEPS):
        s = step(s)
        tw.step(DT)
        jtraj.append(state_to_numpy(s))
        ttraj.append(state_to_numpy(tw.state))
    assert tw.stats.ccd_gate_openings == 0
    return jtraj, ttraj


@pytest.mark.parametrize("group", sorted(LEAVES))
def test_tumbler_overflow_matches_jax(runs, group):
    for i, (a, b) in enumerate(zip(*runs)):
        for key in LEAVES[group]:
            if a[key].dtype.kind in "biu":
                np.testing.assert_array_equal(b[key], a[key],
                                              err_msg=f"step {i} {key}")
            else:
                np.testing.assert_allclose(b[key], a[key], atol=ATOL, rtol=0,
                                           err_msg=f"step {i} {key}")
    if group == "counters":
        # the buffer overflows and the store drops entries in every step
        for b in runs[1]:
            assert b["profile.overflow_pairs"] > 0
            assert b["profile.store_drops"] > 0
