"""box2d_tpu_torch state: the builder and the carry of state across packages.

The port's builder must give the JAX builder's WorldState leaves bit for
bit (same dtypes, shapes and values), and state_from_numpy /
state_to_numpy must round-trip them.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from box2d_tpu import scenes as jscenes
from box2d_tpu_torch import scenes as tscenes
from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)


SCENES = {
    "pyramid8": (lambda: jscenes.pyramid(rows=8),
                 lambda: tscenes.pyramid(rows=8, device="cpu")),
    "joint_farm2": (lambda: jscenes.joint_farm(ragdolls=2),
                    lambda: tscenes.joint_farm(ragdolls=2, device="cpu")),
    "dam_break300": (lambda: jscenes.dam_break(300),
                     lambda: tscenes.dam_break(300, device="cpu")),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def leaves(request):
    make_j, make_t = SCENES[request.param]
    jstate, jcap = make_j().builder.build()
    tw = make_t()
    tw.compile()
    return (state_to_numpy(jstate), state_to_numpy(tw.state), jcap,
            tw.capacity, make_t)


def test_builder_leaves_bit_identical(leaves):
    jl, tl, jcap, tcap, _ = leaves
    assert sorted(jl) == sorted(tl)
    for key in jl:
        a, b = jl[key], tl[key]
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert dataclasses.asdict(tcap) == dataclasses.asdict(jcap)


def test_state_roundtrip(leaves):
    _, tl, _, _, _ = leaves
    back = state_to_numpy(state_from_numpy(tl, "cpu"))
    assert sorted(back) == sorted(tl)
    for key in tl:
        assert back[key].dtype == tl[key].dtype, key
        np.testing.assert_array_equal(back[key], tl[key], err_msg=key)


def test_jax_state_carried_into_port(leaves):
    """A JAX builder state handed over leaf by leaf steps in the port like
    the port's own state does."""
    jl, tl, _, _, make_t = leaves
    w1 = make_t()
    w1.compile()
    w2 = make_t()
    w2.compile()
    w2.state = state_from_numpy(jl, "cpu")
    w1.run(2)
    w2.run(2)
    a, b = state_to_numpy(w1.state), state_to_numpy(w2.state)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    if (jl["joints.type"] >= 0).any():
        assert np.abs(a["joints.impulse"]).max() > 0
    if "particles.pos" in jl:
        assert not np.array_equal(a["particles.pos"], jl["particles.pos"])


def test_default_device_is_the_card():
    """World(), the scenes and WorldBuilder.build() place the world on
    "cuda" when no device is named, and raise where there is none."""
    import inspect

    from box2d_tpu_torch.api import World
    from box2d_tpu_torch.builder import WorldBuilder

    for fn in (World.__init__, tscenes.pyramid, tscenes.joint_farm,
               tscenes.dam_break, WorldBuilder.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tscenes.joint_farm(ragdolls=1).compile()


def test_import_loads_no_jax():
    code = ("import sys, box2d_tpu_torch, box2d_tpu_torch.api, "
            "box2d_tpu_torch.scenes, box2d_tpu_torch.particles, "
            "box2d_tpu_torch.particles_kernels; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
