"""The public names the port carries for parity with the JAX package
(tests/test_torch_parity.py), each against its JAX counterpart on the
same inputs, made from a numpy seed: the math2d helpers (floats within
1e-6, masks equal), geometry.transform_polygon (bit for bit: both are
NumPy), manifold.collide_polygons (one pair; floats within 1e-5,
counts and ids equal), particles.calculate_reasonable_particle_iterations
(equal) and the QueryFilter and ExplosionDef structs (same fields and
defaults).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import geometry as jg
from box2d_tpu import manifold as jm
from box2d_tpu import math2d as jmath
from box2d_tpu import particles as jparticles
from box2d_tpu import types as jtypes
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import manifold as tm
from box2d_tpu_torch import math2d as tmath
from box2d_tpu_torch import particles as tparticles
from box2d_tpu_torch import types as ttypes

N = 7


def _vec(rng, scale=3.0):
    return rng.uniform(-scale, scale, (N, 2)).astype(np.float32)


def _rot(rng):
    a = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    return np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)


def _f(rng, lo=-3.0, hi=3.0):
    return rng.uniform(lo, hi, N).astype(np.float32)


def _box(rng):
    lo = _vec(rng)
    return np.concatenate([lo, lo + rng.uniform(0.1, 2.0, (N, 2))
                           .astype(np.float32)], -1)


MATH_CASES = {
    "vec2": lambda r: (_f(r), np.float32(0.5)),
    "length_squared": lambda r: (_vec(r),),
    "distance_squared": lambda r: (_vec(r), _vec(r)),
    "clamp_vec": lambda r: (_vec(r), _vec(r, 1.0) - 1.0, _vec(r, 1.0) + 1.0),
    "rot_from_angle": lambda r: (_f(r, -10.0, 10.0),),
    "rot_angle": lambda r: (_rot(r),),
    "rot_integrate": lambda r: (_rot(r), _f(r, -0.2, 0.2)),
    "relative_angle": lambda r: (_rot(r), _rot(r)),
    "unwind_angle": lambda r: (np.concatenate([
        _f(r, -20.0, 20.0), np.float32([np.pi, -np.pi, 0.0])]),),
    "inv_transform_point": lambda r: (_vec(r), _rot(r), _vec(r)),
    "mul_transforms": lambda r: (_vec(r), _rot(r), _vec(r), _rot(r)),
    "solve22": lambda r: tuple(_f(r) for _ in range(6)),
    "solve22_singular": lambda r: (np.float32([1.0, 2.0, 0.0]),
                                   np.float32([2.0, 4.0, 0.0]),
                                   np.float32([1.0, 2.0, 0.0]),
                                   np.float32([2.0, 4.0, 0.0]),
                                   _f(r)[:3], _f(r)[:3]),
    "aabb": lambda r: (_vec(r), _vec(r)),
    "aabb_center": lambda r: (_box(r),),
    "aabb_extents": lambda r: (_box(r),),
    "aabb_contains": lambda r: (_box(r), _box(r)),
    "aabb_perimeter": lambda r: (_box(r),),
    "spring_damper": lambda r: (_f(r, 0.0, 30.0), _f(r, 0.0, 2.0), _f(r),
                                _f(r), np.float32(1 / 240)),
}


def _leaves(out):
    return [np.asarray(x) for x in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("case", sorted(MATH_CASES))
def test_math2d_helper_matches_jax(case):
    name = case.replace("_singular", "")
    args = MATH_CASES[case](np.random.default_rng(len(case)))
    want = _leaves(getattr(jmath, name)(*(jnp.asarray(a) for a in args)))
    got = _leaves(getattr(tmath, name)(*(torch.from_numpy(np.array(a))
                                         for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, case
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=case)
        else:
            np.testing.assert_array_equal(g, w, err_msg=case)


@pytest.mark.parametrize("angle", [0.0, 0.7, -2.4])
def test_transform_polygon_matches_jax(angle):
    pts = [(0.0, 0.0), (1.5, -0.2), (2.0, 1.0), (0.3, 1.7)]
    want = jg.transform_polygon(jg.polygon(pts, 0.1), (1.25, -3.5), angle)
    got = tg.transform_polygon(tg.polygon(pts, 0.1), (1.25, -3.5), angle)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


def _pair(rng, k):
    """Two polygons of the narrow phase's layout: a box and a rotated
    rounded hexagon (k = 0), or two boxes (k = 1), posed to overlap."""
    a = jg.box(1.0, 0.5)
    b = (jg.polygon([(np.cos(t), np.sin(t)) for t in
                     np.linspace(0, 2 * np.pi, 6, endpoint=False)], 0.05)
         if k == 0 else jg.box(0.4, 0.4))
    lo = 0.8 if k == 0 else 0.3
    p_b = np.float32([rng.uniform(-0.8, 0.8), rng.uniform(lo, lo + 0.5)])
    t = rng.uniform(-np.pi, np.pi)
    q_b = np.float32([np.cos(t), np.sin(t)])
    return (a.verts, a.normals, np.int32(a.count), np.float32(a.radius),
            np.float32([0.0, 0.0]), np.float32([1.0, 0.0]),
            b.verts, b.normals, np.int32(b.count), np.float32(b.radius),
            p_b, q_b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collide_polygons_matches_jax(seed):
    args = _pair(np.random.default_rng(seed), seed % 2)
    want = jm.collide_polygons(*(jnp.asarray(a) for a in args))
    got = tm.collide_polygons(*(torch.from_numpy(np.array(a))
                                for a in args))
    assert tm.Manifold._fields == jm.Manifold._fields
    assert int(want.point_count) > 0
    for name, g, w in zip(tm.Manifold._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("gravity, radius, dt", [
    ((0.0, -10.0), 0.05, 1 / 60), (-9.8, 0.1, 1 / 60), (0.0, 0.05, 1 / 60),
    ((3.0, -4.0), 0.01, 1 / 30), ((0.0, -10.0), 0.0, 1 / 60),
    ((0.0, -10.0), 0.05, 0.0)])
def test_particle_iterations_match_jax(gravity, radius, dt):
    assert (tparticles.calculate_reasonable_particle_iterations(
        gravity, radius, dt)
        == jparticles.calculate_reasonable_particle_iterations(
            gravity, radius, dt))


@pytest.mark.parametrize("name", ["QueryFilter", "ExplosionDef"])
def test_structs_match_jax(name):
    want, got = getattr(jtypes, name)(), getattr(ttypes, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert name in ttypes.__all__
