"""Chain and segment shapes: the port against the JAX package.

- The two one-sided chain manifolds on one batch of lanes made from a
  numpy seed: segments of a zigzag chain (convex and concave ghosts)
  against circles, capsules, boxes, rounded boxes and 8-gons on both sides
  of the segment, inside and past its ends. The JAX functions are jitted
  and vmapped once each.
- `create_chain`: the shape lanes and ghosts of a loop (n segments) and of
  an open chain (n - 3), from both builders.
- One narrow phase on the chain-loop ground of
  port_fixtures.chain_sensor_scene with circles, capsules and boxes
  resting on it, warmed by the port.
Discrete outputs exact, floats to 1e-5. The JAX chain-polygon manifold
masks eight support lanes, so it is run with eight vertex lanes (the
port's runs at any width; the narrow phase is also checked at the
scene's own width of four). Where a polygon's centroid lies on the
segment's line, a side test turns on the last bit, and XLA's
CPU backend fuses multiply-adds where the port does not: the port is held
on every lane to the JAX function compiled without FMA
(--xla_cpu_max_isa=AVX, in a subprocess), and to the default compile on
every lane where the reference's two roundings agree.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import broadphase as jbp
from box2d_tpu import geometry as jg
from box2d_tpu import manifold as jmf
from box2d_tpu import narrowphase as jnarrow
from box2d_tpu import types as jt
from box2d_tpu.builder import WorldBuilder as JBuilder
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import manifold as tmf
from box2d_tpu_torch import narrowphase as tnarrow
from box2d_tpu_torch import types as tt
from box2d_tpu_torch.builder import WorldBuilder as TBuilder
from box2d_tpu_torch.state import state_to_numpy
from box2d_tpu_torch.world import StepStats, _step_work
from port_fixtures import chain_sensor_scene
from test_torch_phases import _to_jax_tuple, check

torch.set_num_threads(1)

N = 96
ZIGZAG = [(4.0, 0.0), (2.0, 0.0), (1.0, 0.6), (0.0, 0.0), (-1.0, -0.4),
          (-2.5, 0.0), (-4.0, 0.0)]


def _rot(a):
    return np.array([np.cos(a), np.sin(a)], np.float32)


@pytest.fixture(scope="module")
def lanes():
    """Chain segments of ZIGZAG (an open chain: four segments) against
    proxies placed along and past each segment, on both sides of it."""
    rng = np.random.RandomState(5)
    segs = [tg.chain_segment(ZIGZAG[i + 1], ZIGZAG[i + 2], ZIGZAG[i],
                             ZIGZAG[i + 3]) for i in range(len(ZIGZAG) - 3)]
    octagon = [(0.3 * np.cos(a), 0.3 * np.sin(a))
               for a in np.arange(8) * np.pi / 4]
    others = [tg.circle((0.0, 0.0), 0.2), tg.capsule((-0.3, 0.0),
                                                     (0.3, 0.0), 0.1),
              tg.box(0.4, 0.25), tg.polygon(octagon),
              tg.polygon([(-0.3, -0.2), (0.3, -0.2), (0.3, 0.2),
                          (-0.3, 0.2)], radius=0.05)]
    L = {k: [] for k in ("p1", "p2", "g1", "g2", "pa", "qa", "vb", "nb",
                         "cb", "rb", "pb", "qb", "circle")}
    for i in range(N):
        if i < 6:
            # a circle or an 8-gon's vertex just above the convex peak
            # ZIGZAG[2], the end of segment 0 (vertex regions)
            s = segs[0]
            o = others[0] if i % 2 else others[3]
            pa, qa, qb = np.zeros(2), _rot(0.0), _rot(0.0)
            pb = np.array([1.0, 0.6 + float(o.radius or 0.3)
                           + 0.01 * (i // 2)])
        else:
            s = segs[i % len(segs)]
            o = others[rng.randint(len(others))]
            e = s.verts[1] - s.verts[0]
            n = np.array([e[1], -e[0]]) / np.linalg.norm(e)  # right_perp
            along = rng.uniform(-0.4, 1.4)
            off = rng.choice([-0.5, -0.15, 0.0, 0.2, 0.3, 0.35, 0.4, 0.5,
                              0.9])
            pa = rng.uniform(-0.5, 0.5, 2)
            qa = _rot(rng.uniform(-0.3, 0.3))
            local = s.verts[0] + along * e + off * n
            pb = pa + np.array([qa[0] * local[0] - qa[1] * local[1],
                                qa[1] * local[0] + qa[0] * local[1]])
            qb = _rot(rng.uniform(-np.pi, np.pi))
        for key, v in (("p1", s.verts[0]), ("p2", s.verts[1]),
                       ("g1", s.ghost1), ("g2", s.ghost2), ("pa", pa),
                       ("qa", qa), ("vb", o.verts), ("nb", o.normals),
                       ("cb", o.count), ("rb", o.radius), ("pb", pb),
                       ("qb", qb), ("circle", o.count == 1)):
            L[key].append(v)
    return {k: np.stack([np.asarray(x, np.int32 if k == "cb" else bool
                                    if k == "circle" else np.float32)
                         for x in v]) for k, v in L.items()}


def _check_manifold(name, ref, out, rows):
    for field, a, b in zip(ref._fields, ref, out):
        a = np.asarray(a)[rows]
        b = b.numpy()[rows]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{field}")
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0,
                                       err_msg=f"{name}.{field}")


POLY_KEYS = ("p1", "p2", "g1", "g2", "pa", "qa", "vb", "nb", "cb", "rb",
             "pb", "qb")
_UNFUSED = """
import sys
import jax, jax.numpy as jnp, numpy as np
from box2d_tpu import manifold as jmf
src = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
a = [src[k] for k in ("p1", "p2", "g1", "g2", "pa", "qa")]
out = {"circle": jax.jit(jax.vmap(jmf.collide_chain_segment_circle))(
           *a, src["vb"][:, 0], src["rb"], src["pb"], src["qb"]),
       "polygon": jax.jit(jax.vmap(jmf.collide_chain_segment_polygon))(
           *a, src["vb"], src["nb"], src["cb"], src["rb"], src["pb"],
           src["qb"])}
np.savez(sys.argv[2], **{k + "." + f: np.asarray(v) for k, m in out.items()
                         for f, v in zip(m._fields, m)})
"""


@pytest.fixture(scope="module")
def unfused(lanes, tmp_path_factory):
    """Both JAX chain manifolds on `lanes`, compiled in a process whose XLA
    backend emits no FMA instructions."""
    tmp = tmp_path_factory.mktemp("chains")
    src, dst = tmp / "lanes.npz", tmp / "out.npz"
    np.savez(src, **lanes)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _UNFUSED, str(src), str(dst)],
                   env=env, cwd=here, check=True, timeout=600)
    got = np.load(dst)
    return {k: jmf.Manifold(*[got[f"{k}.{f}"] for f in jmf.Manifold._fields])
            for k in ("circle", "polygon")}


def _hold(name, ref, unfused, out, rows):
    """out equals the FMA-free reference on `rows`, and the default one
    where the reference's two roundings agree; returns the point counts."""
    _check_manifold(name, unfused, out, rows)
    agree = np.ones(N, bool)
    for a, b in zip(ref, unfused):
        a, b = np.asarray(a), np.asarray(b)
        agree &= (np.abs(a - b).reshape(N, -1) <= 1e-5).all(axis=1)
    assert (rows & ~agree).sum() <= 4, name
    _check_manifold(name, ref, out, rows & agree)
    return np.asarray(ref.point_count)[rows]


def test_chain_circle_manifold_matches_jax(lanes, unfused):
    keys = ("p1", "p2", "g1", "g2", "pa", "qa")
    J = lambda k: jnp.asarray(lanes[k])
    T = lambda k: torch.from_numpy(lanes[k])
    ref = jax.jit(jax.vmap(jmf.collide_chain_segment_circle))(
        *[J(k) for k in keys], J("vb")[:, 0], J("rb"), J("pb"), J("qb"))
    out = tmf.collide_chain_segment_circle(
        *[T(k) for k in keys], T("vb")[:, 0], T("rb"), T("pb"), T("qb"))
    count = _hold("chain_circle", ref, unfused["circle"], out,
                  np.ones(N, bool))
    assert (count[lanes["circle"]] == 1).sum() >= 3
    assert (count[lanes["circle"]] == 0).sum() >= 3


def test_chain_polygon_manifold_matches_jax(lanes, unfused):
    ref = jax.jit(jax.vmap(jmf.collide_chain_segment_polygon))(
        *[jnp.asarray(lanes[k]) for k in POLY_KEYS])
    out = tmf.collide_chain_segment_polygon(
        *[torch.from_numpy(lanes[k]) for k in POLY_KEYS])
    count = _hold("chain_polygon", ref, unfused["polygon"], out,
                  ~lanes["circle"])
    assert (count == 2).sum() >= 3 and (count == 1).sum() >= 1 and (
        count == 0).sum() >= 3


@pytest.mark.parametrize("loop", [True, False])
def test_create_chain_lanes_match_jax(loop):
    pts = ZIGZAG + ([(-4.0, 3.0), (4.0, 3.0)] if loop else [])
    states = []
    for B, t in ((JBuilder, jt), (TBuilder, tt)):
        b = B()
        body = b.create_body(t.BodyDef(type=t.STATIC))
        mat = [t.SurfaceMaterial(friction=0.3), t.SurfaceMaterial(
            friction=0.9, restitution=0.2)]
        ids = b.create_chain(body, t.ChainDef(
            points=pts, materials=mat, is_loop=loop,
            enable_sensor_events=True,
            filter=t.Filter(category_bits=2, group_index=-1)))
        assert ids == list(range(len(pts) if loop else len(pts) - 3))
        built = b.build() if B is JBuilder else b.build(device="cpu")
        states.append(state_to_numpy(built[0]))
    a, b = states
    for key in a:
        if key.startswith(("shapes.", "bodies.")):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


@pytest.fixture(scope="module")
def chain_world():
    """chain_sensor_scene after 80 port steps: the shapes at rest on the
    chain's floor and bump; the state and candidate pairs of the next
    step's narrow phase."""
    tw = chain_sensor_scene(tapi.World, tt, tg, device="cpu")
    tw.compile()
    tw.run(80)
    pairs, cache = _step_work(tw.state, 1 / 60, tw.capacity, tw._step.classes,
                              4, True, StepStats(), until="pairs")
    jw = chain_sensor_scene(japi.World, jt, jg)
    template, _ = jw.builder.build()
    return tw, dataclasses.replace(tw.state, contacts=cache), pairs, template


def test_narrow_phase_on_chain_loop_matches_jax(chain_world):
    from test_torch_phases import to_jax_state

    tw, state, pairs, template = chain_world
    classes = tw._step.classes
    assert {tnarrow.CLS_CHAIN_CIRCLE, tnarrow.CLS_CHAIN_POLY} <= classes
    jstate = to_jax_state(template, state_to_numpy(state))
    ref = jax.jit(lambda st, pr: jnarrow.narrow_phase(st, pr, classes, 8))(
        jstate, _to_jax_tuple(jbp.PairBuffer, pairs))
    out = tnarrow.narrow_phase(state, pairs, classes, 8)
    check("narrow", ref, out)
    # the port's chain classes at the scene's own width give the same
    out4 = tnarrow.narrow_phase(state, pairs, classes, tw.capacity.max_verts)
    check("narrow-4", out, out4, atol=1e-6)
    shape_type = state.shapes.type.numpy()
    chain_lane = (shape_type[out.shape_a.numpy()] == tg.CHAIN_SEGMENT)
    touching = out.manifold.point_count.numpy() > 0
    circle_b = shape_type[out.shape_b.numpy()] == tg.CIRCLE
    assert (touching & chain_lane & circle_b).sum() >= 2
    assert (touching & chain_lane & ~circle_b).sum() >= 3
