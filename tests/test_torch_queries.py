"""Scene queries: the port against the JAX package.

One world, port_fixtures.query_scene (a shape of every geometry: ground
box, open chain, segment, circle, capsule, box, 8-gon, rounded triangle,
rounded box, a sensor and a box with filter category 2), is stepped 12
times by the port; then one box's body is disabled and one shape
destroyed. The same state, carried across with state_to_numpy, goes
through each JAX query (jitted once, vmapped over one batch of queries)
and through the port's query on the whole batch at once. The batches are
made from a numpy seed and hold rays that start inside shapes, rays that
graze a vertex, more hits than max_hits, points inside and outside every
shape, and mover poses touching fewer shapes than max_planes. Discrete
outputs (hit flags, shape ids, masks, counts, plane validity) must match
exactly, floats to 1e-5. The particle anti-tunnel ray of a world with
other shapes than polygons is held to the JAX package's branch on lanes
of every shape type (the clamped step dt * v, as v carries inv_dt).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import api as japi
from box2d_tpu import geometry as jg
from box2d_tpu import particles as jparticles
from box2d_tpu import queries as jq
from box2d_tpu import types as jt
from box2d_tpu_torch import api as tapi
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch import particles as tparticles
from box2d_tpu_torch import queries as tq
from box2d_tpu_torch import types as tt
from box2d_tpu_torch.state import state_to_numpy
from port_fixtures import query_scene
from test_torch_phases import to_jax_state

torch.set_num_threads(1)

ATOL = 1e-5
R = 96          # rays, points and mover poses in a batch
MAX_HITS = 3    # fewer than the hits of the longest rays


@pytest.fixture(scope="module")
def scene():
    tw = query_scene(tapi.World, tt, tg, device="cpu")
    tw.compile()
    tw.run(12)
    # a disabled body and a destroyed shape must drop out of every query
    tw.set_body_enabled(4, False)          # the 8-gon's body
    tw.destroy_shape(9)                    # the rounded box
    jw = query_scene(japi.World, jt, jg)
    template, _ = jw.builder.build()
    js = to_jax_state(template, state_to_numpy(tw.state))
    return tw.state, js


def _rays():
    rng = np.random.default_rng(7)
    o = rng.uniform([-12.0, -1.0], [12.0, 6.0], (R, 2))
    d = rng.uniform([-20.0, -8.0], [20.0, 8.0], (R, 2))
    # starts inside the ground box, the box and the circle
    o[:3] = [(0.0, -0.5), (0.0, 0.5), (-4.0, 1.0)]
    # long horizontal rays through every shape (more hits than MAX_HITS)
    o[3:6] = [(-15.0, 0.5), (-15.0, 0.35), (15.0, 0.3)]
    d[3:6] = [(30.0, 0.0), (30.0, 0.0), (-30.0, 0.0)]
    return o.astype(np.float32), d.astype(np.float32)


def _graze(state):
    """Rays from above through a vertex of the box (shape 6) along one of
    its edges, and along the ground's top face."""
    b = state.bodies
    sh = state.shapes
    lane = int(sh.body[6])
    c, s = b.rot[lane].numpy()
    v = sh.verts[6, :4].numpy()
    origin = b.origin[lane].numpy()
    wv = v @ np.array([[c, s], [-s, c]], np.float32) + origin
    o = np.stack([wv[0] + (wv[0] - wv[1]), wv[2] + (wv[2] - wv[1]),
                  (-15.0, 0.0)]).astype(np.float32)
    d = np.stack([2.0 * (wv[1] - wv[0]), 2.0 * (wv[1] - wv[2]),
                  (30.0, 0.0)]).astype(np.float32)
    return o, d


def _check(a, b, name, atol=ATOL):
    a = np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


def _check_tuple(port, ref, name):
    for f, a, b in zip(ref._fields, port, ref):
        _check(a, b, f"{name}.{f}")


@pytest.fixture(scope="module")
def rays(scene):
    """The ray batch and both JAX casts of it, from one compile (the two
    share their per-shape casts)."""
    ts, js = scene
    o, d = _rays()
    go, gd = _graze(ts)
    o = np.concatenate([o, go])
    d = np.concatenate([d, gd])
    ref = jax.jit(jax.vmap(lambda a, b: (
        jq.cast_ray_closest(js, a, b), jq.cast_ray_all(js, a, b, MAX_HITS))))(
        jnp.asarray(o), jnp.asarray(d))
    return o, d, dict(zip(("closest", "all"), ref))


@pytest.mark.parametrize("kind", ["closest", "all"])
def test_world_ray_casts_match_jax(scene, rays, kind):
    ts, _ = scene
    o, d, ref = rays
    if kind == "closest":
        port = tq.cast_ray_closest(ts, o, d)
        assert int(port.hit.sum()) > R // 4
    else:
        port = tq.cast_ray_all(ts, o, d, MAX_HITS)
        # the long rays cross more shapes than MAX_HITS
        full = tq.cast_ray_all(ts, o[3:6], d[3:6], 16)
        assert (full.count > MAX_HITS).all()
    _check_tuple(port, ref[kind], kind)
    # one unbatched ray gives the first row of the batch
    one = (tq.cast_ray_closest(ts, o[0], d[0]) if kind == "closest"
           else tq.cast_ray_all(ts, o[0], d[0], MAX_HITS))
    for a, b in zip(one, port):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)


@pytest.mark.parametrize("family", ["analytic", "local"])
def test_local_ray_casts_match_jax(scene, family):
    """The per-geometry casts on (ray, shape) lanes of every shape type:
    the closed-form dispatch (circle, capsule, segment, chain segment,
    sharp polygon; rounded polygons as their core) and the full dispatch
    (rounded shapes through the shape cast), from starts inside shapes
    and from outside."""
    ts, js = scene
    sh = ts.shapes
    S = sh.type.shape[0]
    rng = np.random.default_rng(3)
    o = rng.uniform(-1.0, 1.0, (S, 8, 2)).astype(np.float32)
    d = rng.uniform(-3.0, 3.0, (S, 8, 2)).astype(np.float32)
    o[:, 0] = 0.0          # the local origin: inside every solid shape
    cols = [x[:S] for x in (sh.type, sh.verts, sh.normals, sh.count,
                            sh.radius)]
    jcols = [jnp.asarray(c.numpy()) for c in cols]
    lanes = [c.repeat_interleave(8, dim=0) for c in cols]
    lo = torch.from_numpy(o.reshape(-1, 2))
    ld = torch.from_numpy(d.reshape(-1, 2))
    if family == "analytic":
        ref = jax.jit(jax.vmap(jax.vmap(
            lambda p, q, st, v, n, c, r: jq.ray_shape_analytic(
                p, q, jnp.float32(1.0), st, v, n, c, r),
            in_axes=(0, 0, None, None, None, None, None))))(
            jnp.asarray(o), jnp.asarray(d), *jcols)
        port = tq.ray_shape_analytic(lo, ld, 1.0, *lanes)
    else:
        ref = jax.jit(jax.vmap(jax.vmap(
            lambda p, q, st, v, n, c, r: jq._ray_shape_local(
                p, q, jnp.float32(1.0), st, v, n, c, r),
            in_axes=(0, 0, None, None, None, None, None))))(
            jnp.asarray(o), jnp.asarray(d), *jcols)
        fam = tq._ray_family(cols[0].numpy(), cols[4].numpy())
        fam = np.repeat(fam, 8)
        port = [torch.zeros(lo.shape[0], dtype=torch.bool),
                torch.zeros(lo.shape[0]), torch.zeros_like(lo),
                torch.zeros_like(lo)]
        for f in range(4):
            idx = torch.from_numpy(np.nonzero(fam == f)[0])
            if idx.numel() == 0:
                continue
            out = tq._ray_shape_local(f, lo[idx], ld[idx], 1.0,
                                      *[c[idx] for c in lanes])
            for full, part in zip(port, out):
                full[idx] = part
    ref = [np.array(b).reshape((-1,) + np.asarray(b).shape[2:])
           for b in ref]
    _check(port[0], ref[0], "hit")
    _check(port[1], ref[1], "fraction")
    # a missed segment's point is p1 + t d at an unbounded t: the two
    # roundings of an ill-conditioned miss differ, and no caller reads it
    hit = ref[0]
    _check(port[2][hit], ref[2][hit], "point")
    _check(port[3][hit], ref[3][hit], "normal")
    assert hit.any() and not hit.all()


def test_overlap_point_and_aabb_match_jax(scene):
    ts, js = scene
    rng = np.random.default_rng(11)
    pts = rng.uniform([-11.0, -1.0], [11.0, 6.0], (R, 2)).astype(np.float32)
    # body centers: inside their shapes
    pts[:9] = ts.bodies.center.numpy()
    ref = jax.jit(jax.vmap(lambda p: jq.overlap_point(js, p)))(
        jnp.asarray(pts))
    port = tq.overlap_point(ts, pts)
    _check(port, ref, "overlap_point")
    assert port.any()
    _check(tq.overlap_point(ts, pts[0]), np.asarray(ref)[0], "one point")
    boxes = np.array([(-12.0, -2.0, 12.0, 7.0), (-5.0, 0.0, 1.0, 2.0),
                      (3.0, 0.0, 7.0, 3.0), (20.5, 0.0, 22.0, 1.0)],
                     np.float32)
    ref = jax.jit(jax.vmap(lambda a: jq.overlap_aabb(js, a)))(
        jnp.asarray(boxes))
    port = torch.stack([tq.overlap_aabb(ts, a) for a in boxes])
    _check(port, ref, "overlap_aabb")
    # the filter: category 2 only sees the filtered box
    _check(tq.overlap_aabb(ts, boxes[0], category_bits=2, mask_bits=2),
           jq.overlap_aabb(js, jnp.asarray(boxes[0]), category_bits=2,
                           mask_bits=2), "overlap_aabb filtered")


def _box_proxy():
    gm = tg.box(0.5, 0.5)
    return gm.verts.astype(np.float32), int(gm.count), float(gm.radius)


def test_shape_queries_match_jax(scene):
    """overlap_shape and cast_shape_closest with a 1 m box at poses that
    overlap several shapes, one, and none."""
    ts, js = scene
    verts, count, radius = _box_proxy()
    pos = np.array([(0.0, 1.0), (-4.0, 1.2), (2.0, 3.5), (0.0, 9.0),
                    (-6.0, 1.0), (5.0, 1.0)], np.float32)
    ang = np.array([0.0, 0.3, -0.2, 0.0, 0.5, 1.0])
    rot = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    trans = np.array([(0.0, -3.0), (6.0, 0.0), (0.0, -4.0), (0.0, 2.0),
                      (3.0, -1.0), (-8.0, -0.5)], np.float32)
    jv = jnp.asarray(verts)
    ref_o = jax.jit(jax.vmap(lambda p, q: jq.overlap_shape(
        js, jv, count, radius, p, q)))(jnp.asarray(pos), jnp.asarray(rot))
    ref_c = jax.jit(jax.vmap(lambda p, q, tr: jq.cast_shape_closest(
        js, jv, count, radius, p, q, tr)))(
        jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(trans))
    port_o = torch.stack([tq.overlap_shape(ts, verts, count, radius, p, q)
                          for p, q in zip(pos, rot)])
    casts = [tq.cast_shape_closest(ts, verts, count, radius, p, q, tr)
             for p, q, tr in zip(pos, rot, trans)]
    port_c = tq.RayResult(*(torch.stack(x) for x in zip(*casts)))
    _check(port_o, ref_o, "overlap_shape")
    _check_tuple(port_c, ref_c, "cast_shape_closest")
    assert port_o.any(1).sum() >= 3 and port_c.hit.any()
    assert not port_c.hit.all()


def test_explode_matches_jax(scene):
    ts, js = scene
    kw = dict(position=(-1.0, 0.6), radius=4.0, impulse_per_length=3.0)
    fn = jax.jit(lambda fo: jq.explode(js, falloff=fo, **kw))
    for falloff in (0.0, 2.5):
        port = tq.explode(ts, falloff=falloff, **kw)
        ref = fn(jnp.float32(falloff))
        _check(port.bodies.v, ref.bodies.v, f"v falloff={falloff}")
        _check(port.bodies.w, ref.bodies.w, f"w falloff={falloff}")
        assert not torch.equal(port.bodies.v, ts.bodies.v)
    # the state it was given is not changed
    np.testing.assert_array_equal(ts.bodies.v.numpy(),
                                  np.asarray(js.bodies.v))


def _mover_poses():
    """Capsule movers (p1, p2, radius) against the ground, between shapes
    and in free space: most touch fewer shapes than max_planes, where the
    order of the unused planes is lax.top_k's."""
    xs = np.linspace(-9.0, 9.0, 16, dtype=np.float32)
    p1 = np.stack([xs, np.full_like(xs, 0.55)], 1)
    p2 = np.stack([xs, np.full_like(xs, 1.4)], 1)
    p1[-1] = (0.0, 12.0)
    p2[-1] = (0.5, 12.0)
    return p1, p2


def test_mover_matches_jax(scene):
    ts, js = scene
    p1, p2 = _mover_poses()
    radius = 0.6
    ref = jax.jit(jax.vmap(lambda a, b: jq.collide_mover(
        js, a, b, radius, max_planes=4)))(jnp.asarray(p1), jnp.asarray(p2))
    outs = [tq.collide_mover(ts, a, b, radius, max_planes=4)
            for a, b in zip(p1, p2)]
    port = [torch.stack(x) for x in zip(*outs)]
    for name, a, b in zip(("normals", "offsets", "valid"), port, ref):
        _check(a, b, f"collide_mover.{name}")
    valid = port[2]
    assert valid.any() and (valid.sum(1) < 4).all() and (
        valid.sum(1) == 0).any()

    # solve_planes / clip_vector on those planes, and the cast
    delta = np.array([0.3, -0.2], np.float32)
    limits = np.full(4, 1e3, np.float32)
    clip = np.array([True, False, True, True])
    j_solve = jax.jit(jax.vmap(lambda n, off, v: jq.solve_planes(
        jnp.asarray(delta), n, off, jnp.asarray(limits), v)))
    ref_d, ref_push = j_solve(*ref)
    j_clip = jax.jit(jax.vmap(lambda n, push, v: jq.clip_vector(
        jnp.asarray(delta), n, push, jnp.asarray(clip), v)))
    ref_v = j_clip(ref[0], ref_push, ref[2])
    lim_t = torch.from_numpy(limits)
    clip_t = torch.from_numpy(clip)
    for i in range(len(p1)):
        n, off, v = (x[i] for x in port)
        dl, push = tq.solve_planes(delta, n, off, lim_t, v)
        _check(dl, np.asarray(ref_d)[i], f"solve_planes delta {i}")
        _check(push, np.asarray(ref_push)[i], f"solve_planes push {i}")
        _check(tq.clip_vector(delta, n, push, clip_t, v),
               np.asarray(ref_v)[i], f"clip_vector {i}")
    trans = np.array([3.0, -0.4], np.float32)
    ref_f = jax.jit(jax.vmap(lambda a, b: jq.cast_mover(
        js, a, b, 0.5, jnp.asarray(trans))))(jnp.asarray(p1),
                                             jnp.asarray(p2))
    port_f = torch.stack([tq.cast_mover(ts, a, b, 0.5, trans)
                          for a, b in zip(p1, p2)])
    _check(port_f, ref_f, "cast_mover")
    assert (port_f < 1.0).any() and (port_f == 1.0).any()


def test_particle_tunnel_ray_matches_jax(scene):
    """The anti-tunnel ray of a world with circles, capsules, segments,
    chains and polygons (box2d_tpu/particles.py:1697-1715): particles
    above, beside and inside the shapes, moving fast enough to cross
    them."""
    ts, js = scene
    rng = np.random.default_rng(5)
    n = 160
    pos = rng.uniform([-11.0, -0.8], [11.0, 5.0], (n, 2)).astype(np.float32)
    vel = rng.uniform([-300.0, -300.0], [300.0, 120.0],
                      (n, 2)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::9] = False
    S = ts.shapes.type.shape[0]
    live = (ts.shapes.enabled & ~ts.shapes.is_sensor).numpy()
    bs_idx = np.where(live, np.arange(S), 0).astype(np.int32)
    bs_valid = live
    types_present = frozenset(int(x) for x in ts.shapes.type.numpy())
    dt, inv_dt = 1.0 / 240.0, 240.0
    pt = types.SimpleNamespace(alive=jnp.asarray(alive))
    ref = jax.jit(lambda p, v: jparticles._solve_collision(
        pt, p, v, js, jnp.asarray(bs_idx), jnp.asarray(bs_valid),
        jnp.float32(dt), jnp.float32(inv_dt), None,
        geom_types=types_present))(jnp.asarray(pos), jnp.asarray(vel))
    sh, b = ts.shapes, ts.bodies
    idx = torch.from_numpy(bs_idx).long()
    body = sh.body[idx].long()
    port = tparticles._tunnel_analytic(
        torch.from_numpy(pos), torch.from_numpy(vel), dt, inv_dt,
        torch.from_numpy(alive), torch.from_numpy(bs_valid),
        b.origin[body], b.rot[body], sh.type[idx], sh.verts[idx],
        sh.normals[idx], sh.count[idx], sh.radius[idx], types_present)
    # the clamped step dt * v (v itself carries inv_dt = 240)
    _check(port * dt, np.asarray(ref) * dt, "clamped step")
    changed = (port != torch.from_numpy(vel)).any(1)
    assert changed.sum() > n // 10
