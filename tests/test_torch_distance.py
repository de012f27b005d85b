"""GJK, the shape cast and time of impact: the port against the JAX package.

One batch of 64 lanes, made from a numpy seed, goes through the JAX
functions (each jitted and vmapped once, at this one shape) and through
the port's lane-batched functions: circle, capsule, box, thin wall and
8-gon proxies, separated, touching, overlapping and with parallel edges,
and sweeps that spin. Discrete outputs (simplex count and indices, GJK
iterations, hit flags, TOI states) must match exactly, floats to 1e-5.
The port's TOI is also held to the numpy dense-scan oracle of
tests/test_continuous.py, which needs no JAX compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from box2d_tpu import distance as jd
from box2d_tpu_torch import distance as td
from box2d_tpu_torch import geometry as tg
from box2d_tpu_torch.constants import LINEAR_SLOP

torch.set_num_threads(1)

N = 64
ATOL = 1e-5


def _proxies():
    """(verts (8, 2), count, radius) of each proxy kind."""
    octagon = [(0.4 * np.cos(a), 0.4 * np.sin(a))
               for a in np.arange(8) * np.pi / 4 + 0.1]
    geoms = [tg.circle((0.0, 0.0), 0.2), tg.capsule((-0.3, 0.0), (0.3, 0.0),
                                                    0.1),
             tg.box(0.5, 0.5), tg.box(0.05, 2.0), tg.polygon(octagon),
             tg.polygon([(-0.3, -0.2), (0.3, -0.2), (0.3, 0.2), (-0.3, 0.2)],
                        radius=0.05)]
    return [(gm.verts.astype(np.float32), int(gm.count), float(gm.radius))
            for gm in geoms]


def _rot(a):
    return np.array([np.cos(a), np.sin(a)], np.float32)


@pytest.fixture(scope="module")
def lanes():
    """64 lanes: explicit touching / parallel-edge / overlapping cases,
    then random pairs at random offsets, with casts and spinning sweeps."""
    rng = np.random.RandomState(11)
    prox = _proxies()
    L = {k: [] for k in ("va", "ca", "ra", "vb", "cb", "rb", "pa", "qa",
                         "pb", "qb", "tr", "enc", "sa", "sb")}

    def add(ia, ib, pa, aa, pb, ab, tr, enc=False, spin=0.0):
        for key, (v, c, r) in (("a", prox[ia]), ("b", prox[ib])):
            L["v" + key].append(v)
            L["c" + key].append(c)
            L["r" + key].append(r)
        L["pa"].append(np.asarray(pa, np.float32))
        L["qa"].append(_rot(aa))
        L["pb"].append(np.asarray(pb, np.float32))
        L["qb"].append(_rot(ab))
        L["tr"].append(np.asarray(tr, np.float32))
        L["enc"].append(enc)
        lc_b = rng.uniform(-0.05, 0.05, 2).astype(np.float32)
        # sweep A: static or slow; sweep B: the cast's motion, spinning
        L["sa"].append(np.concatenate([
            np.zeros(2), pa, np.asarray(pa) + rng.uniform(-0.1, 0.1, 2),
            _rot(aa), _rot(aa + rng.uniform(-0.2, 0.2))]).astype(np.float32))
        L["sb"].append(np.concatenate([
            lc_b, pb, np.asarray(pb) + np.asarray(tr), _rot(ab),
            _rot(ab + spin)]).astype(np.float32))

    # box faces touching and parallel, box faces overlapping, circle and
    # capsule touching a box face, a box corner on a box face
    add(2, 2, (0, 0), 0.0, (1.0, 0.0), 0.0, (-1.0, 0.0))
    add(2, 2, (0, 0), 0.0, (1.0, 0.3), 0.0, (-2.0, 0.0))
    add(2, 2, (0, 0), 0.0, (1.3, 0.2), 0.0, (-1.0, 0.0), spin=0.5)
    add(2, 2, (0, 0), 0.0, (0.8, 0.1), 0.0, (-0.5, 0.1))
    add(2, 0, (0, 0), 0.0, (0.7, 0.0), 0.0, (-1.0, 0.0))
    add(2, 1, (0, 0), 0.0, (0.0, 0.6), 0.0, (0.0, -1.0))
    add(2, 2, (0, 0), 0.0, (1.0, 1.0), np.pi / 4, (-2.0, -2.0), spin=1.0)
    add(3, 4, (0, 0), 0.0, (-3.0, 0.5), 0.3, (6.0, 0.0), spin=2.0)
    add(3, 0, (0, 0), 0.0, (-3.0, 0.0), 0.0, (6.0, 0.0))
    add(4, 4, (0, 0), 0.2, (0.9, 0.0), 0.2, (0.5, 0.0), enc=True)
    add(5, 2, (0, 0), 0.0, (0.0, 0.75), 0.0, (0.0, -1.0), enc=True)
    add(1, 1, (0, 0), 0.0, (0.0, 0.2), 0.0, (0.0, -0.5))
    while len(L["pa"]) < N:
        ia, ib = rng.randint(0, len(prox), 2)
        pa = rng.uniform(-1, 1, 2)
        direction = rng.uniform(-np.pi, np.pi)
        dist = rng.choice([0.2, 0.6, 1.0, 1.5, 3.0])
        pb = pa + dist * np.array([np.cos(direction), np.sin(direction)])
        tr = -(pb - pa) * rng.uniform(0.3, 2.5) + rng.uniform(-0.5, 0.5, 2)
        add(ia, ib, pa, rng.uniform(-np.pi, np.pi), pb,
            rng.uniform(-np.pi, np.pi), tr, enc=bool(rng.randint(2)),
            spin=rng.uniform(-3.0, 3.0))
    out = {}
    for k, v in L.items():
        dt = (np.int32 if k in ("ca", "cb") else bool if k == "enc"
              else np.float32)
        out[k] = np.stack([np.asarray(x, dt) for x in v])
    return out


def _sweep(mod, s, conv):
    return mod.Sweep(conv(s[..., 0:2]), conv(s[..., 2:4]), conv(s[..., 4:6]),
                     conv(s[..., 6:8]), conv(s[..., 8:10]))


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def check(name, ref, out, atol=ATOL):
    for field, a, b in zip(ref._fields, ref, out):
        a = np.asarray(a)
        b = b.cpu().numpy()
        assert a.shape == b.shape, (name, field, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{field}")
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                       err_msg=f"{name}.{field}")


def _args(L, conv, keys):
    return [conv(L[k]) for k in keys]


PROXY = ("va", "ca", "ra", "vb", "cb", "rb", "pa", "qa", "pb", "qb")


@pytest.mark.parametrize("use_radii", [False, True])
def test_shape_distance_matches_jax(lanes, use_radii):
    fn = jax.jit(jax.vmap(lambda *a: jd.shape_distance(
        *a, use_radii=use_radii)))
    ref = fn(*_args(lanes, jnp.asarray, PROXY))
    out = td.shape_distance(*_args(lanes, _torch, PROXY),
                            use_radii=use_radii)
    check("shape_distance", ref, out)
    counts = np.asarray(ref.cache_count)
    assert (counts == 3).any() and (counts == 2).any() and (
        counts == 1).any()
    dist = np.asarray(ref.distance)
    assert (dist == 0).any() and (dist > 0.5).any()


def test_shape_distance_active_mask(lanes):
    """Lanes outside `active` are left frozen; the others are unchanged."""
    args = _args(lanes, _torch, PROXY)
    full = td.shape_distance(*args)
    act = torch.arange(N) % 3 == 0
    part = td.shape_distance(*args, active=act)
    for a, b in zip(full, part):
        assert torch.equal(a[act], b[act])
    assert (part.iterations[~act] == 0).all()


def test_shape_cast_matches_jax(lanes):
    keys = PROXY + ("tr",)
    fn = jax.jit(jax.vmap(lambda *a: jd.shape_cast_pair(
        *a[:-1], jnp.float32(1.0), can_encroach=a[-1])))
    ref = fn(*_args(lanes, jnp.asarray, keys + ("enc",)))
    out = td.shape_cast_pair(*_args(lanes, _torch, keys), 1.0,
                             can_encroach=_torch(lanes["enc"]))
    check("shape_cast_pair", ref, out)
    hit = np.asarray(ref.hit)
    frac = np.asarray(ref.fraction)
    assert hit.sum() >= 10 and (~hit).sum() >= 5
    assert ((frac > 0) & hit).any() and ((frac == 0) & hit).any()


def test_time_of_impact_matches_jax(lanes):
    def jax_toi(va, ca, ra, sa, vb, cb, rb, sb):
        return jd.time_of_impact(va, ca, ra, _sweep(jd, sa, lambda x: x),
                                 vb, cb, rb, _sweep(jd, sb, lambda x: x),
                                 jnp.float32(1.0))

    keys = ("va", "ca", "ra", "sa", "vb", "cb", "rb", "sb")
    ref = jax.jit(jax.vmap(jax_toi))(*_args(lanes, jnp.asarray, keys))
    va, ca, ra, sa, vb, cb, rb, sb = _args(lanes, _torch, keys)
    out = td.time_of_impact(va, ca, ra, _sweep(td, sa, lambda x: x),
                            vb, cb, rb, _sweep(td, sb, lambda x: x), 1.0)
    check("time_of_impact", ref, out)
    states = set(np.asarray(ref.state).tolist())
    assert {td.TOI_HIT, td.TOI_SEPARATED, td.TOI_OVERLAPPED} <= states


def _np_poly_distance_scan(va, vb):
    """Distance (T,) between the convex polygons va (T, n, 2) and vb
    (m, 2), 0 where they overlap: the independent numpy polygon distance of
    tests/test_continuous.py (an SAT overlap test, then the least
    vertex-to-edge distance across both), over T poses at once."""
    vb = np.broadcast_to(vb, (va.shape[0],) + vb.shape)

    def axes(poly):
        e = np.roll(poly, -1, axis=1) - poly
        ax = np.stack([e[..., 1], -e[..., 0]], -1)
        return ax / np.linalg.norm(ax, axis=-1, keepdims=True)

    ax = np.concatenate([axes(va), axes(vb)], axis=1)       # (T, k, 2)
    pa = np.einsum("tnd,tkd->tkn", va, ax)
    pb = np.einsum("tnd,tkd->tkn", vb, ax)
    separated = ((pb.min(-1) >= pa.max(-1) - 1e-12)
                 | (pa.min(-1) >= pb.max(-1) - 1e-12)).any(-1)

    def vert_edge(verts, poly):
        a = poly[:, None, :, :]
        e = np.roll(poly, -1, axis=1)[:, None] - a
        p = verts[:, :, None, :]
        tt = np.clip(((p - a) * e).sum(-1)
                     / np.maximum((e * e).sum(-1), 1e-30), 0.0, 1.0)
        return np.linalg.norm(p - (a + tt[..., None] * e),
                              axis=-1).min(axis=(1, 2))

    return np.where(separated, np.minimum(vert_edge(va, vb),
                                          vert_edge(vb, va)), 0.0)


def test_toi_vs_dense_scan_oracle():
    """The port's TOI against an independent dense time scan (the oracle of
    tests/test_continuous.py::test_toi_vs_dense_scan_oracle, with its scan
    vectorized over the samples): a spinning box flying at a thin wall, 40
    sweeps in one batch."""
    rng = np.random.RandomState(7)
    box_a = np.array([[-0.1, -0.1], [0.1, -0.1], [0.1, 0.1], [-0.1, 0.1]])
    wall = np.array([[-0.02, -1.0], [0.02, -1.0], [0.02, 1.0], [-0.02, 1.0]])
    pad = lambda v: np.vstack([v, np.repeat(v[-1:], 8 - len(v), 0)])
    cases = []
    for _ in range(40):
        x0 = -3.0 + rng.uniform(-0.5, 0.5)
        y0 = rng.uniform(-1.6, 1.6)
        vx = rng.uniform(3.0, 8.0)
        vy = rng.uniform(-1.0, 1.0)
        rng.uniform(0, 1.0)
        c1 = np.array([x0, y0])
        c2 = c1 + np.array([vx, vy])
        a2 = rng.uniform(-0.6, 0.6)
        cases.append((c1, c2, np.array([1.0, 0.0]),
                      np.array([np.cos(a2), np.sin(a2)])))
    n = len(cases)
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    z = torch.zeros(n, 2)
    ident = f([[1.0, 0.0]] * n)
    sweep_w = td.Sweep(z, z, z, ident, ident)
    sweep_a = td.Sweep(z, f([c[0] for c in cases]), f([c[1] for c in cases]),
                       f([c[2] for c in cases]), f([c[3] for c in cases]))
    out = td.time_of_impact(
        f([pad(wall)] * n), torch.full((n,), 4), torch.zeros(n), sweep_w,
        f([pad(box_a)] * n), torch.full((n,), 4), torch.zeros(n), sweep_a,
        1.0)
    target = max(LINEAR_SLOP, 0.0 - LINEAR_SLOP)
    ts = np.linspace(0.0, 1.0, 4001)
    hits = misses = 0
    for k, (c1, c2, q1, q2) in enumerate(cases):
        # GetSweepTransform (ref src/Distance.cs:8-18) at every sample
        p = (1.0 - ts[:, None]) * c1 + ts[:, None] * c2
        q = (1.0 - ts[:, None]) * q1 + ts[:, None] * q2
        q = q / np.hypot(q[:, 0], q[:, 1])[:, None]
        rot = np.stack([np.stack([q[:, 0], -q[:, 1]], -1),
                        np.stack([q[:, 1], q[:, 0]], -1)], 1)
        va = np.einsum("tij,nj->tni", rot, box_a) + p[:, None, :]
        close = _np_poly_distance_scan(va, wall) <= target
        first = ts[np.argmax(close)] if close.any() else None
        state = int(out.state[k])
        frac = float(out.fraction[k])
        if first is None:
            assert state != td.TOI_HIT or frac >= 0.999, (k, state, frac)
            misses += 1
        else:
            assert state in (td.TOI_HIT, td.TOI_OVERLAPPED), (k, state)
            assert first - 0.02 <= frac <= first + 1e-3, (k, frac, first)
            hits += 1
    assert hits >= 10 and misses >= 3, (hits, misses)
