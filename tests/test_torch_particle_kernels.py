"""The particle kernels' twins (box2d_tpu_torch/particles_kernels.py)
against the JAX package's Pallas kernels, run in interpret mode.

K3 (`window_pass`): the twin against `particles_pallas.window_pass` on the
band layout (`build_tab`, `block_offsets`) and against the brute force of
tests/test_particles_pallas.py, for the three phases, at atol 2e-5 (the
JAX test's own bound; the sums run in another order). K4 (`rank_pass`):
the twin against `particles_pallas.rank_pass` and the stable argsort, bit
for bit, and `rank_offsets` against the JAX function exactly. Inputs are
made with numpy from a seed and fed to both packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from box2d_tpu import particles_pallas as jpp
from box2d_tpu_torch import particles_kernels as tpk
from test_particles_pallas import _brute

torch.set_num_threads(1)

INT32_MAX = np.iinfo(np.int32).max


def _cell_keys(pos, d):
    """The row-major cell key in int64, wrapped to int32 as JAX wraps."""
    xi = np.floor(pos[:, 0] / np.float32(d)).astype(np.int64)
    yi = np.floor(pos[:, 1] / np.float32(d)).astype(np.int64)
    key = (((yi + 0x8000) << 16) | ((xi + 0x8000) & 0xFFFF)) & 0xFFFFFFFF
    return np.where(key >= 1 << 31, key - (1 << 32), key).astype(np.int32)


def _sorted_table(seed, n, span, d=0.1):
    """A cell-sorted particle table with ~5% dead lanes (the inputs of
    tests/test_particles_pallas.py `_setup`, made in numpy)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, span, (n, 2)).astype(np.float32) - np.float32(
        span / 2)
    alive = rng.rand(n) > 0.05
    key = np.where(alive, _cell_keys(pos, d), INT32_MAX).astype(np.int32)
    o = np.argsort(key, kind="stable")
    vel = rng.randn(n, 2).astype(np.float32)[o]
    acc = rng.rand(n).astype(np.float32)[o]
    spos = np.where(alive[o][:, None], pos[o], np.float32(1e9))
    return key[o], spos.astype(np.float32), alive[o], vel, acc, d


@pytest.fixture(scope="module", params=[(0, 700, 3.0), (2, 511, 8.0)],
                ids=["dense", "sparse"])
def window_case(request):
    seed, n, span = request.param
    skey, spos, alive, vel, acc, d = _sorted_table(seed, n, span)
    lin_d, quad_d, vpp = 1.0, 0.7, 0.5
    scal = np.array([1 / d, d * d, lin_d, quad_d, vpp, 0, 0, 0], np.float32)
    nb = -(-n // jpp.B_BLK)
    offs = jpp.block_offsets(jnp.asarray(skey), nb)
    srow, scol = jnp.asarray(skey >> 16), jnp.asarray(skey & 0xFFFF)
    z = np.zeros(n, np.float32)
    inputs = {jpp.PH_WEIGHT: (z, z), jpp.PH_PRESSURE: (acc, z),
              jpp.PH_DAMPING: (vel[:, 0].copy(), vel[:, 1].copy())}
    jax_out, port_out = {}, {}
    t = torch.from_numpy
    for phase, (p0, p1) in inputs.items():
        tab = jpp.build_tab(jnp.asarray(spos), srow, scol, jnp.asarray(alive),
                            jnp.asarray(p0), jnp.asarray(p1), nb)
        jax_out[phase] = np.asarray(jpp.window_pass(
            tab, offs, jnp.asarray(scal)[None, :], phase, nb, True))[:n]
        port_out[phase] = tpk.window_pass(
            t(spos), t(skey), t(alive), t(p0), t(p1), t(scal),
            phase).numpy()
    brute = _brute(spos, skey, alive, vel, acc, d, lin_d, quad_d, vpp)
    return jax_out, port_out, brute


@pytest.mark.parametrize("phase", [0, 1, 2],
                         ids=["weight", "pressure", "damping"])
def test_window_twin_matches_pallas_kernel(window_case, phase):
    jax_out, port_out, _ = window_case
    assert jax_out[phase][:, 2].sum() == 0, "JAX band coverage overflow"
    want = jax_out[phase][:, :2]
    if phase == jpp.PH_WEIGHT:
        want = np.stack([want[:, 0], np.zeros_like(want[:, 0])], axis=1)
    np.testing.assert_allclose(port_out[phase], want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("phase", [0, 1, 2],
                         ids=["weight", "pressure", "damping"])
def test_window_twin_matches_brute_force(window_case, phase):
    _, port_out, brute = window_case
    if phase == jpp.PH_WEIGHT:
        np.testing.assert_allclose(port_out[phase][:, 0], brute[0], atol=2e-5)
        assert not port_out[phase][:, 1].any()
    else:
        np.testing.assert_allclose(port_out[phase], brute[phase], atol=2e-5)


def _rank_case(seed, n, n_dead):
    """+-1-cell perturbations of a sorted key table (the inputs of
    tests/test_particles_pallas.py `test_rank_pass_matches_stable_argsort`),
    with the last n_dead lanes dead (INT32_MAX) in both tables."""
    rng = np.random.RandomState(seed)
    cols = rng.randint(-300, 300, n).astype(np.int32) + 0x8000
    rows = np.sort(rng.randint(0, max(n // 200, 4), n)).astype(np.int32)
    key0 = np.sort(((rows - 0x7FF0).astype(np.int64) << 16
                    | cols).astype(np.int32))
    newkey = (key0 + rng.randint(-1, 2, n).astype(np.int32) * (1 << 16)
              + rng.randint(-1, 2, n).astype(np.int32))
    key0[n - n_dead:] = INT32_MAX
    newkey[n - n_dead:] = INT32_MAX
    return key0, newkey


@pytest.mark.parametrize("seed,n,n_dead", [(7, 900, 0), (8, 5000, 37)])
def test_rank_twin_matches_pallas_kernel_and_stable_argsort(seed, n, n_dead):
    key0, newkey = _rank_case(seed, n, n_dead)
    nb = -(-n // jpp.B_BLK)
    rb = jpp.rank_window(n)
    assert tpk.rank_window(n) == rb
    j_offs, j_ok = jpp.rank_offsets(jnp.asarray(key0), nb, rb)
    t_offs, t_ok = tpk.rank_offsets(torch.from_numpy(key0), nb, rb)
    np.testing.assert_array_equal(t_offs.numpy(), np.asarray(j_offs)[:, 0])
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert bool(t_ok.all()), "the window budget must cover the test grid"
    j_rank = np.asarray(jpp.rank_pass(jnp.asarray(newkey), j_offs, nb, rb,
                                      interpret=True))
    t_rank = tpk.rank_pass(torch.from_numpy(newkey), t_offs, rb).numpy()
    want = np.zeros(n, np.int32)
    want[np.argsort(newkey, kind="stable")] = np.arange(n)
    np.testing.assert_array_equal(t_rank, want)
    np.testing.assert_array_equal(t_rank, j_rank)


def test_rank_offsets_flag_a_window_too_narrow():
    """A block whose five old rows span more lanes than the window gets
    ok = False in both packages (the step then takes the full sort)."""
    n = 6000
    rows = np.repeat(np.arange(3), n // 3).astype(np.int64)
    key0 = ((rows << 16) | np.arange(n) % 2000).astype(np.int32)
    nb = -(-n // jpp.B_BLK)
    rb = jpp.rank_window(n)
    j_offs, j_ok = jpp.rank_offsets(jnp.asarray(key0), nb, rb)
    t_offs, t_ok = tpk.rank_offsets(torch.from_numpy(key0), nb, rb)
    np.testing.assert_array_equal(t_offs.numpy(), np.asarray(j_offs)[:, 0])
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert not bool(t_ok.all())


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    n = 300
    skey, spos, alive, vel, acc, d = _sorted_table(3, n, 2.0)
    t = torch.from_numpy
    scal = torch.tensor([1 / d, d * d, 1.0, 0.7, 0.5, 0, 0, 0],
                        dtype=torch.float32)
    k3, k4 = tpk.K3_LAUNCHES, tpk.K4_LAUNCHES
    out = tpk.window_pass(t(spos), t(skey), t(alive), t(acc), t(acc), scal,
                          tpk.PH_PRESSURE)
    assert out.shape == (n, 2) and torch.isfinite(out).all()
    offs, ok = tpk.rank_offsets(t(skey), -(-n // 256), tpk.rank_window(n))
    assert bool(ok.all())
    rank = tpk.rank_pass(t(skey), offs, tpk.rank_window(n))
    np.testing.assert_array_equal(rank.numpy(), np.arange(n))
    assert (tpk.K3_LAUNCHES, tpk.K4_LAUNCHES) == (k3, k4)
    with pytest.raises(ValueError):
        tpk.window_pass(t(spos).double(), t(skey), t(alive), t(acc),
                        t(acc), scal, tpk.PH_WEIGHT)
    with pytest.raises(ValueError):
        tpk.window_pass(t(spos), t(skey), t(alive), t(acc), t(acc), scal, 3)
    with pytest.raises(ValueError):
        tpk.rank_pass(t(skey), offs[:-1], tpk.rank_window(n))
