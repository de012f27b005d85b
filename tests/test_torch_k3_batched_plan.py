"""Which kernel a batched K3 launch takes (particles_kernels.k3_batched_plan),
and the wrapper's CPU path on either side of the cutoff.

Pure PyTorch, no JAX. The plan is decided from a world's table width
alone: the small-world kernel (a group of threads a world, the world's
table in shared memory) up to K3_SMALL_LANES lanes, the grid kernel past
it. The batches the repo steps (chip_smoke.py phase 6 (h), (i)) are held
to their kernel here. The small kernel searches each lane's three ranges
inside brackets that follow from the sorted order; that they hold is
checked on the stress tables the card runs (port_fixtures.k3_batched_table).
"""

import pytest
import torch

from box2d_tpu_torch import particles_kernels as pk
from box2d_tpu_torch import scenes
from port_fixtures import K3_KINDS, k3_batched_table

torch.set_num_threads(1)


@pytest.mark.parametrize("n,path,lanes,groups", [
    (1, "small", 32, 8), (32, "small", 32, 8), (33, "small", 64, 4),
    (100, "small", 128, 2), (129, "small", 160, 1), (256, "small", 256, 1),
    (484, "small", 256, 1), (pk.K3_SMALL_LANES, "small", 256, 1),
    (pk.K3_SMALL_LANES + 1, "grid", 0, 0), (12100, "grid", 0, 0)])
def test_plan_at_its_edges(n, path, lanes, groups):
    plan = pk.k3_batched_plan(n)
    assert plan == pk.K3BatchedPlan(path, n, lanes, groups)
    assert pk.k3_batched_plan(n) is plan   # decided once for each width
    if path == "small":
        # three threads a lane: at most 768 a CTA; several worlds a CTA
        # only where one group covers a world
        assert lanes % 32 == 0 and lanes * groups <= pk.K3_GROUP_LANES
        assert lanes >= min(n, pk.K3_GROUP_LANES)
        assert groups == 1 or lanes >= n
    with pytest.raises(ValueError, match="unknown path"):
        pk.k3_batched_plan(n, "cluster")


@pytest.mark.parametrize("particles,path", [(500, "small"), (12000, "grid")])
def test_plan_of_the_batches_the_repo_steps(particles, path):
    """(h) 64 x dam_break(500) and (i) 8 x dam_break(12000): the width of a
    world's table is its particle capacity."""
    w = scenes.dam_break(particles, device="cpu")
    w.compile()
    n = w.state.particles.pos.shape[0]
    assert pk.k3_batched_plan(n).path == path


def test_plan_reads_no_device(monkeypatch):
    """The plan is made from the width alone: no tensor is read."""
    pk.k3_batched_plan.cache_clear()

    def read(*a, **k):
        raise AssertionError("the plan read a tensor")

    for name in ("item", "tolist", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, read)
    monkeypatch.setattr(torch.cuda, "synchronize", read)
    for n in (484, pk.K3_SMALL_LANES, 12100):
        pk.k3_batched_plan(n)


@pytest.mark.parametrize("n", [484, pk.K3_SMALL_LANES + 1])
def test_cpu_wrapper_is_the_twin_on_both_sides_of_the_cutoff(n):
    """Two worlds (dead lanes; a field across y = 0) at a width of each
    plan: the wrapper on CPU tensors gives the twin's result, world by
    world the single window_pass's, whatever kernel the plan names."""
    args = k3_batched_table(2, n, seed=3)
    for plan in (None, pk.k3_batched_plan(n, "small"),
                 pk.k3_batched_plan(n, "grid")):
        for phase in (pk.PH_WEIGHT, pk.PH_PRESSURE, pk.PH_DAMPING):
            got = pk.window_pass_batched(*args, phase, plan=plan)
            want = pk.window_pass_batched_reference(*args, phase)
            assert torch.equal(got, want)
            for w in range(2):
                one = pk.window_pass(*(a[w] for a in args), phase)
                assert torch.equal(got[w], one)
            assert float(got.abs().max()) > 0


def test_paths_count_the_grid_kernels_blocks():
    """paths counts the grid kernel's blocks: with no plan it takes the
    grid kernel; with the small kernel's plan, or a plan for another
    width, the wrapper raises."""
    args = k3_batched_table(1, 100)
    with pytest.raises(ValueError, match="grid kernel's blocks"):
        pk.window_pass_batched(*args, pk.PH_WEIGHT,
                               paths=torch.zeros(2, dtype=torch.int32),
                               plan=pk.k3_batched_plan(100))
    with pytest.raises(ValueError, match="plan for 99 lanes"):
        pk.window_pass_batched(*args, pk.PH_WEIGHT,
                               plan=pk.k3_batched_plan(99))
    for plan in (None, pk.k3_batched_plan(100, "grid")):
        paths = torch.zeros(2, dtype=torch.int32)
        pk.window_pass_batched(*args, pk.PH_WEIGHT, paths=paths, plan=plan)
        assert paths.tolist() == list(pk.k3_block_paths(args[1], args[2]))


def test_small_kernel_brackets_hold_on_the_stress_tables():
    """The small kernel searches a live lane i's own row in the whole
    table, the row above in [i + 1, n) and the row below in [0, i): the
    twin's ranges (torch.searchsorted over the whole table) lie inside
    those brackets on every kind of stress world, the y = 0 wrap
    included; a row outside the 16-bit range is never searched."""
    pos, skey, alive, p0, p1, scalars = k3_batched_table(8, 300, seed=5)
    n = skey.shape[1]
    lane = torch.arange(n)
    row = (skey >> 16).to(torch.int64)
    ranges = pk.neighbour_ranges(skey, alive)
    for d, (start, end) in zip((0, 1, -1), ranges):
        searched = alive & (row + d >= -32768) & (row + d <= 32767)
        lo = {0: 0, 1: lane + 1, -1: 0}[d]
        hi = {0: n, 1: n, -1: lane}[d]
        assert bool(((start >= lo) & (end <= hi))[searched].all()), d
        if d == 0:
            assert bool(((start <= lane) & (lane < end))[searched].all())
    kinds = [K3_KINDS[w % 4] for w in range(8)]
    # the stress worlds are what they say
    across = kinds.index("across y = 0")
    assert bool((skey[across][alive[across]] < 0).any())
    assert bool((skey[across][alive[across]] > 0).any())
    assert not bool(alive[kinds.index("no live particle")].any())
    dead = kinds.index("dead lanes")
    assert int((~alive[dead]).sum()) == n // 3
    assert bool((skey[dead][~alive[dead]] == pk.INT32_MAX).all())
