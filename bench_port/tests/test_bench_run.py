"""The harness on the CPU at tiny sizes: each cell's loop runs and comes
out correct; a reset repeats the first episode bit for bit; each planted
fault and the bfloat16 control come out not correct; no device metric is
reported without a card."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from harness import cli, registry
from harness.tree import leaves

CELLS = sorted(tiny.SIZES)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name):
    res, checks = tiny.run(name)
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"] is None
    assert list(res)[-1] == "checks"
    cell = registry.cell(name)
    assert set(res["metrics"]) == set(cell["end_to_end"])
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_reset_repeats_the_first_episode(name):
    c = tiny.cell(name)
    driver = registry.load_module("loops", c["loop"]).build(c, 5, "cpu")
    runs = []
    for _ in range(2):
        driver.reset()
        states = []
        for _ in range(tiny.EPISODE):
            driver.step()
            states.append({k: v.numpy().tobytes()
                           for k, v in leaves(driver.state).items()})
        runs.append(states)
    assert runs[0] == runs[1]


def _faults(name):
    kind = registry.cell(name)["loop"]
    return [f for f in ("unchanged", "half", "alter")
            if f != "half" or kind == "batched_step"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in _faults(n)])
def test_planted_fault_is_not_correct(name, fault):
    res, checks = tiny.run(name, fault=fault)
    assert res["correct"] is False, checks


@pytest.mark.parametrize("name", CELLS)
def test_bf16_control_is_not_correct(name):
    res, checks = tiny.run(name, control="bf16")
    assert res["correct"] is False, checks


def test_a_particle_let_out_is_counted():
    """A particle that the step puts outside the tank, where the
    reference's step from the same state keeps it in, is counted, and
    fails the run; one that both put out is not counted."""
    from harness import check
    from harness.tree import clone

    c = tiny.cell("water_tank_inner.batch")
    d = registry.load_module("loops", c["loop"]).build(c, 9, "cpu")
    ref = check.reference(c)
    d.reset()
    pre = check.primary(d.state, ref.PRIMARY)
    d.step()
    post = check.primary(d.state, ref.PRIMARY)

    def let_out(before, after):
        return check.numbers(c, [(0, before, after)], after,
                             d.inputs)["particles_let_out"]

    assert let_out(pre, post) == 0
    lo_x = ref.tank(c["config_data"], c["traffic_data"]["size"]["scale"])[0][0]
    out = clone(post)
    w, i = [int(v) for v in out["particles.alive"].nonzero()[0]]
    out["particles.pos"][w, i, 0] = float(lo_x) - 0.01
    assert let_out(pre, out) == 1
    # the same particle started in the middle of the wall, 0.25 m deep (a
    # step moves a particle 0.2 m at most): the reference's step leaves
    # it outside too
    pre_out = clone(pre)
    pre_out["particles.pos"][w, i, 0] = float(lo_x) - 0.25
    assert let_out(pre_out, out) == 0
    assert c["limits"]["particles_let_out"] == 0


def test_each_seed_makes_its_own_worlds():
    c = tiny.cell("water_tank_inner.batch")
    make = registry.load_module("loops", c["loop"]).build
    a, b, d = (make(c, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    pa, pd = a.spawn.particles.pos, d.spawn.particles.pos
    assert torch.equal(pa, b.spawn.particles.pos) and not torch.equal(pa, pd)
    # every world differs from the others, in positions and parameters
    n_w = pa.shape[0]
    assert len({tuple(x) for x in pa.reshape(n_w, -1).tolist()}) == n_w
    for key, v in a.inputs.items():
        assert v.shape == (n_w,) and len(set(v.tolist())) == n_w
        # the program steps with the parameters the reference is handed
        assert torch.equal(getattr(a.spawn.particles.params, key), v)


def test_without_spread_worlds_step_with_the_configurations_parameters():
    c = tiny.cell("water_tank_inner.batch")
    c["traffic_data"]["param_spread"] = 0.0
    d = registry.load_module("loops", c["loop"]).build(c, 5, "cpu")
    cfg = c["config_data"]
    for key, v in d.inputs.items():
        assert v.tolist() == [float(np.float32(cfg[key]))] * v.shape[0]
        assert torch.equal(getattr(d.spawn.particles.params, key), v)


def test_no_device_metric_without_a_card():
    with pytest.raises(RuntimeError):
        cli.device_info("cpu")
    out = subprocess.run(
        [sys.executable, f"{registry.ROOT}/run.py", "--workload",
         "water_tank_inner.batch", "--seed", "1", "--seconds", "1", "--trace",
         "1"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_steps_to_sample_come_from_the_seed():
    a = cli.snap_steps(2**32 + 3, 120, 3)
    assert a == cli.snap_steps(2**32 + 3, 120, 3)
    assert a[0] == 0 and len(set(a)) == 3 and max(a) < 120
    assert np.all(np.diff(a) > 0)


@pytest.mark.card
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, f"{registry.ROOT}/run.py", "--workload",
         "water_tank_inner.batch", "--seed", "3", "--seconds", "2", "--trace",
         "0"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
