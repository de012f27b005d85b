"""The roofline counts on a fixed small state, against brute force, and
the frozen arithmetic on fixed numbers."""

import pytest
import torch

from harness import roofline


def test_bound_arithmetic():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    want = 4 * sum(max((50 * (21 + 4 * ph) + 32) / 3.35e12,
                       200 * (7, 15, 23)[ph] / 67e12) for ph in range(3))
    assert roofline.k3_least_s(50, 200, 1, 4) == pytest.approx(want)


def test_particle_neighbours_match_brute_force():
    g = torch.Generator().manual_seed(3)
    pos = torch.rand((2, 300, 2), generator=g) * 1.5
    alive = torch.rand((2, 300), generator=g) > 0.1
    d = 0.1
    got = roofline.particle_neighbours(pos, alive, d).tolist()
    want = 0
    for w in range(2):
        p = pos[w][alive[w]]
        dd = ((p[:, None] - p[None]) ** 2).sum(-1)
        want += int((dd < d * d).sum()) - p.shape[0]
    assert got == [int(alive.sum()), want]
