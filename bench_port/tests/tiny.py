"""Cells at a size the CPU steps in seconds: each cell's own files with
its traffic's sizes cut."""

import time

from harness import cli, registry

SIZES = {
    "water_tank_inner.batch": {"size": {"scale": 0.25}, "worlds": 3},
}
EPISODE = 6


def cell(name):
    c = registry.cell(name)
    c["traffic_data"] = dict(c["traffic_data"], **SIZES[name],
                             episode_steps=EPISODE)
    return c


def run(name, control=None, fault=None, seconds=0.2, seed=2200000001):
    return cli.run_cell(cell(name), seed, seconds, False,
                        time.perf_counter(), "cpu", control, fault)
