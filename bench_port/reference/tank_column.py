"""The reference of a static box tank with a rectangular column of water
(LiquidFun's DamBreak and configurations of its widths): the scene worked
out from the configuration, the spawn check, and the numbers that decide
`correct`.

The check follows the program step by step: water is chaotic, and two
correct steppers part within dozens of steps. For each step the seed
sampled (the episode's first, from the spawn, always among them) it takes
the program's primary state before the step (positions, velocities and
which particles live), steps it with water.step and the scene and fluid
parameters the benchmark made, and measures the gaps to the program's
state after it. It also holds the steps to the configuration's
guarantees: no live particle let out of the tank where the reference's
step from the same state keeps it in, and none lost by the window's
end. (LiquidFun's float32 step lets a particle out itself: one that
lands exactly on a wall's face starts the next sub-iteration's ray on
the face, which the ray does not count as a hit, so a strict count of
particles outside would fail the reference too.)"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import water

F = np.float32
PRIMARY = ("particles.pos", "particles.vel", "particles.alive")
STRIDE = 0.75               # b2_particleStride, in diameters
WALL = 0.25                 # the walls' half thickness
PARAMS = ("pressure_strength", "damping_strength", "density")


def tank(cfg: dict, scale: float):
    """(lower, upper) corners of the tank's inside."""
    lo = np.asarray(cfg["tank_lower"], np.float64) * scale
    hi = np.asarray(cfg["tank_upper"], np.float64) * scale
    return lo, hi


def boxes(cfg: dict, scale: float) -> list:
    """The tank as four static boxes (center, half extents): floor,
    ceiling, left and right walls, their inner faces on the tank's
    inside."""
    (x0, y0), (x1, y1) = tank(cfg, scale)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    hw, hh = (x1 - x0) / 2 + 2 * WALL, (y1 - y0) / 2
    return [((cx, y0 - WALL), (hw, WALL)), ((cx, y1 + WALL), (hw, WALL)),
            ((x0 - WALL, cy), (WALL, hh)), ((x1 + WALL, cy), (WALL, hh))]


def column(cfg: dict, scale: float):
    """(center, half extents) of the water column."""
    c = np.asarray(cfg["column_center"], np.float64) * scale
    h = np.asarray(cfg["column_half"], np.float64) * scale
    return (float(c[0]), float(c[1])), (float(h[0]), float(h[1]))


def fill(center, half, stride) -> np.ndarray:
    """The column's particles on the stride grid, starting half a stride
    in from its lower left corner, rows from the bottom, each row left to
    right, stepped in doubles from float32 inputs."""
    cx, cy, hw, hh, st = (F(v) for v in (*center, *half, stride))
    xs, ys = [], []
    x = float(-hw + st / F(2))
    while x < float(hw):
        xs.append(x)
        x += float(st)
    y = float(-hh + st / F(2))
    while y < float(hh):
        ys.append(y)
        y += float(st)
    gx, gy = np.meshgrid(np.asarray(xs) + float(cx),
                         np.asarray(ys) + float(cy))
    return np.stack([gx.ravel(), gy.ravel()], 1).astype(F)


def spawn_positions(cfg: dict, size: dict) -> np.ndarray:
    center, half = column(cfg, size["scale"])
    return fill(center, half, STRIDE * 2.0 * cfg["radius"])


def _sorted(p: np.ndarray) -> np.ndarray:
    return p[np.lexsort((p[:, 0], p[:, 1]))]


def spawn_gap(built: dict, cell: dict) -> float:
    """The largest gap, in metres, between the program's built particles
    (before the seed's jitter) and the configuration's column; inf where
    the counts differ."""
    cfg, size = cell["config_data"], cell["traffic_data"]["size"]
    want = _sorted(spawn_positions(cfg, size))
    alive = built["particles.alive"].cpu()
    got = built["particles.pos"].cpu()[alive].numpy()
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(_sorted(got) - want).max())


def _flat(primary: dict):
    """The live particles of a state (one world or a batch) as flat rows,
    with the world of each."""
    pos, vel = primary["particles.pos"], primary["particles.vel"]
    alive = primary["particles.alive"]
    if alive.dim() == 1:
        pos, vel, alive = pos[None], vel[None], alive[None]
    world = torch.arange(alive.shape[0], device=alive.device)[:, None]
    world = world.expand(alive.shape)
    return pos[alive], vel[alive], world[alive], alive


def outside(pos, cfg: dict, scale: float):
    """Which of the particles `pos` are not strictly inside the tank."""
    lo, hi = tank(cfg, scale)
    x, y = pos[:, 0], pos[:, 1]
    return ~((x > lo[0]) & (x < hi[0]) & (y > lo[1]) & (y < hi[1]))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def reference_step(before: dict, inputs: dict, cfg: dict, size: dict,
                   control: str | None = None):
    """(pos, vel) of the live particles of `before` after one reference
    step; with control="bf16", its state rounded to bfloat16 before and
    after the step (the precision below the configuration's float32)."""
    pos, vel, world, _ = _flat(before)
    if control == "bf16":
        pos, vel = _bf16(pos), _bf16(vel)
    prm = {k: inputs[k].to(pos.device)[world] for k in PARAMS}
    scale = size["scale"]
    bx = boxes(cfg, scale)
    centers = torch.tensor([c for c, _ in bx], dtype=torch.float32,
                           device=pos.device)
    halves = torch.tensor([h for _, h in bx], dtype=torch.float32,
                          device=pos.device)
    pos, vel = water.step(pos, vel, world, prm, (centers, halves),
                          cfg["radius"], cfg["gravity"], cfg["dt"],
                          cfg["iterations"])
    if control == "bf16":
        pos, vel = _bf16(pos), _bf16(vel)
    return pos, vel


def _blocks(primary: dict, inputs: dict, block: int):
    """(primary, inputs) whole, or a batch's in blocks of `block` worlds."""
    alive = primary["particles.alive"]
    if alive.dim() == 1:
        yield primary, inputs
        return
    for w0 in range(0, alive.shape[0], block):
        yield ({k: v[w0:w0 + block] for k, v in primary.items()},
               {k: v[w0:w0 + block] for k, v in inputs.items()})


def _gap(a, b):
    """Each particle's largest gap over its two coordinates; inf where the
    program's reading is not a number."""
    d = (a - b).abs().amax(1)
    return torch.where(torch.isnan(d), math.inf, d)


def world_medians(d, world):
    """The (lower) median of d over each world's particles."""
    o1 = torch.argsort(d, stable=True)
    o2 = torch.argsort(world[o1], stable=True)
    ds, ws = d[o1][o2], world[o1][o2]
    counts = torch.bincount(ws)
    starts = torch.cumsum(counts, 0) - counts
    have = counts > 0
    return ds[(starts + (counts - 1) // 2)[have]]


def numbers(snaps, last, inputs: dict, cell: dict, control=None,
            block: int = 128) -> dict:
    """{number: worst reading} over the sampled steps (see the module's
    docstring) and, for the count of live particles, the window's final
    primary state `last`: the largest gap of any live particle
    (`particle_pos_m`, `particle_vel_mps`), the largest over the worlds
    of a world's median particle gap (`particle_pos_median_m`,
    `particle_vel_median_mps`), the particles that died or were born, and
    those the step lets out of the tank where the reference keeps them
    in (`particles_let_out`)."""
    cfg, size = cell["config_data"], cell["traffic_data"]["size"]
    worst = dict.fromkeys(("particle_pos_m", "particle_vel_mps",
                           "particle_pos_median_m", "particle_vel_median_mps",
                           "particle_alive_diff", "particles_let_out"), 0.0)

    def note(k, v):
        worst[k] = max(worst[k], float(v))

    for _, before_all, after_all in snaps:
        pairs = zip(_blocks(before_all, inputs, block),
                    _blocks(after_all, inputs, block))
        for (before, inp), (after, _) in pairs:
            alive = before["particles.alive"]
            _, _, world, _ = _flat(before)
            ref_pos, ref_vel = reference_step(before, inp, cfg, size)
            if control == "bf16":
                pos, vel = reference_step(before, inp, cfg, size, "bf16")
            else:
                pos = after["particles.pos"][alive]
                vel = after["particles.vel"][alive]
                note("particle_alive_diff",
                     (after["particles.alive"] != alive).sum())
            for name, d in (("pos_m", _gap(pos, ref_pos)),
                            ("vel_mps", _gap(vel, ref_vel))):
                q, unit = name.split("_")
                note(f"particle_{name}", d.max())
                note(f"particle_{q}_median_{unit}",
                     world_medians(d, world).max())
            note("particles_let_out",
                 (outside(pos, cfg, size["scale"])
                  & ~outside(ref_pos, cfg, size["scale"])).sum())
    if last is not None and control != "bf16":
        alive = last["particles.alive"]
        if snaps:
            first = snaps[0][1]["particles.alive"]
            note("particle_alive_diff", abs(int(alive.sum())
                                            - int(first.sum())))
    return worst
