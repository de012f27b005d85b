"""Inputs and timing helpers shared by the port's tests
(tests/test_torch_*.py), chip_smoke.py, time_solver.py and probe_k3.py.

- Scenes built in either package through the modules they are given:
  `all_types_scene` (every joint type the solver sweeps), `hub_scene`
  (joint colors that overflow), `ccd_scene` (fast bodies against thin
  targets), `chain_sensor_scene` (a chain-loop ground, a sensor box,
  and circles, capsules and boxes falling through it), and the particle
  tanks `groups_tank` (the 100k-particle dam break of water, viscous and
  elastic groups with boxes on top) and `every_gate_tank` (a small group
  for every particle flag, a solid and a rigid group).
- Inputs made to reach a kernel's edge cases: `move_buckets_to_tail` (an
  overflow tail of several Jacobi windows), `k3_table` (K3 blocks on their
  global-memory path) and `rank_table` (K4 stress tables).
- Batches of worlds: `perturbed_leaves` (copies of one world's state,
  each jittered from a numpy seed, one with a velocity kick, some put to
  sleep), so that a wrong offset between worlds cannot hide behind
  identical copies.
- Timing on the card: `median_ms` (device time of one call),
  `library_rank` (the library call beside K4) and
  `record_particle_calls` (what dam_break's step hands K3 and K4).
It imports torch and numpy, and box2d_tpu_torch only inside the helpers
that need it.
"""

import dataclasses
import math
import statistics

import numpy as np
import torch

WARM_STEPS = 30
TIMED_CALLS = 20
PARTICLES = 100000
# a device-side wait ahead of each timed call: ~2 ms at the card's clock,
# longer than the host takes to launch one kernel call
QUEUE_CYCLES = 4_000_000


def all_types_scene(World, t, g, **kw):
    """Weld, wheel, motor, mouse and a distance spring with limits and
    motor over a ground box (the scene of tests/test_pallas_solver.py:195-253),
    built through the World, types and geometry modules it is given, so the
    CPU tests can build it in both packages. It is stepped without
    continuous collision, as that test steps it: the mouse joint makes its
    ball fast enough to open the CCD gate."""
    w = World(t.WorldDef(gravity=(0.0, -10.0), enable_continuous=False),
              **kw)
    ground = w.create_body(t.BodyDef(type=0, position=(0.0, -0.5)))
    w.create_polygon_shape(ground, t.ShapeDef(), g.box(50.0, 0.5))
    a = w.create_body(t.BodyDef(type=2, position=(0.0, 5.0),
                                angular_velocity=2.0))
    w.create_polygon_shape(a, t.ShapeDef(), g.box(0.4, 0.4))
    b = w.create_body(t.BodyDef(type=2, position=(1.0, 5.0)))
    w.create_polygon_shape(b, t.ShapeDef(), g.box(0.4, 0.4))
    w.create_joint(t.WeldJointDef(body_a=a, body_b=b,
                                  local_anchor_a=(0.5, 0.0),
                                  local_anchor_b=(-0.5, 0.0)))
    chassis = w.create_body(t.BodyDef(type=2, position=(5.0, 2.0)))
    w.create_polygon_shape(chassis, t.ShapeDef(), g.box(1.0, 0.25))
    wheel = w.create_body(t.BodyDef(type=2, position=(5.0, 1.0)))
    w.create_circle_shape(wheel, t.ShapeDef(), (0.0, 0.0), 0.4)
    w.create_joint(t.WheelJointDef(body_a=chassis, body_b=wheel,
                                   local_anchor_a=(0.0, -1.0),
                                   enable_motor=True, motor_speed=3.0,
                                   max_motor_torque=20.0,
                                   hertz=4.0, damping_ratio=0.7))
    puck = w.create_body(t.BodyDef(type=2, position=(-5.0, 3.0),
                                   gravity_scale=0.0))
    w.create_circle_shape(puck, t.ShapeDef(), (0.0, 0.0), 0.3)
    w.create_joint(t.MotorJointDef(body_a=ground, body_b=puck,
                                   linear_velocity=(1.0, 0.0),
                                   max_velocity_force=10.0,
                                   angular_velocity=1.0,
                                   max_velocity_torque=5.0))
    ball = w.create_body(t.BodyDef(type=2, position=(-8.0, 3.0)))
    w.create_circle_shape(ball, t.ShapeDef(), (0.0, 0.0), 0.3)
    w.create_joint(t.MouseJointDef(body_a=ground, body_b=ball,
                                   target=(-7.0, 4.0), hertz=4.0,
                                   damping_ratio=0.7, max_force=50.0))
    p1 = w.create_body(t.BodyDef(type=2, position=(8.0, 4.0)))
    w.create_circle_shape(p1, t.ShapeDef(), (0.0, 0.0), 0.2)
    anchor2 = w.create_body(t.BodyDef(type=0, position=(8.0, 6.0)))
    w.create_joint(t.DistanceJointDef(body_a=anchor2, body_b=p1,
                                      length=1.5, enable_spring=True,
                                      hertz=3.0, damping_ratio=0.5,
                                      enable_limit=True, min_length=1.0,
                                      max_length=2.5, enable_motor=True,
                                      max_motor_force=5.0, motor_speed=0.2))
    return w


def hub_scene(World, t, g, spokes=24, **kw):
    """One dynamic hub, a disc, joined to `spokes` dynamic balls on a ring
    1 m outside its rim, by revolute, distance and weld joints in turn;
    built through the modules it is given (as all_types_scene). The
    coloring gives a lane between two dynamic bodies one of 16 colors, so
    all but 16 of the hub's joints overflow into the last color: its joint
    segment mixes three types whose lanes share the hub. The balls stand
    1 m apart and the whole falls freely, so no contact is ever found; the
    hub's inertia grows with its radius, which keeps the overflow color's
    Jacobi windows, whose lanes all push the hub at once, stable. Stepped
    without continuous collision."""
    w = World(t.WorldDef(gravity=(0.0, -10.0), enable_continuous=False),
              **kw)
    ground = w.create_body(t.BodyDef(type=0, position=(0.0, -0.5)))
    w.create_polygon_shape(ground, t.ShapeDef(), g.box(50.0, 0.5))
    radius = max(2.0, spokes / (2.0 * math.pi))
    y0 = radius + 10.0
    hub = w.create_body(t.BodyDef(type=2, position=(0.0, y0),
                                  angular_velocity=0.5))
    w.create_circle_shape(hub, t.ShapeDef(), (0.0, 0.0), radius - 1.0)
    for i in range(spokes):
        a = 2.0 * math.pi * i / spokes
        x, y = radius * math.cos(a), radius * math.sin(a)
        ball = w.create_body(t.BodyDef(type=2, position=(x, y0 + y)))
        w.create_circle_shape(ball, t.ShapeDef(), (0.0, 0.0), 0.15)
        if i % 3 == 0:
            w.create_joint(t.RevoluteJointDef(body_a=hub, body_b=ball,
                                              local_anchor_a=(x, y)))
        elif i % 3 == 1:
            rim = (radius - 1.0) / radius
            w.create_joint(t.DistanceJointDef(
                body_a=hub, body_b=ball, local_anchor_a=(rim * x, rim * y),
                length=1.0))
        else:
            w.create_joint(t.WeldJointDef(body_a=hub, body_b=ball,
                                          local_anchor_a=(x, y)))
    return w


def ccd_scene(kind, World, t, g, **kw):
    """A world whose continuous pass has work: "wall", a bullet at a thin
    static wall (tests/test_continuous.py:30); "ground", a fast box at a
    thin ground (:43); "plate", a bullet at a thin dynamic plate (:56);
    "slide", a bullet sliding fast along a ground it starts within
    touching distance of (its TOI hits at fraction 0, which takes the
    core-proxy retry); "crowd", ten bullets at a row of six thin walls close enough that one
    step's sweep crosses them all (more fast shapes than a small
    Capacity.fast_cap, more candidates than a small cand_cap)."""
    w = World(**kw)
    bullet = t.ShapeDef(density=5.0)
    if kind == "wall":
        wall = w.create_body(t.BodyDef(type=0, position=(10.0, 0.0)))
        w.create_polygon_shape(wall, t.ShapeDef(), g.box(0.05, 5.0))
        b = w.create_body(t.BodyDef(type=2, position=(0.0, 0.0),
                                    linear_velocity=(200.0, 0.0),
                                    is_bullet=True, gravity_scale=0.0))
        w.create_circle_shape(b, bullet, (0.0, 0.0), 0.1)
    elif kind == "ground":
        ground = w.create_body(t.BodyDef(type=0, position=(0.0, -0.05)))
        w.create_polygon_shape(ground, t.ShapeDef(), g.box(50.0, 0.05))
        b = w.create_body(t.BodyDef(type=2, position=(0.0, 10.0),
                                    linear_velocity=(0.0, -100.0)))
        w.create_polygon_shape(b, t.ShapeDef(), g.box(0.2, 0.2))
    elif kind == "plate":
        plate = w.create_body(t.BodyDef(type=2, position=(10.0, 0.0),
                                        gravity_scale=0.0))
        w.create_polygon_shape(plate, t.ShapeDef(density=1.0),
                               g.box(0.05, 2.0))
        b = w.create_body(t.BodyDef(type=2, position=(0.0, 0.0),
                                    linear_velocity=(150.0, 0.0),
                                    is_bullet=True, gravity_scale=0.0))
        w.create_circle_shape(b, bullet, (0.0, 0.0), 0.1)
    elif kind == "slide":
        ground = w.create_body(t.BodyDef(type=0, position=(0.0, -0.5)))
        w.create_polygon_shape(ground, t.ShapeDef(), g.box(100.0, 0.5))
        b = w.create_body(t.BodyDef(type=2, position=(0.0, 0.0955),
                                    linear_velocity=(200.0, 0.0),
                                    is_bullet=True))
        w.create_circle_shape(b, bullet, (0.0, 0.0), 0.1)
    elif kind == "crowd":
        for i in range(6):
            wall = w.create_body(t.BodyDef(type=0,
                                           position=(3.0 + 0.5 * i, 1.0)))
            w.create_polygon_shape(wall, t.ShapeDef(), g.box(0.05, 2.0))
        for i in range(10):
            b = w.create_body(t.BodyDef(
                type=2, position=(0.0, 0.2 * i),
                linear_velocity=(400.0 + 10.0 * i, 0.0), is_bullet=True,
                gravity_scale=0.0))
            w.create_circle_shape(b, bullet, (0.0, 0.0), 0.05)
    else:
        raise ValueError(kind)
    return w


def chain_sensor_scene(World, t, g, **kw):
    """A chain loop (a box-shaped ground with a convex bump in its floor,
    wound so that it collides from inside), a static sensor box, and
    circles, capsules and boxes that fall through the sensor onto the
    floor. The falling shapes report sensor events; one circle, left of
    the others, does not. The first of them is thrown down so fast that
    it crosses the sensor within one step (the sensor's swept test sees
    it) and reaches the floor with the CCD gate open."""
    w = World(t.WorldDef(enable_sleep=False), **kw)
    ground = w.create_body(t.BodyDef(type=0))
    w.create_chain(ground, t.ChainDef(
        points=[(6.0, 0.0), (1.0, 0.0), (0.0, 0.5), (-1.0, 0.0),
                (-6.0, 0.0), (-6.0, 8.0), (6.0, 8.0)], is_loop=True))
    sensor = w.create_body(t.BodyDef(type=0, position=(0.0, 3.0)))
    w.create_polygon_shape(sensor, t.ShapeDef(
        is_sensor=True, enable_sensor_events=True), g.box(3.0, 0.5))
    seen = t.ShapeDef(density=1.0, enable_sensor_events=True)
    b = w.create_body(t.BodyDef(type=2, position=(-2.0, 6.3),
                                linear_velocity=(0.0, -150.0)))
    w.create_circle_shape(b, seen, (0.0, 0.0), 0.2)
    for i, x in enumerate((-1.0, -0.3, 0.4, 1.1, 1.8, 2.5)):
        b = w.create_body(t.BodyDef(type=2, position=(x, 5.0 + 0.4 * i),
                                    angle=0.3 * i))
        if i % 3 == 0:
            w.create_circle_shape(b, seen, (0.0, 0.0), 0.25)
        elif i % 3 == 1:
            w.create_capsule_shape(b, seen, (-0.25, 0.0), (0.25, 0.0), 0.15)
        else:
            w.create_polygon_shape(b, seen, g.box(0.25, 0.2))
    b = w.create_body(t.BodyDef(type=2, position=(-4.0, 6.0)))
    w.create_circle_shape(b, t.ShapeDef(density=1.0), (0.0, 0.0), 0.25)
    return w


def move_buckets_to_tail(args, buckets, grow):
    """Solver arguments (world._step_work(..., until="layout")) with the
    overflow tail grown by `grow` dead lanes and the live lanes of the
    given color buckets moved, in lane order, behind its live lanes: a
    tail whose lanes share bodies, spanning as many of its Jacobi windows
    as they fill. The CPU tests build their tail cases with it too."""
    scalars, idx, data, acc, body, params, nsub, chunk, l0, ncol, tail_w, jr = \
        args

    def pad(t, fill):
        more = torch.full((t.shape[0], grow), fill, dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, more], dim=1)

    idx, data, acc = pad(idx, -1), pad(data, 0.0), pad(acc, 0.0)
    lanes = torch.tensor([k for c in buckets
                          for k in range(c * chunk, (c + 1) * chunk)],
                         dtype=torch.long, device=idx.device)
    src = lanes[idx[0, lanes] >= 0]
    live_tail = torch.nonzero(idx[0, l0:] >= 0)
    start = l0 + (int(live_tail[-1]) + 1 if live_tail.numel() else 0)
    dst = start + torch.arange(src.numel(), device=idx.device)
    assert start + src.numel() <= idx.shape[1], "no room in the tail"
    for t, fill in ((idx, -1), (data, 0.0), (acc, 0.0)):
        t[:, dst] = t[:, src]
        t[:, src] = fill
    return (scalars, idx, data, acc, body, params, nsub, chunk, l0, ncol,
            tail_w, jr)


def k3_table(kind, seed=0):
    """Inputs of one K3 call (pos, skey, alive, p0, p1, scalars) that send
    blocks down the kernel's global-memory path; returns the argument
    tuple without the phase. "row boundary": a sparse row of 20 particles
    spread over 200 cells under two rows of 2,500 particles over the same
    cells, so the block that holds the sparse row and the start of the
    next spans 200 cells and its row-above union holds that whole dense
    row; "dense cell": 2,500 particles in one cell amid a sparse field. The
    table is cell-sorted (stable) with the port's key; p0 / p1 are
    velocity-like noise. The CPU tests build the same tables."""
    from box2d_tpu_torch.particles import _cell_key

    d = 0.1
    rng = np.random.default_rng(seed)
    if kind == "row boundary":
        pos = np.concatenate([
            np.stack([(np.arange(20) * 10 + 0.5) * d, np.full(20, 0.5 * d)],
                     axis=1),
            np.stack([rng.uniform(0, 200 * d, 2500),
                      rng.uniform(d, 2 * d, 2500)], axis=1),
            np.stack([rng.uniform(0, 200 * d, 2500),
                      rng.uniform(2 * d, 3 * d, 2500)], axis=1)])
    else:
        grid = np.stack(np.meshgrid(np.arange(-20, 20), np.arange(-20, 20)),
                        axis=-1).reshape(-1, 2) * 2.5 * d
        pos = np.concatenate([rng.uniform(0.0, d, (2500, 2)), grid])
    pos = torch.tensor(pos, dtype=torch.float32)
    n = pos.shape[0]
    alive = torch.ones(n, dtype=torch.bool)
    key = _cell_key(pos, alive, 1.0 / d)
    order = torch.argsort(key, stable=True)
    p01 = torch.tensor(rng.normal(size=(2, n)), dtype=torch.float32)
    scalars = torch.tensor([1.0 / d, d * d, 1.0, 0.7, 0.5, 0.0, 0.0, 0.0],
                           dtype=torch.float32)
    return (pos[order].contiguous(), key[order].contiguous(), alive,
            p01[0, order].contiguous(), p01[1, order].contiguous(), scalars)


def rank_table(n, seed, equal_blocks=False):
    """Inputs of one K4 call (newkey, offs, rb) on a cell-sorted key table
    of n particles, ~1.8 a cell on a square field: every lane moved by one
    row and one column; or, with equal_blocks, lanes [256, 768) (two whole
    blocks) holding one key that does not move while every other lane
    moves. Asserts that the rank repair's preconditions hold, so the
    ranks must equal the stable argsort's."""
    from box2d_tpu_torch import particles_kernels as pk

    rng = np.random.default_rng(seed)
    side = int(math.sqrt(n / 1.8))
    rows = rng.integers(0, side, n) + 0x7F00
    cols = rng.integers(0, side, n) + 0x8000
    key0 = np.sort(((rows << 16) | cols).astype(np.int32))
    newkey = (key0 + rng.choice([-1, 1], n) * (1 << 16)
              + rng.choice([-1, 1], n)).astype(np.int32)
    if equal_blocks:
        key0[256:768] = key0[256]
        newkey[256:768] = key0[256]
    rb = pk.rank_window(n)
    offs, ok = pk.rank_offsets(torch.from_numpy(key0), -(-n // 256), rb)
    assert bool(ok.all()), "the window does not cover the moved lanes"
    return torch.from_numpy(newkey), offs, rb


def median_ms(fn, calls=TIMED_CALLS):
    """The median time of one call of fn on the card, in ms, from CUDA
    events around each of `calls` calls after one warm call. Each call is
    queued behind a device-side wait of QUEUE_CYCLES clock cycles, so its
    launches are in the stream before the first event runs and the events
    time the device, not the host's Python and launch overhead (for a call
    whose host part outlasts the wait, such as a twin's thousands of small
    launches, they time the host as well)."""
    fn()
    times = []
    for _ in range(calls):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def other_plan(plan, group_max):
    """The batched solver plan (contact_solver.BatchedPlan) that takes the
    kernel `plan` does not: the cluster kernel for a small-world plan;
    else the small-world kernel at group_max threads a world, one world a
    CTA."""
    if plan.path == "small":
        return plan._replace(path="cluster", threads_per_world=0,
                             worlds_per_cta=0)
    return plan._replace(path="small", threads_per_world=group_max,
                         worlds_per_cta=1)


def library_rank(newkey):
    """The rank of every lane by one library sort: the inverse permutation
    of torch.argsort(newkey, stable=True)."""
    order = torch.argsort(newkey, stable=True)
    out = torch.empty_like(newkey)
    out[order] = torch.arange(newkey.shape[0], dtype=torch.int32,
                              device=newkey.device)
    return out


def record_particle_calls(n=PARTICLES, steps=WARM_STEPS):
    """Steps dam_break(n) on the card and records what the particle step
    hands its kernels: the three K3 calls (weight, pressure, damping) of
    the first sub-iteration after `steps` steps, and, of the K4 calls of
    the latest step up to then that took the rank repair, the one that
    moves the most lanes. Returns (K3 argument tuples, K4 argument tuple,
    that step). Raises if no step took the repair. Kernel launches made
    here count like any other: reset the counts after it."""
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.particles import particle_step

    w = scenes.dam_break(n, device="cuda")
    w.compile()
    ranks, rank_step = [], None
    window_pass, rank_pass = pk.window_pass, pk.rank_pass
    for i in range(steps + 1):
        windows, found = [], []
        # particle_step looks both wrappers up at call time: wrap them to
        # capture their inputs at this state
        pk.window_pass = lambda *a: windows.append(a) or window_pass(*a)
        pk.rank_pass = lambda *a: found.append(a) or rank_pass(*a)
        try:
            particle_step(w.state.particles, w.state, 1 / 60,
                          w._step.particle_cfg, world.StepStats())
        finally:
            pk.window_pass, pk.rank_pass = window_pass, rank_pass
        if found:
            ranks, rank_step = found, i
        if i < steps:
            w.step(1 / 60)
    assert [a[6] for a in windows[:3]] == [0, 1, 2], "K3 phases not recorded"
    assert ranks, f"the rank repair never engaged in {steps} steps"

    def moved(args):
        ident = torch.arange(args[0].shape[0], dtype=torch.int32,
                             device=args[0].device)
        return int((pk.rank_pass_reference(*args) != ident).sum())

    return windows[:3], max(ranks, key=moved), rank_step


def query_scene(World, t, g, **kw):
    """One shape of every geometry the queries dispatch on, built through
    the World, types and geometry modules it is given (as
    all_types_scene): a ground box, an open chain and a segment (static),
    a circle, a capsule, a box, an 8-gon, a rounded triangle and a rounded
    box (dynamic), a static sensor box with sensor events, and a box with
    filter category 2. Stepped without continuous collision."""
    w = World(t.WorldDef(gravity=(0.0, -10.0), enable_continuous=False),
              **kw)
    ground = w.create_body(t.BodyDef(type=0, position=(0.0, 0.0)))
    w.create_polygon_shape(ground, t.ShapeDef(),
                           g.box(20.0, 0.5, center=(0.0, -0.5)))
    w.create_chain(ground, t.ChainDef(points=[
        (9.0, 3.0), (7.0, 2.4), (5.0, 2.9), (3.0, 2.5), (1.0, 3.1)]))
    w.create_segment_shape(ground, t.ShapeDef(), (-10.0, 4.0), (-6.0, 5.0))
    sd = t.ShapeDef(density=1.0)

    def body(x, y, angle=0.0):
        return w.create_body(t.BodyDef(type=2, position=(x, y),
                                       angle=angle))

    w.create_circle_shape(body(-4.0, 1.0), sd, (0.0, 0.0), 0.5)
    w.create_capsule_shape(body(-2.0, 0.8, 0.3), sd, (-0.5, 0.0),
                           (0.5, 0.0), 0.3)
    w.create_polygon_shape(body(0.0, 0.5), sd, g.box(0.5, 0.5))
    octagon = [(0.6 * math.cos(2 * math.pi * k / 8 + 0.1),
                0.6 * math.sin(2 * math.pi * k / 8 + 0.1)) for k in range(8)]
    w.create_polygon_shape(body(2.0, 0.6, 0.2), sd, g.polygon(octagon))
    w.create_polygon_shape(body(4.0, 0.7), sd, g.polygon(
        [(-0.4, -0.3), (0.4, -0.3), (0.0, 0.4)], radius=0.2))
    w.create_polygon_shape(body(6.0, 0.6, -0.4), sd, g.polygon(
        [(-0.4, -0.4), (0.4, -0.4), (0.4, 0.4), (-0.4, 0.4)], radius=0.1))
    sensor = w.create_body(t.BodyDef(type=0, position=(0.0, 4.0)))
    w.create_polygon_shape(sensor, t.ShapeDef(
        is_sensor=True, enable_sensor_events=True), g.box(1.0, 1.0))
    w.create_polygon_shape(body(-6.0, 0.5), t.ShapeDef(
        filter=t.Filter(category_bits=2, mask_bits=0xFFFF)), g.box(0.5, 0.5))
    return w


def api_scene(World, t, g, rows=8, **kw):
    """all_types_scene plus everything the host API reaches, so that no
    runtime call of the JAX World remakes its step: a pyramid of `rows`
    rows of boxes at x = 25, a revolute pendulum, a prismatic slider, a
    filter joint (every joint type), a capsule, a static segment, an open
    chain, a sensor box with sensor events and a box with a non-default
    filter. Built through the modules it is given (as all_types_scene),
    stepped without continuous collision."""
    w = all_types_scene(World, t, g, **kw)
    ground = 0
    sd = t.ShapeDef(density=1.0)
    sd.material.friction = 0.6
    for i in range(rows):
        n = rows - i
        for j in range(n):
            b = w.create_body(t.BodyDef(
                type=2, position=(25.0 - 0.5 * n + 0.5 + j, 0.5 + i)))
            w.create_polygon_shape(b, sd, g.box(0.5, 0.5))
    pend = w.create_body(t.BodyDef(type=2, position=(-12.0, 6.0)))
    w.create_capsule_shape(pend, t.ShapeDef(), (0.0, -0.6), (0.0, 0.6), 0.2)
    w.create_joint(t.RevoluteJointDef(
        body_a=ground, body_b=pend, local_anchor_a=(-12.0, 7.5),
        local_anchor_b=(0.0, 0.9), enable_motor=True, motor_speed=1.0,
        max_motor_torque=50.0, enable_limit=True, lower_angle=-1.0,
        upper_angle=1.0))
    slider = w.create_body(t.BodyDef(type=2, position=(-16.0, 3.0)))
    w.create_polygon_shape(slider, t.ShapeDef(), g.box(0.4, 0.2))
    w.create_joint(t.PrismaticJointDef(
        body_a=ground, body_b=slider, local_anchor_a=(-16.0, 3.5),
        local_axis_a=(1.0, 0.0), enable_limit=True, lower_translation=-1.0,
        upper_translation=1.0, enable_spring=True, hertz=2.0,
        damping_ratio=0.5))
    left = w.create_body(t.BodyDef(type=2, position=(-20.0, 0.6)))
    w.create_circle_shape(left, t.ShapeDef(), (0.0, 0.0), 0.5)
    right = w.create_body(t.BodyDef(type=2, position=(-19.2, 0.6)))
    w.create_circle_shape(right, t.ShapeDef(), (0.0, 0.0), 0.5)
    w.create_joint(t.FilterJointDef(body_a=left, body_b=right))
    w.create_segment_shape(ground, t.ShapeDef(), (-30.0, 2.0), (-24.0, 0.0))
    w.create_chain(ground, t.ChainDef(points=[
        (45.0, 2.0), (42.0, 0.5), (39.0, 0.2), (36.0, 0.1), (33.0, 0.1)]))
    w.create_polygon_shape(ground, t.ShapeDef(
        is_sensor=True, enable_sensor_events=True),
        g.box(2.0, 2.0, center=(25.0, 4.0)))
    odd = w.create_body(t.BodyDef(type=2, position=(-23.0, 0.5)))
    w.create_polygon_shape(odd, t.ShapeDef(filter=t.Filter(
        category_bits=2, mask_bits=0xFFFD, group_index=-3)), g.box(0.5, 0.5))
    return w


def with_all_events(w, threshold=0.5):
    """World `w`, before its build, with contact, hit and sensor events on
    every shape and every joint's force and torque thresholds at
    `threshold`, so that every event kind fires (the shape flags ride in
    the packed shape table, so they are set before the build). Works on
    either package's World; returns it."""
    for s in w.builder._shapes:
        for key in ("enable_contact_events", "enable_hit_events",
                    "enable_sensor_events"):
            s[key] = True
    for j in w.builder._joints:
        j["force_threshold"] = j["torque_threshold"] = threshold
    return w


def obstacle_tank(particles, World, t, g, **kw):
    """dam_break's tank and water column (box2d_tpu_torch/scenes.py
    dam_break) with a static circle and a static capsule in the column's
    path: a particle world with other shapes than polygons, whose
    anti-tunnel ray takes queries.ray_shape_analytic. Built through the
    modules it is given (as all_types_scene)."""
    w = World(**kw)
    tank = w.create_body(t.BodyDef(type=0))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(4.0, 0.25, center=(0, -0.25)))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(0.25, 3.0, center=(-4.0, 2.75)))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(0.25, 3.0, center=(4.0, 2.75)))
    w.create_circle_shape(tank, t.ShapeDef(), (0.5, 0.6), 0.4)
    w.create_capsule_shape(tank, t.ShapeDef(), (1.5, 0.3), (2.8, 0.5), 0.2)
    radius = 0.05
    ps = w.create_particle_system(radius=radius)
    stride = 0.75 * 2.0 * radius
    side = math.sqrt(particles) * stride
    ps.create_group_box(center=(-4.0 + side / 2 + 0.3, side / 2 + 0.05),
                        half_w=side / 2, half_h=side / 2)
    return w


def api_sequence(w, t, g):
    """A scripted run of the host API on a compiled pyramid-8 with spare
    lanes (chip_smoke.py drives it on the card and on the CPU): spawns and
    a runtime chain, destroys, a type flip, a filter change, a custom
    filter and a one-way-platform pre_solve, contact and hit events on
    five shapes, body and joint setters on runtime joints like
    all_types_scene's, and an explosion. Returns the handles it made, in
    order."""
    h = []
    box = w.create_body(t.BodyDef(type=2, position=(-6.0, 1.8), angle=0.2))
    h += [box, w.create_polygon_shape(box, t.ShapeDef(), g.box(0.4, 0.3))]
    ball = w.create_body(t.BodyDef(type=2, position=(6.0, 4.0)))
    h += [ball, w.create_circle_shape(ball, t.ShapeDef(), (0.0, 0.0), 0.3)]
    cap = w.create_body(t.BodyDef(type=2, position=(-3.0, 9.0)))
    h += [cap, w.create_capsule_shape(cap, t.ShapeDef(), (-0.4, 0.0),
                                      (0.4, 0.0), 0.2)]
    ramp = w.create_body(t.BodyDef(type=0))
    h += [ramp] + w.create_chain(ramp, t.ChainDef(points=[
        (16.0, 3.0), (13.0, 1.0), (10.0, 0.2), (8.5, 0.05), (7.0, 0.0)]))
    # a one-way platform: a thin static box that only stops what falls on
    # it from above
    plat = w.create_body(t.BodyDef(type=0, position=(-6.0, 1.2)))
    ps = w.create_polygon_shape(plat, t.ShapeDef(), g.box(1.5, 0.1))
    h += [plat, ps]
    lane = ps & 0xFFFFF

    def one_way(st, a, b, mf):
        # the normal points from shape a to shape b: keep the platform's
        # contacts whose other shape is above it
        ny = mf.normal[:, 1]
        return (((a != lane) & (b != lane)) | ((a == lane) & (ny > 0.5))
                | ((b == lane) & (ny < -0.5)))

    w.set_pre_solve(one_way)
    # the custom filter keeps the capsule off the ball
    sc, sb = h[5], h[3]
    w.set_custom_filter(lambda st, a, b: ~(((a == sb) & (b == sc))
                                           | ((a == sc) & (b == sb))))
    wheel = w.create_body(t.BodyDef(type=2, position=(6.0, 2.0)))
    h += [wheel, w.create_circle_shape(wheel, t.ShapeDef(), (0.0, 0.0), 0.4)]
    h.append(w.create_joint(t.WheelJointDef(
        body_a=ball, body_b=wheel, local_anchor_a=(0.0, -2.0),
        enable_motor=True, motor_speed=3.0, max_motor_torque=20.0,
        hertz=4.0, damping_ratio=0.7)))
    h.append(w.create_joint(t.DistanceJointDef(
        body_a=ramp, body_b=cap, local_anchor_a=(-3.0, 11.0), length=1.5,
        enable_spring=True, hertz=3.0, damping_ratio=0.5)))
    w.set_joint_motor_speed(h[-2], -2.0)
    w.set_joint_max_motor_force(h[-2], 15.0)
    w.set_distance_joint_length(h[-1], 2.0)
    for shape in (0, 20, h[1], h[3], h[10]):  # contact and hit events
        w.enable_shape_contact_events(shape, True)
        w.enable_shape_hit_events(shape, True)
    w.set_angular_velocity(box, 3.0)
    w.apply_linear_impulse_to_center(ball, (0.5, 1.0))
    w.set_gravity_scale(cap, 0.8)
    w.destroy_shape(h[8])                   # one chain segment
    w.destroy_body(4)                       # a pyramid box
    w.set_body_type(5, 1)                   # kinematic
    w.set_linear_velocity(5, (0.0, 0.5))
    w.set_filter(10, t.Filter(group_index=-2))
    w.set_filter(11, t.Filter(group_index=-2))
    w.explode((0.0, 0.5), 3.0, 2.0)
    return h


# LiquidFun's particle and group flag bits (ref: particle/Particle.cs,
# ParticleGroup.cs), the same in both packages
P_WALL, P_SPRING, P_ELASTIC, P_VISCOUS = 1 << 2, 1 << 3, 1 << 4, 1 << 5
P_POWDER, P_TENSILE, P_COLOR_MIXING = 1 << 6, 1 << 7, 1 << 8
P_BARRIER, P_STATIC_PRESSURE, P_REPULSIVE = 1 << 9, 1 << 10, 1 << 12
G_SOLID, G_RIGID = 1 << 0, 1 << 1


def groups_tank(World, t, g, particles=100000, boxes=10, **kw):
    """BASELINE.json config 5 at full size: a dam break of about
    `particles` particles of radius 0.05 m (dam_break's) in three equal
    groups side by side against the left wall of a static tank 48 m wide
    with 28 m walls: plain water (the pressure group), P_VISCOUS and
    P_ELASTIC (Voronoi triads). At 100k each group is a box 7.5 m wide
    and 25 m tall; smaller counts keep the 3:10 aspect. `boxes` dynamic 1
    m boxes (density 0.5) rest on top of the column, the rigid-body
    coupling. The ground's top is y = 0 and every particle spawns above
    it. Built through the modules it is given, so both packages build
    it."""
    w = World(t.WorldDef(enable_continuous=False), **kw)
    tank = w.create_body(t.BodyDef(type=0))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(24.5, 0.25, center=(0.0, -0.25)))
    for x in (-24.25, 24.25):
        w.create_polygon_shape(tank, t.ShapeDef(),
                               g.box(0.25, 14.0, center=(x, 14.0)))
    radius = 0.05
    ps = w.create_particle_system(radius=radius)
    # three boxes of width x 10/3 width, 0.75 diameters between rows
    width = math.sqrt(particles / 3 * 0.3) * 0.75 * 2 * radius
    height = width * 10.0 / 3.0
    x0 = -24.0 + 0.05
    for i, flags in enumerate((0, P_VISCOUS, P_ELASTIC)):
        ps.create_group_box(center=(x0 + width * (i + 0.5),
                                    0.05 + height / 2),
                            half_w=width / 2, half_h=height / 2,
                            flags=flags)
    span = 3 * width / boxes
    for i in range(boxes):
        box = w.create_body(t.BodyDef(
            type=2, position=(x0 + span * (i + 0.5), height + 0.65)))
        w.create_polygon_shape(box, t.ShapeDef(density=0.5),
                               g.box(0.5, 0.5))
    return w


def every_gate_tank(World, t, g, particles=700, **kw):
    """A small group for every particle flag that gates a pass (viscous,
    repulsive, powder, tensile, static pressure, colour mixing, elastic,
    spring), a solid group and a rigid group, in two tiers of five square
    boxes, and between the tiers a one-particle line flagged P_BARRIER |
    P_WALL (barrier segments that do not move) on which the upper tier
    rests; a light dynamic box on the rigid group. About `particles`
    particles of radius 0.05 m, all above the ground's top (y = 0); each
    group has its own colour. Built through the modules it is given."""
    w = World(t.WorldDef(enable_continuous=False), **kw)
    radius = 0.05
    stride = 0.75 * 2 * radius
    side_n = max(2, round(math.sqrt(particles * 0.94 / 10)))
    side = side_n * stride
    gap = 2 * stride
    width = 5 * side + 4 * gap
    tank = w.create_body(t.BodyDef(type=0))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(width / 2 + 1.0, 0.25, center=(0, -0.25)))
    for x in (-(width / 2 + 0.75), width / 2 + 0.75):
        w.create_polygon_shape(tank, t.ShapeDef(),
                               g.box(0.25, 3 * side, center=(x, 3 * side)))
    ps = w.create_particle_system(radius=radius)
    groups = ((P_VISCOUS, 0), (P_REPULSIVE, 0), (P_POWDER, 0),
              (P_TENSILE, 0), (P_STATIC_PRESSURE, 0),
              (P_COLOR_MIXING, 0), (P_ELASTIC, 0), (P_SPRING, 0),
              (0, G_SOLID), (0, G_RIGID))
    line_y = 0.05 + side + stride
    for i, (flags, gflags) in enumerate(groups):
        tier, col = divmod(i, 5)
        cx = -width / 2 + side / 2 + col * (side + gap)
        cy = (0.05 + side / 2 if tier == 0
              else line_y + stride + side / 2)
        shade = (i + 1) / (len(groups) + 1)
        ps.create_group_box(center=(cx, cy), half_w=side / 2,
                            half_h=side / 2, flags=flags,
                            group_flags=gflags,
                            color=(shade, 1.0 - shade, 0.5, 1.0))
    ps.create_group_box(center=(0.0, line_y), half_w=width / 2,
                        half_h=stride / 2, flags=P_BARRIER | P_WALL,
                        color=(0.0, 0.0, 0.0, 1.0))
    # the box's bottom 0.02 m above the centres of the rigid group's top
    # row, within a particle radius: it couples from the first step on
    rigid_x = -width / 2 + side / 2 + 4 * (side + gap)
    top = line_y + stride + side - stride / 2
    box = w.create_body(t.BodyDef(type=2,
                                  position=(rigid_x, top + 0.02 + 0.15)))
    w.create_polygon_shape(box, t.ShapeDef(density=0.2), g.box(0.15, 0.15))
    return w


def box_tank(World, t, g, particles=300, **kw):
    """dam_break's tank (box2d_tpu_torch/scenes.py dam_break) with a
    column of about `particles` particles against its left wall and one
    dynamic 0.3 m box (density 0.5) resting on the ground at x = 2, clear
    of the water for the first steps; continuous collision off. A batch
    of its worlds (perturbed_leaves) moves the box onto the column in one
    world and puts it to sleep in another. Built through the modules it
    is given, so both packages build it."""
    w = World(t.WorldDef(enable_continuous=False), **kw)
    tank = w.create_body(t.BodyDef(type=0))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(4.0, 0.25, center=(0, -0.25)))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(0.25, 3.0, center=(-4.0, 2.75)))
    w.create_polygon_shape(tank, t.ShapeDef(),
                           g.box(0.25, 3.0, center=(4.0, 2.75)))
    box = w.create_body(t.BodyDef(type=2, position=(2.0, 0.15)))
    w.create_polygon_shape(box, t.ShapeDef(density=0.5), g.box(0.15, 0.15))
    radius = 0.05
    ps = w.create_particle_system(radius=radius)
    stride = 0.75 * 2.0 * radius
    side = math.sqrt(particles) * stride
    ps.create_group_box(center=(-4.0 + side / 2 + 0.3, side / 2 + 0.05),
                        half_w=side / 2, half_h=side / 2)
    return w


PARTICLE_API = ("destroy_particle", "destroy_particles_in_aabb",
                "apply_particle_force", "join_particle_groups",
                "split_particle_group", "stuck_particles")


def _replace_particles(w, **cols):
    w.state = dataclasses.replace(w.state, particles=dataclasses.replace(
        w.state.particles, **cols))


def particle_api_case(w, name, numpy_of, put, seed=9):
    """One particle method of World (a short sequence of its calls) on an
    every_gate_tank world of either package; numpy_of / put move a leaf
    to numpy and back. Returns what the calls returned.
    - join_particle_groups: the spring group (7) is first moved against
      the elastic group (6), so the seam gets springs and triads;
    - split_particle_group: a strip through group 0 is destroyed first,
      leaving two components;
    - stuck_particles: reads consecutive_contact_steps set from a numpy
      seed (one of the stuck particles destroyed)."""
    if name == "destroy_particle":
        w.destroy_particle(5)
        return w.destroy_particle(400)
    if name == "destroy_particles_in_aabb":
        return w.destroy_particles_in_aabb((-1.0, 0.0), (0.2, 0.4))
    if name == "apply_particle_force":
        w.apply_particle_force(7, (1.5, -2.0))
        w.apply_particle_force(7, (0.25, 0.5))
        return w.apply_particle_force(300, (3.0, 0.0))
    pt = w.state.particles
    group = numpy_of(pt.group)
    if name == "join_particle_groups":
        pos = numpy_of(pt.pos).copy()
        pos[group == 7, 0] -= np.float32(0.15)
        _replace_particles(w, pos=put(pos))
        return w.join_particle_groups(6, 7)
    if name == "split_particle_group":
        mid = float(np.median(numpy_of(pt.pos)[group == 0, 0]))
        w.destroy_particles_in_aabb((mid - 0.06, -1.0), (mid + 0.06, 9.0))
        return w.split_particle_group(0)
    if name == "stuck_particles":
        rng = np.random.default_rng(seed)
        cons = rng.integers(0, 9, group.shape[0]).astype(np.int32)
        _replace_particles(w, consecutive_contact_steps=put(cons))
        w.destroy_particle(int(np.argmax(cons)))
        return [w.stuck_particles(), w.stuck_particles(threshold=7)]
    raise KeyError(name)


def perturbed_leaves(leaves, n_worlds, seed=0, jitter=0.01, kick=None,
                     asleep=(), fast=None, particle_jitter=0.0,
                     param_spread=0.0):
    """A batch of n_worlds copies of one world, as {dotted path: array}
    with a leading world axis (state_to_numpy's layout, so both packages
    can load it). Every copy's dynamic bodies move by up to `jitter` m in
    x and y, from numpy's generator seeded with seed + the copy's index;
    kick = (world, body, (vx, vy)) adds that velocity to one body; the
    worlds in `asleep` have every body asleep; fast = (world, body, (vx,
    vy), (x, y)) moves one body's centre there and sets its velocity (a
    fast body opens the CCD gate). A world with particles: every copy's
    live particles move by up to particle_jitter m (from the same
    generator, after the bodies), and copy w's pressure and damping
    strengths and density are scaled by 1 + param_spread * w, 1 -
    param_spread * w / 2 and 1 + param_spread * w / 4 (each world its own
    window-pass scalars)."""
    out = {k: np.stack([np.array(v, copy=True)] * n_worlds)
           for k, v in leaves.items()}
    dyn = leaves["bodies.type"] == 2
    for w in range(n_worlds):
        rng = np.random.default_rng(seed + w)
        out["bodies.center"][w][dyn] += rng.uniform(
            -jitter, jitter, (int(dyn.sum()), 2)).astype(np.float32)
        if particle_jitter:
            live = out["particles.alive"][w]
            out["particles.pos"][w][live] += rng.uniform(
                -particle_jitter, particle_jitter,
                (int(live.sum()), 2)).astype(np.float32)
        if param_spread:
            for key, scale in (("pressure_strength", 1.0),
                               ("damping_strength", -0.5),
                               ("density", 0.25)):
                out["particles.params." + key][w] *= np.float32(
                    1.0 + scale * param_spread * w)
    if kick is not None:
        w, body, vel = kick
        out["bodies.v"][w, body] += np.asarray(vel, np.float32)
    if fast is not None:
        w, body, vel, center = fast
        out["bodies.v"][w, body] = np.asarray(vel, np.float32)
        out["bodies.center"][w, body] = np.asarray(center, np.float32)
    for w in asleep:
        out["bodies.awake"][w] = False
    return out
