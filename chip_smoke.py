#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (box2d_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
1. device: nvidia-smi name and power limit, torch and CUDA versions;
2. build: nvcc builds box2d_tpu_torch/csrc/contact_solver.cu and
   csrc/particles.cu for sm_90a, the two at once;
3. kernel vs twin: the solver kernel against its plain PyTorch twin on the
   same CUDA tensors, at the solver inputs the port's own step packs for
   pyramid-20 and pyramid-140 after 30 steps from spawn (timed), for
   pyramid-140 0 and 2 steps from spawn (live overflow tail), and with
   joints: joint_farm(1000) after 30 steps (timed) and an all-types scene
   (weld, wheel, motor, mouse, distance spring with limits and motor);
   then the particle kernels at the inputs the port's dam_break(100000)
   step gives them after 30 steps: the window pass K3 in its three phases
   and the rank repair K4 (also against torch.argsort(stable=True)), timed;
4. main path: pyramid-140 and pyramid-20 from spawn through
   World.compile() and World.run(120) on cuda:0, then joint_farm(1000)
   and dam_break(100000) the same way, each timed after one warm run; then
   pyramid-8, joint_farm(8) and dam_break(1000) on the card against the
   same world on the CPU.
It then prints one JSON line describing the kernels (times beside their
roofline bound), and as its last line {"ok": true, "device": {...}}. There
is no CPU path: without a CUDA device it fails.
"""

import json
import math
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

MAIN_STEPS = 120        # joint_farm(1000)
PYRAMID_STEPS = 120     # the earlier paths
WARM_STEPS = 30
TIMED_CALLS = 20
# kernel vs twin: the kernel rounds each operation like the twin (built
# with -fmad=false); what differs is the order of float additions where
# lanes of the overflow tail share a body (atomicAdd vs index_add_)
ATOL, RTOL = 1e-5, 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# float operations of one lane in one stage, counted from the source
# (csrc/contact_solver.cu solve_lane, csrc/joint_sweep.cuh joint_lane: the
# longest branch; body integration per body per substep)
FLOP_CONTACT_LANE_STAGE = 260
FLOP_JOINT_LANE_STAGE = 220
FLOP_BODY_SUBSTEP = 45
# the particle path: dam_break at the size of bench.py's LiquidFun
# configuration (bench.py:223, BASELINE.json config 5)
PARTICLES = 100000
PARTICLE_STEPS = 120
# float operations of K3 (csrc/particles.cu window_kernel) per candidate in
# a neighbour range (the distance test) and per neighbour within one
# diameter, by phase (weight, pressure, damping)
FLOP_K3_CANDIDATE = 5
FLOP_K3_NEIGHBOUR = (7, 15, 23)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"using {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import particles_kernels as pk

    # one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        jobs = [ex.submit(cs.build), ex.submit(pk.build)]
        lib, plib = (j.result() for j in jobs)
    print(f"[build] both sources in {time.perf_counter() - t0:.2f} s")
    print(f"[build] nvcc sm_90a {cs.SOURCE} (+ {cs.JOINT_SOURCE}): "
          f"{cs.BUILD_SECONDS:.2f} s")
    for line in lib.ptxas_log.splitlines():
        if line.strip():
            print(f"[build] {line.strip()}")
    print(f"[build] nvcc sm_90a {pk.SOURCE}: {pk.BUILD_SECONDS:.2f} s")
    for line in plib.ptxas_log.splitlines():
        if line.strip():
            print(f"[build] {line.strip()}")


def _time_ms(fn):
    fn()
    times = []
    for _ in range(TIMED_CALLS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _bound_ms(args):
    """The least time the card could take for one call of the solver on
    these inputs: the larger of bytes over the memory rate (every input
    read once, every output written once, dead lanes not counted) and
    float operations over the float32 rate. Returns (ms, "bytes" or
    "operations")."""
    scalars, idx, data, acc, body, params, nsub = args[:7]
    joints = args[10] if len(args) > 10 else None
    live = int((idx[0] >= 0).sum())
    nb = body.shape[1]
    stages = 3 * nsub + 1
    # contact lane: 2 idx + 33 data + 9 acc in, 9 acc out; body 8 in, 8 out
    # and 12 params in
    nbytes = 4 * (live * (2 + 33 + 9 + 9) + nb * (8 + 8 + 12) + 8)
    flops = (live * stages * FLOP_CONTACT_LANE_STAGE
             + nb * nsub * FLOP_BODY_SUBSTEP)
    if joints is not None:
        jlive = int((joints.idx[0] >= 0).sum())
        nbytes += 4 * (jlive * (2 + 39 + 9 + 9 + 1) + joints.offsets.numel())
        flops += jlive * 3 * nsub * FLOP_JOINT_LANE_STAGE
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_vs_twin():
    """Kernel vs twin at the inputs the port's step packs. Timed cases are
    the main-path shapes after WARM_STEPS; the cases 0 and 2 steps from
    spawn hold a live overflow tail (a Jacobi window whose lanes share
    bodies), 0 steps its full two chunks."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes, world

    results = {}
    for rows, steps, timed in ((20, WARM_STEPS, True),
                               (140, WARM_STEPS, True),
                               (140, 2, False), (140, 0, False)):
        tag = f"pyramid-{rows} after {steps} steps"
        w = scenes.pyramid(rows=rows, device="cuda")
        w.compile()
        w.run(steps)
        step = w._step
        args = world._step_work(w.state, 1 / 60, w.capacity, step.classes,
                                step.substeps, step.continuous,
                                world.StepStats(), until="layout")
        idx, data, acc, body, l0, chunk = (args[1], args[2], args[3],
                                           args[4], args[8], args[7])
        kb, ka = cs.contact_solve(*args)
        tb, ta = cs.contact_solve_reference(*args)
        torch.cuda.synchronize()
        err_b = float((kb - tb).abs().max())
        err_a = float((ka - ta).abs().max())
        live = int((idx[0] >= 0).sum())
        tail = int((idx[0, l0:] >= 0).sum())
        warm = int((acc[0:2] != 0).any(0).sum())
        print(f"[kernel] {tag}: Nb={body.shape[1]} L={data.shape[1]}"
              f" chunk={chunk} live lanes={live} warm lanes={warm} live tail"
              f" lanes={tail} max_abs_err body={err_b:.3e} acc={err_a:.3e}")
        torch.testing.assert_close(kb, tb, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(ka, ta, atol=ATOL, rtol=RTOL)
        if steps >= 2:
            assert warm > 0, f"{tag}: warm impulses expected"
        if not timed:
            assert tail > 0, f"{tag}: a live overflow tail expected"
            results[(rows, steps)] = dict(err=max(err_b, err_a))
            continue
        ms = _time_ms(lambda: cs.contact_solve(*args))
        plain_ms = _time_ms(lambda: cs.contact_solve_reference(*args))
        bound_ms, bound_by = _bound_ms(args)
        print(f"[kernel] {tag}: median of {TIMED_CALLS} calls: "
              f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by})")
        results[(rows, steps)] = dict(err=max(err_b, err_a), ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by)
    return results


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


def phase_joint_kernel_vs_twin():
    """The kernel with a joint region against the twin, at the inputs the
    port's step packs: joint_farm(1000) after WARM_STEPS steps (timed) and
    the all-types scene after 8 steps (every joint branch; untimed)."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry, scenes, types, world
    from box2d_tpu_torch.api import World

    results = {}
    cases = (("joint_farm-1000", lambda: scenes.joint_farm(1000,
                                                           device="cuda"),
              WARM_STEPS, True),
             ("all-types", lambda: all_types_scene(World, types, geometry,
                                                   device="cuda"), 8, False))
    for name, make, steps, timed in cases:
        tag = f"{name} after {steps} steps"
        w = make()
        w.compile()
        w.run(steps)
        step = w._step
        args = world._step_work(w.state, 1 / 60, w.capacity, step.classes,
                                step.substeps, step.continuous,
                                world.StepStats(), until="layout",
                                joint_types=step.joint_types)
        idx, acc, body, jr = args[1], args[3], args[4], args[10]
        assert jr is not None, f"{tag}: no joint region was packed"
        kb, ka, kj = cs.contact_solve(*args)
        tb, ta, tj = cs.contact_solve_reference(*args)
        torch.cuda.synchronize()
        errs = [float((x - y).abs().max()) if x.numel() else 0.0
                for x, y in ((kb, tb), (ka, ta), (kj, tj))]
        jlive = int((jr.idx[0] >= 0).sum())
        jwarm = int((jr.acc != 0).any(0).sum())
        jtypes = sorted(set(jr.type[jr.idx[0] >= 0].tolist()))
        ncol = int((jr.offsets[1:] > jr.offsets[:-1]).sum())
        print(f"[kernel] {tag}: Nb={body.shape[1]} LJ={jr.data.shape[1]} "
              f"live joint lanes={jlive} in {ncol} colors, types {jtypes}, "
              f"warm joint lanes={jwarm}, live contact lanes="
              f"{int((idx[0] >= 0).sum())} max_abs_err body={errs[0]:.3e} "
              f"contact acc={errs[1]:.3e} joint acc={errs[2]:.3e}")
        for x, y in ((kb, tb), (ka, ta), (kj, tj)):
            torch.testing.assert_close(x, y, atol=ATOL, rtol=RTOL)
        assert jlive > 0, f"{tag}: live joint lanes expected"
        assert jwarm > 0, f"{tag}: warm joint impulses expected"
        assert float((kj - jr.acc).abs().max()) > 0, f"{tag}: nothing solved"
        res = dict(err=max(errs))
        if name == "all-types":
            assert jtypes == [0, 1, 4, 5, 7], (
                f"{tag}: joint types {jtypes}")
        if timed:
            res["ms"] = _time_ms(lambda: cs.contact_solve(*args))
            res["plain_ms"] = _time_ms(
                lambda: cs.contact_solve_reference(*args))
            res["bound_ms"], res["bound_by"] = _bound_ms(args)
            print(f"[kernel] {tag}: median of {TIMED_CALLS} calls: kernel "
                  f"{res['ms']:.4f} ms, twin {res['plain_ms']:.4f} ms, "
                  f"bound {res['bound_ms']:.6f} ms ({res['bound_by']})")
        results[name] = res
    return results


def _k3_bound_ms(args, phase):
    """Least time for one K3 call on these inputs: bytes (pos, keys and
    alive flags read once, p0 / p1 where the phase reads them, the (n, 2)
    output written once) against float operations (the distance test of
    every candidate in the three neighbour ranges of each live lane, the
    phase's terms for every neighbour within one diameter). Returns (ms,
    "bytes" or "operations", live lanes, candidates, neighbours, widest
    range)."""
    from box2d_tpu_torch import particles_kernels as pk

    pos, skey, alive = args[0], args[1], args[2]
    n = skey.shape[0]
    candidates = neighbours = widest = 0
    lane = torch.arange(n, device=pos.device)
    d2max = float(args[5][1])
    for start, end in pk.neighbour_ranges(skey, alive):
        width = end - start
        widest = max(widest, int(width.max()))
        candidates += int(width.sum())
        for k in range(int(width.max())):
            j = torch.clamp(start + k, max=n - 1)
            d = pos[j] - pos
            ok = ((start + k < end) & (j != lane) & alive[j]
                  & ((d * d).sum(dim=1) < d2max))
            neighbours += int(ok.sum())
    live = int(alive.sum())
    reads = (8 + 4 + 1) + 4 * (0, 1, 2)[phase]
    nbytes = n * (reads + 8) + 32
    flops = (candidates * FLOP_K3_CANDIDATE
             + neighbours * FLOP_K3_NEIGHBOUR[phase])
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return by + (live, candidates, neighbours, widest)


def phase_particle_kernels():
    """K3 and K4 against their twins at the inputs the port's
    dam_break(PARTICLES) step gives them: the three window passes of the
    first sub-iteration after WARM_STEPS steps, and the rank repair of the
    latest step up to then that took it (in this scene its jump
    precondition fails in every sub-iteration in which a particle falling
    past the tank crosses y = 0, where the cell key's row wraps: ROADMAP.md
    section 3). Launches made here do not count toward the main path."""
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.particles import particle_step

    w = scenes.dam_break(PARTICLES, device="cuda")
    w.compile()
    ranks, rank_step = [], None
    window_pass, rank_pass = pk.window_pass, pk.rank_pass
    for i in range(WARM_STEPS + 1):
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
        if i < WARM_STEPS:
            w.step(1 / 60)
    windows = windows[:3]
    assert [a[6] for a in windows] == [0, 1, 2], "K3 phases not recorded"
    assert ranks, f"the rank repair never engaged in {WARM_STEPS} steps"
    tag = f"dam_break-{PARTICLES} after {WARM_STEPS} steps"
    k3 = dict(err=0.0, ms=[], plain_ms=[], bound_ms=[], bound_by=set())
    for args, pname in zip(windows, ("weight", "pressure", "damping")):
        phase = args[6]
        kern = pk.window_pass(*args)
        twin = pk.window_pass_reference(*args)
        torch.cuda.synchronize()
        err = float((kern - twin).abs().max())
        bound_ms, bound_by, live, cand, neigh, widest = _k3_bound_ms(
            args, phase)
        ms = _time_ms(lambda: pk.window_pass(*args))
        plain_ms = _time_ms(lambda: pk.window_pass_reference(*args))
        print(f"[kernel] K3 {pname}, {tag}: n={args[1].shape[0]} live "
              f"lanes={live} candidates={cand} neighbours={neigh} widest "
              f"range={widest} max_abs_err={err:.3e}; median of "
              f"{TIMED_CALLS} calls: kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        # the twin sums each range in lane order like the kernel, and the
        # kernel is built with -fmad=false; the bound covers any order
        torch.testing.assert_close(kern, twin, atol=ATOL, rtol=RTOL)
        assert float(kern.abs().max()) > 0, f"K3 {pname}: all zero"
        k3["err"] = max(k3["err"], err)
        k3["ms"].append(ms)
        k3["plain_ms"].append(plain_ms)
        k3["bound_ms"].append(bound_ms)
        k3["bound_by"].add(bound_by)

    # the recorded repair that moves the most lanes
    ident = torch.arange(ranks[0][0].shape[0], dtype=torch.int32,
                         device=ranks[0][0].device)
    newkey, offs, rb = max(
        ranks, key=lambda a: int((pk.rank_pass_reference(*a) != ident).sum()))
    kern = pk.rank_pass(newkey, offs, rb)
    twin = pk.rank_pass_reference(newkey, offs, rb)

    def library():
        order = torch.argsort(newkey, stable=True)
        out = torch.empty_like(newkey)
        out[order] = torch.arange(newkey.shape[0], dtype=torch.int32,
                                  device=newkey.device)
        return out

    want = library()
    torch.cuda.synchronize()
    assert torch.equal(kern, twin), "K4 differs from its twin"
    assert torch.equal(kern, want), "K4 differs from the stable argsort"
    moved = int((want != ident).sum())
    n = newkey.shape[0]
    nbk = offs.shape[0]
    # the least the function needs, not the windowed count's work: keys and
    # offsets read once, ranks written once; one compare per lane to see it
    # is in order, and a binary search of the window per lane that moves
    nbytes = 4 * (2 * n + offs.numel())
    # (int32 compares, counted at the float32 rate: the card's published
    # peaks give no int32 rate)
    ops = n + moved * math.ceil(math.log2(rb))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    err = max(int((kern.long() - x.long()).abs().max()) for x in (twin, want))
    k4 = dict(err=err, ms=_time_ms(lambda: pk.rank_pass(newkey, offs, rb)),
              plain_ms=_time_ms(
                  lambda: pk.rank_pass_reference(newkey, offs, rb)),
              library_ms=_time_ms(library))
    k4["bound_ms"], k4["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                      else (t_ops, "operations"))
    print(f"[kernel] K4, dam_break-{PARTICLES} after {rank_step} steps "
          f"(the latest that took the repair): n={n} blocks={nbk} "
          f"window={rb} lanes that "
          f"move={moved}; max_abs_err={err} against its twin and "
          f"torch.argsort(stable=True); median of {TIMED_CALLS} calls: kernel "
          f"{k4['ms']:.4f} ms, twin {k4['plain_ms']:.4f} ms, argsort + "
          f"inverse scatter {k4['library_ms']:.4f} ms, bound "
          f"{k4['bound_ms']:.6f} ms ({k4['bound_by']})")
    return k3, k4


def _check_state(w, tag):
    """Finite leaves and a clean profile; returns (leaves, profile)."""
    from box2d_tpu_torch.state import state_to_numpy

    leaves = state_to_numpy(w.state)
    for k, v in leaves.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), f"{tag}: non-finite {k}"
    prof = {k.split(".", 1)[1]: int(v) for k, v in leaves.items()
            if k.startswith("profile.")}
    for k in ("overflow_pairs", "store_drops", "events_dropped"):
        assert prof[k] == 0, f"{tag}: profile.{k} = {prof[k]}"
    return leaves, prof


def _pyramid_check(leaves, tag):
    dyn = leaves["bodies.type"] == 2
    min_y = float(leaves["bodies.center"][dyn, 1].min())
    assert min_y >= 0.45, f"{tag}: a dynamic body sank to y={min_y}"
    return f"min dynamic y {min_y:.4f}"


def _joint_farm_check(leaves, tag):
    """Every revolute pivot holds (its two anchors under 0.05 m apart) and
    every body stays within 4 m of its ragdoll's static anchor (bodies come
    in fives: anchor, torso, arm, leg, ball)."""
    c = leaves["bodies.center"]
    q = leaves["bodies.rot"]
    lc = leaves["bodies.local_center"]
    ja, jb = leaves["joints.body_a"], leaves["joints.body_b"]

    def world_anchor(body, local):
        r = local - lc[body]
        qc, qs = q[body, 0], q[body, 1]
        return c[body] + np.stack([qc * r[:, 0] - qs * r[:, 1],
                                   qs * r[:, 0] + qc * r[:, 1]], 1)

    rev = leaves["joints.type"] == 3
    gap = np.linalg.norm(
        world_anchor(jb[rev], leaves["joints.frame_b_p"][rev])
        - world_anchor(ja[rev], leaves["joints.frame_a_p"][rev]), axis=1)
    assert rev.sum() > 0 and gap.max() < 0.05, (
        f"{tag}: a revolute pivot opened by {gap.max()} m")
    anchor = c[(np.arange(len(c)) // 5) * 5]
    reach = float(np.linalg.norm(c - anchor, axis=1).max())
    assert reach < 4.0, f"{tag}: a body is {reach} m from its anchor"
    imp = float(np.abs(leaves["joints.impulse"]).max())
    assert imp > 0, f"{tag}: no joint impulse was stored"
    return (f"max revolute pivot gap {gap.max():.5f} m; max reach "
            f"{reach:.3f} m; max |joint impulse| {imp:.4f}")


def phase_main_path():
    """Each main path from spawn: one warm run, then the timed run with the
    launch counts set to 0 just before it and read just after."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes

    paths = (
        ("pyramid-140", lambda: scenes.pyramid(rows=140, device="cuda"),
         PYRAMID_STEPS, _pyramid_check, False),
        ("pyramid-20", lambda: scenes.pyramid(rows=20, device="cuda"),
         PYRAMID_STEPS, _pyramid_check, False),
        ("joint_farm-1000", lambda: scenes.joint_farm(1000, device="cuda"),
         MAIN_STEPS, _joint_farm_check, True),
    )
    launches = {}
    for tag, make, steps, scene_check, jointed in paths:
        w = make()
        w.compile()
        n_dyn = int((w.state.bodies.type == 2).sum())
        state0 = w.state
        w.run(steps)               # warm run
        torch.cuda.synchronize()
        w.state = state0
        w.reset_stats()
        cs.LAUNCHES = 0
        cs.JOINT_LAUNCHES = 0
        t0 = time.perf_counter()
        w.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = w.stats
        n_launch, n_joint = cs.LAUNCHES, cs.JOINT_LAUNCHES
        leaves, prof = _check_state(w, tag)
        scene_note = scene_check(leaves, tag)
        work_steps = st.steps - st.idle_steps
        assert n_launch > 0, f"{tag}: the solver kernel was never launched"
        assert n_launch == work_steps, (
            f"{tag}: {n_launch} kernel launches for {work_steps} work steps")
        assert n_joint == (work_steps if jointed else 0), (
            f"{tag}: {n_joint} launches carried a joint region")
        assert st.ccd_gate_openings == 0, f"{tag}: CCD gate opened"
        sps = steps / wall
        print(f"[main] {tag}: {n_dyn} dynamic bodies, {steps} steps from"
              f" spawn in {wall:.3f} s: {sps:.2f} steps/s, "
              f"{sps * n_dyn:.1f} body-steps/s; syncs/step "
              f"{st.syncs / st.steps:.2f}; idle steps {st.idle_steps}; "
              f"kernel launches {n_launch} ({n_joint} with joints); ccd "
              f"gate openings {st.ccd_gate_openings}; {scene_note}; "
              f"final profile {prof}")
        launches[tag] = n_joint if jointed else n_launch

    launches.update(phase_particle_path())

    # the kernel path against the twin path on small worlds
    small = (
        ("pyramid-8", lambda d: scenes.pyramid(rows=8, device=d),
         (("bodies.center", 1e-4), ("bodies.v", 2e-3))),
        ("joint_farm-8", lambda d: scenes.joint_farm(8, device=d),
         (("bodies.center", 1e-4), ("bodies.v", 2e-3),
          ("joints.impulse", 5e-3), ("joints.motor_impulse", 5e-3),
          ("joints.spring_impulse", 5e-3), ("joints.lower_impulse", 5e-3),
          ("joints.upper_impulse", 5e-3))),
    )
    for tag, make, fields in small:
        ws = {}
        for dev in ("cuda", "cpu"):
            ws[dev] = make(dev)
            ws[dev].compile()
            ws[dev].run(20)
        for field, atol in fields:
            group, leaf = field.split(".")
            a = getattr(getattr(ws["cuda"].state, group), leaf).cpu()
            b = getattr(getattr(ws["cpu"].state, group), leaf)
            err = float((a - b).abs().max())
            print(f"[main] {tag} x20 steps, cuda vs cpu: max |d {field}| "
                  f"= {err:.3e} (bound {atol})")
            assert err <= atol, f"{tag} {field} differs by {err}"

    # dam_break(1000) for 20 steps, card vs CPU. K3 and its twin agree
    # bit for bit, but the rest of the step sums in other orders on the two
    # devices (the (n, 3) body-contact sums, the body-impulse sums), and a
    # collapsing column amplifies a last-bit difference over the steps:
    # positions within 1e-3, velocities within 1e-2
    ws = {}
    for dev in ("cuda", "cpu"):
        ws[dev] = scenes.dam_break(1000, device=dev)
        ws[dev].compile()
        ws[dev].run(20)
    a, b = ws["cuda"].state.particles, ws["cpu"].state.particles
    assert torch.equal(a.alive.cpu(), b.alive), "dam_break-1000: alive"
    for field, atol in (("pos", 1e-3), ("vel", 1e-2)):
        err = float((getattr(a, field).cpu() - getattr(b, field)).abs().max())
        print(f"[main] dam_break-1000 x20 steps, cuda vs cpu: max |d "
              f"particles.{field}| = {err:.3e} (bound {atol})")
        assert err <= atol, f"dam_break-1000 {field} differs by {err}"
    return launches


# the dam_break tank (box2d_tpu_torch/scenes.py dam_break): (center, half)
TANK = (((0.0, -0.25), (4.0, 0.25)), ((-4.0, 2.75), (0.25, 3.0)),
        ((4.0, 2.75), (0.25, 3.0)))


def phase_particle_path():
    """dam_break(PARTICLES) from spawn: one warm run, then the timed run of
    PARTICLE_STEPS steps with the launch counts set to 0 just before it and
    read just after."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes

    tag = f"dam_break-{PARTICLES}"
    w = scenes.dam_break(PARTICLES, device="cuda")
    w.compile()
    state0 = w.state
    n_live = int(state0.particles.alive.sum())
    w.run(PARTICLE_STEPS)            # warm run
    torch.cuda.synchronize()
    w.state = state0
    w.reset_stats()
    cs.LAUNCHES = 0
    pk.K3_LAUNCHES = 0
    pk.K4_LAUNCHES = 0
    t0 = time.perf_counter()
    w.run(PARTICLE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = w.stats
    k3, k4, n_solve = pk.K3_LAUNCHES, pk.K4_LAUNCHES, cs.LAUNCHES
    leaves, prof = _check_state(w, tag)
    rigid = st.steps - st.idle_steps
    assert k3 == 12 * PARTICLE_STEPS, f"{tag}: {k3} K3 launches"
    assert k4 > 0, f"{tag}: the rank repair K4 was never launched"
    assert k4 == st.rank_repairs, f"{tag}: {k4} K4 launches"
    assert k4 + st.full_sorts == 4 * PARTICLE_STEPS
    assert prof["overflow_particles"] == 0, f"{tag}: particle overflow"
    assert n_solve == rigid, f"{tag}: {n_solve} solver launches"
    assert st.ccd_gate_openings == 0, f"{tag}: CCD gate opened"
    alive = leaves["particles.alive"]
    assert alive.all() and alive.sum() == n_live, f"{tag}: particles died"
    pos = leaves["particles.pos"]
    # no tunnelling: no live particle ends inside a tank box shrunk by the
    # radius. The 316 x 316 grid of the JAX scene is 23.7 m wide, wider
    # than the 8 m tank, so some of its particles spawn inside the right
    # wall; they are counted, and must have been pushed out by the end
    r = float(leaves["particles.params.radius"])
    spawn = state0.particles.pos.cpu().numpy()

    def in_tank_box(p):
        hit = np.zeros(len(p), bool)
        for (cx, cy), (hx, hy) in TANK:
            hit |= ((np.abs(p[:, 0] - cx) < hx - r)
                    & (np.abs(p[:, 1] - cy) < hy - r))
        return hit

    born_inside = in_tank_box(spawn)
    now_inside = in_tank_box(pos)
    tunnelled = int((now_inside & ~born_inside).sum())
    assert tunnelled == 0, f"{tag}: {tunnelled} particles tunnelled"
    assert not now_inside.any(), (
        f"{tag}: {int(now_inside.sum())} particles inside a tank wall")
    in_tank = ((np.abs(pos[:, 0]) < 4.0) & (pos[:, 1] > 0.0)
               & (pos[:, 1] < 5.75))
    sps = PARTICLE_STEPS / wall
    print(f"[main] {tag}: {n_live} live particles, {PARTICLE_STEPS} steps "
          f"from spawn in {wall:.3f} s: {sps:.2f} steps/s, "
          f"{sps * n_live:.1f} particle-steps/s; syncs/step "
          f"{st.syncs / st.steps:.2f}; K3 launches {k3} "
          f"({k3 / PARTICLE_STEPS:.0f}/step); K4 launches {k4}, full sorts "
          f"{st.full_sorts}; rigid steps run {rigid}, skipped "
          f"{st.idle_steps}; solver launches {n_solve}; overflow_particles "
          f"{prof['overflow_particles']}; spawned inside a tank box "
          f"{int(born_inside.sum())}, inside one now "
          f"{int(now_inside.sum())}, tunnelled 0; between the walls now "
          f"{int(in_tank.sum())}")
    return {"particle_window": k3, "particle_rank": k4}


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernel_vs_twin()
    jkern = phase_joint_kernel_vs_twin()
    k3, k4 = phase_particle_kernels()
    launches = phase_main_path()
    big = kern[(140, WARM_STEPS)]
    farm = jkern["joint_farm-1000"]
    mean = statistics.fmean
    # no single PyTorch call computes either function (a persistent
    # multi-stage constraint solve), so library_ms is null
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "contact_solve",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/contact_solver.cu",
        "replaces": "box2d_tpu/solver_pallas.py:101 (_solver_kernel), "
                    "box2d_tpu/solver_pallas.py:1250 (_tiled_kernel)",
        "launches": launches["pyramid-140"],
        "max_abs_err": max(r["err"] for r in kern.values()),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
    }, {
        "name": "joint_sweep",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/joint_sweep.cuh",
        "replaces": "box2d_tpu/solver_pallas.py:681 (_joint_sweep)",
        "launches": launches["joint_farm-1000"],
        "max_abs_err": max(r["err"] for r in jkern.values()),
        "ms": farm["ms"],
        "plain_ms": farm["plain_ms"],
        "bound_ms": farm["bound_ms"],
        "bound_by": farm["bound_by"],
        "library_ms": None,
    }, {
        # per launch: the mean over its three phases (weight, pressure,
        # damping); no single PyTorch call computes a neighbour sum
        "name": "particle_window",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/particles.cu",
        "replaces": "box2d_tpu/particles_pallas.py:396 (window_pass)",
        "launches": launches["particle_window"],
        "max_abs_err": k3["err"],
        "ms": mean(k3["ms"]),
        "plain_ms": mean(k3["plain_ms"]),
        "bound_ms": mean(k3["bound_ms"]),
        "bound_by": "/".join(sorted(k3["bound_by"])),
        "library_ms": None,
    }, {
        # library: torch.argsort(stable=True) and the inverse scatter
        "name": "particle_rank",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/particles.cu",
        "replaces": "box2d_tpu/particles_pallas.py:356 (rank_pass)",
        "launches": launches["particle_rank"],
        "max_abs_err": k4["err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
