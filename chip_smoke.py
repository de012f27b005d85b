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
   pyramid-140 0 and 2 steps from spawn (a live overflow tail; at 0 steps
   two 2,560-lane Jacobi windows) and pyramid-20 with three color buckets
   moved into its tail (three 128-lane windows), and with joints:
   joint_farm(1000) after 30 steps (timed), an all-types scene (weld,
   wheel, motor, mouse, distance spring with limits and motor) and a hub
   whose joint colors overflow; each case prints the kernel's live
   windows per stage, its launch shape (one thread-block cluster) and
   what ptxas reported for the kernel instance it ran; untimed, also at
   the inputs of tumbler(2000) after 120 steps and bullet_barrage(100) at
   its last TOI sweep step in the first 30; every case launched twice,
   the two equal bit for bit;
   then the particle kernels at the inputs the port's dam_break(100000)
   step gives them after 30 steps: the window pass K3 in its three phases
   and the rank repair K4 (also against torch.argsort(stable=True)),
   timed; K3 also on tables that send blocks down its global-memory path,
   K4 also on a run of equal keys and on tables whose every lane moved,
   at both window sizes;
4. main path: pyramid-140 and pyramid-20 from spawn through
   World.compile() and World.run(120) on cuda:0, then joint_farm(1000)
   and dam_break(100000) the same way, each timed after one warm run; then
   pyramid-8, joint_farm(8) and dam_break(1000) on the card against the
   same world on the CPU; then the continuous-collision paths,
   bullet_barrage(100) (the CCD gate opens, TOI sweeps run, no CCD
   overflow, every bullet that spawns below the walls' top stops left of
   the first wall's far face, one solver launch per work step) and
   tumbler(2000) (the gate never opens), 120 steps each from spawn after
   one warm run that reads every step's profile, and bullet_barrage(8)
   and a chain-loop ground with a sensor box and falling shapes
   (port_fixtures.chain_sensor_scene), 20 steps each, on the card against
   the CPU.
5. queries and host API: pyramid-140 after 120 steps, with the scene
   queries (1,024 rays closest and all-hits, 256 points, an AABB, a box
   overlap and cast, the mover for 120 frames into the pile, an
   explosion) each on the card and on a CPU copy of the same state,
   printed with their device times, launches and reads; pyramid-140 with
   2,048 spare lanes: 2,000 runtime spawns, 1,000 destroys, type flips
   and filter changes, the solver kernel against its twin after the
   spawns, validate() and counters(); joint_farm(1000) with every
   revolute joint retargeted at runtime (the joint kernel against its
   twin after the setters); a scripted API sequence on pyramid-8 (spawns,
   a runtime chain, destroys, a type flip, filters, a custom filter, a
   one-way pre_solve, joint setters, an explosion, run(collect_events=
   True)) and a 4,096-particle tank with a circle and a capsule, each on
   the card against the CPU.
6. batching: 64 x pyramid-20 as a batch of worlds (make_batched_step,
   Capacity.batched, bp_repair_cap 0: the JAX package's vmapped bench),
   120 steps from spawn after one warm run, one solver launch a step for
   all 64 worlds, each batched launch through the kernel its capacity's
   plan picks (contact_solver.batched_plan: every batch below but one
   takes the small-world kernel, a group of warps a world; the count of
   launches it took is held to the batched launches); that launch
   against 64 single-world launches (bit for bit) and its twin, each
   launched ten times (every launch equal to the first, bit for bit), on
   a perturbed batch's inputs at spawn
   (a live Jacobi window in every world's tail) and after 30 steps, and
   with three buckets moved into every world's tail for three seeds,
   then timed; worlds 0 and 63 of a perturbed batch held to the single-world
   step in lockstep, and a batch of identical worlds staying identical,
   bit for bit, running free and in lockstep; (e) the RL loop of
   tests/test_rl_demo.py as a batch of 64 joint_farm(1) worlds (the
   default repair tier), a torso motor speed a world written into the
   (W, J) joint arrays every step, 256 steps from spawn after a warm
   run of 30: one jointed solver launch (solve_small_kernel<true>) a
   work step, the actions splitting the torsos by parity; that launch against
   64 single launches and itself (bit for bit) and its twin, ten times
   each, at a perturbed seed and on three hub worlds whose joint
   coloring overflows in two and not in the third, then timed against
   the 64 single launches; (f) the same at 1,024 worlds, 120 steps, the
   batched launch once against the 1,024 single launches (bit for bit),
   timed, with the worlds the card holds at once; (g) 64 perturbed
   api_scene worlds
   (every joint type, a sensor box, a filtered box, an open chain, every
   event kind on) with both hooks of tests/test_torch_api.py and the
   default repair tier, 60 steps, worlds 0-2 and 63 held to the
   single-world step in lockstep at every step and all 64 at the last
   (1e-5; events, pairs and tiers equal), a repair tier
   taken and pairs dropped by the filter; 4 x pyramid-60 and 4 x
   joint_farm(300), whose capacities keep the cluster kernel (both its
   batched instances), each launch against its 4 single launches and
   itself (bit for bit) and its twin; each batched launch against
   single launches prints its path, threads a world, worlds a CTA,
   resident CTAs, what ptxas said of the instance, and its time beside
   world 0's single launch and beside the other kernel's on the same
   arrays (equal bit for bit);
   then the flat batches (scenes.replicate) 64 x pyramid-20 and 1,024 x
   pyramid-8 through the solver kernel, the RL loop (64 x joint_farm(1),
   128 steps, per-world motor speeds written on the card) through the
   joint sweep, and 64 x dam_break(500) and 8 x dam_break(12000) through
   K3 and K4 with per-block shape culling (a culled step held to the
   CPU's, overflow count included; at 64 x dam_break(500) the culled
   coupling held to the dense one with slots enough for every block);
   then the vmapped particle worlds (make_batched_step with a
   particle_cfg): (h) 64 x dam_break(500) for 120 steps and (i) 8 x
   dam_break(12000) for 60, each world perturbed (particles jittered,
   pressure, damping and density scaled apart), from spawn after a warm
   run: one batched K3 launch a phase for all worlds (12 a step), no K4,
   each on the kernel particles_kernels.k3_batched_plan picks for the
   width of a world's table (the small-world kernel at (h), counted; the
   grid kernel at (i), whose table does not fit it); steps/s,
   particle-steps/s, reads, launches and the device's idle share a step
   beside the flat batch of the same size; the batched launch against
   its W single launches, itself and the other kernel on the same arrays
   (bit for bit) and its twin (1e-5), timed on both kernels; the same
   checks on K3 batched's stress tables (port_fixtures.k3_batched_table:
   dead lanes, a field across y = 0, one dense cell, a world with no live
   particle; 1, 64 and 1,024 worlds of a few hundred lanes and 8 of the
   widest table the small kernel takes); worlds 0, 1 and W - 1 in
   lockstep with the single-world step for 30 steps (counts, alive and
   overflow equal, floats 1e-5);
   and 8 worlds of every_gate_tank(600) (groups, a barrier, a box) equal
   bit for bit to the single-world gated step, running free, at each of
   10 steps, one batched solver launch a rigid work step.
7. particle groups (the gated particle path: the windowed neighbour
   pipeline and every flag-gated pass, no K3 or K4; the tank's boxes
   through the solver kernel): (a) groups_tank(100000), BASELINE.json
   config 5 (water, viscous and elastic groups, ten boxes on top), 120
   steps from spawn through World.compile() and World.run(120) after one
   warm run: particle-steps/s, reads, launches and device time a step,
   overflow, pairs and triads, the elastic group's mean triad shape
   error, no particle more than a diameter below the ground's top and no
   box through it, and one step from spawn, one after 30 and one after
   120 steps held to a CPU World within 1e-4 (particles and bodies), the
   particle step alone from the same states equal bit for bit (its body
   impulses, overflow, positions and velocities); (b) every_gate_tank(4096)
   (every particle flag, spring, elastic and barrier groups, a solid and
   a rigid group) 20 steps on the card against the CPU in lockstep
   within 1e-4 (particles and bodies), the particle step alone from each
   lockstep state equal bit for bit, the free-running gap printed; (c)
   the six particle methods of World on that tank, card against CPU
   (discrete results exact, floats 1e-5); (d) repeatability: the world
   step run twice from one state on the card, the distance between the
   two results, particles and the rest of the state, required 0.
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

from port_fixtures import (PARTICLE_API, all_types_scene, api_scene,
                           api_sequence, chain_sensor_scene, every_gate_tank,
                           groups_tank, hub_scene, K3_KINDS,
                           k3_batched_table, k3_table, library_rank,
                           QUEUE_CYCLES, median_ms, move_buckets_to_tail,
                           obstacle_tank, other_plan,
                           particle_api_case, perturbed_leaves, rank_table,
                           record_batched_k3, record_particle_calls,
                           with_all_events)

MAIN_STEPS = 120        # joint_farm(1000)
PYRAMID_STEPS = 120     # the earlier paths
WARM_STEPS = 30
TIMED_CALLS = 20
# kernel vs twin: the kernel rounds each operation like the twin (built
# with -fmad=false); what differs is how the deltas are summed where lanes
# of a Jacobi window (the overflow tail, the overflow color's joint
# windows) share a body: fixed point in the kernel, index_add_'s float
# adds in the twin. Those sums do not depend on the order the kernel's
# lanes add in, so two launches on the same inputs, and a world of a
# batched launch against its single launch, must agree bit for bit
ATOL, RTOL = 1e-5, 1e-4
SMEM_OPT_IN = 232448    # the H100's opt-in shared memory a CTA (227 KB)
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
# the hub scenes' joints: 16 colored, the rest (135-195 of each of three
# types) in the overflow color, more than one window of each type; with
# 420 every pass fits in one CTA (the call runs on CTA 0), with 600 the
# bodies do not (it runs on the whole cluster)
HUB_SPOKES = (420, 600)
# the color buckets of pyramid-20's layout moved into its overflow tail for
# the tail case: 272 lanes after 30 steps, three 128-lane Jacobi windows
TAIL_BUCKETS = 3
# float operations of K3 (csrc/particles.cu window_kernel) per candidate in
# a neighbour range (the distance test) and per neighbour within one
# diameter, by phase (weight, pressure, damping)
FLOP_K3_CANDIDATE = 5
FLOP_K3_NEIGHBOUR = (7, 15, 23)
# the continuous-collision paths: bench.py's bullet_barrage and tumbler
# configurations (bench.py:216-223, BASELINE.json configs 4 and 2)
BARRAGE_BULLETS = 100
TUMBLER_BOXES = 2000
CCD_STEPS = 120
# scenes.bullet_barrage: the walls stand from y = 0 to 10, the first one
# centred at x = 20 with a half width of 0.05
WALL_TOP = 10.0
FIRST_WALL_FAR_FACE = 20.05
# scenes.tumbler: the drum's axis and the distance of its inner walls
DRUM_AXIS_Y = 10.0
DRUM_INNER = 9.5
SMALL_STEPS = 20
# the leaves phase 7 holds to the CPU after one world step
ONE_STEP_FIELDS = ("particles.pos", "particles.vel", "bodies.center",
                   "bodies.rot", "bodies.v", "bodies.w")
PARTICLE_TANK = 4096
# batching: bench.py's vmapped batch (measure_batch, :116-171) and flat
# batches (:174-205, :236-243), and the RL loop of tests/test_rl_demo.py
BATCH_WORLDS = 64
BATCH_ROWS = 20
BATCH_STEPS = 120
LOCKSTEP_STEPS = 20
# the batched launch's Jacobi checks: perturbed batches from these seeds,
# each case launched this many times (batched and single alike). World w
# of a batch is jittered from seed + w, so seeds BATCH_WORLDS apart share
# no world
JACOBI_SEEDS = (7, 7 + BATCH_WORLDS, 7 + 2 * BATCH_WORLDS)
JACOBI_REPEATS = 10
FLAT = ((64, 20), (1024, 8))
FLAT_STEPS = 60
RL_WORLDS = 64
RL_STEPS = 256
FLAT_RL_STEPS = 128     # the RL loop on a flat batch (phase 6)
# the vmapped jointed, sensor and hooked worlds: the RL loop as a batch of
# worlds (tests/test_rl_demo.py:24-25), the same at 1,024 worlds, and
# port_fixtures.api_scene with every event kind, both hooks of
# tests/test_torch_api.py and the default repair tier; API_LOCKSTEP's
# worlds held to the single-world step in lockstep at each step, and all
# worlds at the last
RL_BIG_WORLDS = 1024
RL_BIG_STEPS = 120
API_WORLDS = 64
API_STEPS = 60
API_KICK = (1, 7, (2.0, 1.0))
API_ASLEEP = 2
API_LOCKSTEP = (0, 1, 2, API_WORLDS - 1)
API_THRESHOLD = 0.5
FLAT_PARTICLES = ((64, 500), (8, 12000))
FLAT_PARTICLE_STEPS = 30
# the culled coupling against the dense one, the CPU test's bound
# (tests/test_particles.py test_block_culled_body_coupling_matches_dense)
CULL_RTOL, CULL_ATOL = 1e-5, 5e-5
# the vmapped particle worlds, phase 6 (h) and (i): bench.py's two flat
# particle batches (:173-186, :238-241) as batches of worlds (worlds,
# particles a world, timed steps), each world a perturbed dam_break (its
# particles jittered, its pressure, damping and density scaled apart by up
# to VPART_SPREAD), stepped through make_batched_step; the worlds of
# VPART_LOCKSTEP held to the single-world step in lockstep for
# VPART_LOCKSTEP_STEPS steps. Then the gated batch: VPART_GATED worlds of
# port_fixtures.every_gate_tank at a small count, running free beside
# the single-world gated step for VPART_GATED_STEPS steps
VPART = ((64, 500, 120), (8, 12000, 60))
VPART_WARM = 5
VPART_SPREAD = 0.2
VPART_LOCKSTEP_STEPS = 30
VPART_GATED = (8, 600)
VPART_GATED_STEPS = 10
# K3 batched's stress tables (port_fixtures.k3_batched_table): (worlds,
# lanes a world); the last is the widest table the small kernel takes
VPART_STRESS = ((1, 300), (64, 200), (1024, 200), (8, None))


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

    from box2d_tpu_torch import native

    # one nvcc per source and the g++ of the host builders, started
    # together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(cs.build), ex.submit(pk.build),
                ex.submit(native.load)]
        lib, plib, _ = (j.result() for j in jobs)
    print(f"[build] both sources and {native.SOURCE} (g++) in "
          f"{time.perf_counter() - t0:.2f} s")
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
    return median_ms(fn, TIMED_CALLS)


def _bound_ms(args):
    """The least time the card could take for one call of the solver on
    these inputs: the larger of bytes over the memory rate (every input
    read once, every output written once, dead lanes not counted) and
    float operations over the float32 rate. Returns (ms, "bytes" or
    "operations")."""
    scalars, idx, data, acc, body, params, nsub = args[:7]
    joints = args[11]
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
    return _bound_of(nbytes, flops)


def _ptxas_kernels(log):
    """What `ptxas -v` reported for each instance of the solver kernel:
    registers, static shared memory and spill stores / loads. Keyed by
    whether it holds the joint sweep (the single-world instances),
    "batched" and "batched_joints" for the cluster kernel's batched ones,
    and "small" and "small_joints" for the small-world kernel's."""
    instances = {"solve_kernelILb0ELb0E": False,
                 "solve_kernelILb1ELb0E": True,
                 "solve_kernelILb0ELb1E": "batched",
                 "solve_kernelILb1ELb1E": "batched_joints",
                 "solve_small_kernelILb0E": "small",
                 "solve_small_kernelILb1E": "small_joints"}
    out, entry, props = {}, None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props["name"] = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line and props.get("name"):
            props[props.pop("name")] = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used", 1)[1].split(",")
            smem = next((x.strip() for x in regs if "smem" in x),
                        "0 bytes smem")
            spill = props.get(entry, "no spill line")
            key = next((v for k, v in instances.items() if k in entry),
                       None)
            if key is not None:
                out[key] = f"{regs[0].strip()}, {smem}, {spill}"
            entry = None
    return out


def _window_stats(args):
    """The kernel's window table at these inputs
    (contact_solver.window_table): per stage, its colored windows (a
    color's joint segment with its contact bucket; one barrier each) and
    Jacobi windows (the overflow tail, the overflow color's joint windows;
    two barriers each); over the call, the serial windows and the barriers
    after the prologue (one after each integration pass); and the widest
    pass, which decides whether the call runs on the whole cluster or on
    one CTA (csrc/contact_solver.cu)."""
    from box2d_tpu_torch import contact_solver as cs

    joints = args[11]
    table = cs.window_table(args[1], *args[7:12])
    stages = 3 * args[6] + 1
    out = dict(windows=0, barriers=0)
    for k in range(stages):
        p = 3 if k == stages - 1 else k % 3
        ents = [e for e in table if p != 3 or not e[0].startswith("joint")]
        colored = len({c for kind, c, _, _ in ents
                       if kind in ("joint", "contact")})
        jacobi = sum(kind in ("joint_jacobi", "tail") for kind, *_ in ents)
        out["solve" if p != 3 else "restitution"] = (colored, jacobi)
        out["windows"] += colored + jacobi
        out["barriers"] += colored + 2 * jacobi + (p in (0, 2))
    # the kernel's rule: a color's live contact lanes plus its whole joint
    # segment, a tail window, the bodies
    width = {}
    for kind, c, lo, hi in table:
        if kind in ("contact", "tail"):
            width[c] = max(width.get(c, 0), hi - lo)
    if joints is not None:
        off = joints.offsets.tolist()
        for c in range(args[9]):
            width[c] = width.get(c, 0) + off[c + 1] - off[c]
    out["widest"] = max([args[4].shape[1]] + list(width.values()))
    return out


def _kernel_note(args, lib):
    """One line on the launch these inputs get: windows, launch shape, where
    the call runs, and what ptxas said of the kernel instance."""
    from box2d_tpu_torch import contact_solver as cs

    joints = args[11] is not None
    st = _window_stats(args)
    shape = cs.launch_shape(joints)
    assert shape["cluster"] >= 2, f"launch shape {shape}"
    where = ("the whole cluster, behind cluster barriers"
             if st["widest"] > shape["threads"] else
             "CTA 0 alone (every pass fits in one CTA), behind block "
             "barriers")
    ptx = _ptxas_kernels(lib.ptxas_log).get(joints, "not reported")
    return (f"live windows per solve stage {st['solve'][0]} colored + "
            f"{st['solve'][1]} Jacobi, restitution stage "
            f"{st['restitution'][0]} + {st['restitution'][1]}; "
            f"{st['windows']} serial windows and {st['barriers']} barriers "
            f"a call; launch: 1 cluster of {shape['cluster']} CTAs x "
            f"{shape['threads']} threads ({shape['max_active_clusters']} "
            f"such clusters fit on the card), widest pass {st['widest']} "
            f"lanes, so the call runs on {where}; ptxas "
            f"solve_kernel<{str(joints).lower()}>: {ptx}"), st


def _tail_windows(args):
    from box2d_tpu_torch import contact_solver as cs

    return [hi - lo for kind, _, lo, hi in
            cs.window_table(args[1], *args[7:12]) if kind == "tail"]


def phase_kernel_vs_twin():
    """Kernel vs twin at the inputs the port's step packs. Timed cases are
    the main-path shapes after WARM_STEPS. The overflow tail's lanes share
    bodies and are swept as Jacobi windows of tail_w lanes in sequence: at
    pyramid-140 0 and 2 steps from spawn (0 steps: two full 2,560-lane
    windows), and in pyramid-20's layout after WARM_STEPS steps with its
    first TAIL_BUCKETS color buckets moved into the tail (several 128-lane
    windows). Then, untimed, the layouts of the continuous-collision
    paths: tumbler(TUMBLER_BOXES) after CCD_STEPS steps and
    bullet_barrage(BARRAGE_BULLETS) at a step whose TOI sweep ran. Where a
    Jacobi window's lanes share a body the kernel's fixed-point sums round
    otherwise than the twin's float adds, so those cases are held to
    ATOL / RTOL; the rest must agree bit for bit."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes, world

    results = {}
    for rows, steps, timed in ((20, WARM_STEPS, True),
                               (140, WARM_STEPS, True),
                               (140, 2, False), (140, 0, False),
                               (20, "tail", False)):
        tag = (f"pyramid-{rows} after {steps} steps" if steps != "tail" else
               f"pyramid-{rows} after {WARM_STEPS} steps, {TAIL_BUCKETS} "
               f"buckets moved into the tail")
        w = scenes.pyramid(rows=rows, device="cuda")
        w.compile()
        w.run(WARM_STEPS if steps == "tail" else steps)
        step = w._step
        args = world._step_work(w.state, 1 / 60, w.capacity, step.classes,
                                step.substeps, step.continuous,
                                world.StepStats(), until="layout")
        assert args[10] == step.tail_w
        if steps == "tail":
            args = move_buckets_to_tail(args, range(TAIL_BUCKETS),
                                        TAIL_BUCKETS * args[7])
        err, live, tail, tail_windows, warm, wst = _kernel_vs_twin(tag, args)
        if steps != 0:
            assert warm > 0, f"{tag}: warm impulses expected"
        if steps == 0 or steps == "tail":
            assert len(tail_windows) >= {0: 2, "tail": 3}[steps], (
                f"{tag}: the tail spans {len(tail_windows)} windows")
        if not timed:
            assert tail > 0, f"{tag}: a live overflow tail expected"
            results[(rows, steps)] = dict(err=err)
            continue
        ms = _time_ms(lambda: cs.contact_solve(*args))
        plain_ms = _time_ms(lambda: cs.contact_solve_reference(*args))
        bound_ms, bound_by = _bound_ms(args)
        print(f"[kernel] {tag}: median of {TIMED_CALLS} calls: "
              f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by})")
        print(f"[kernel] {tag}: {ms / wst['windows'] * 1e3:.3f} us per "
              f"serial window")
        results[(rows, steps)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)

    # the continuous-collision paths' own layouts: tumbler's (kinematic
    # drum bodies among the body rows, a pair buffer rebuilt every step)
    # after CCD_STEPS (its boxes fall for about 60 steps before they
    # touch), and bullet_barrage's at its last step in the first
    # WARM_STEPS whose TOI sweep ran (bullets stopped at the first wall)
    for tag, make, steps, at_sweep in (
            (f"tumbler-{TUMBLER_BOXES}",
             lambda: scenes.tumbler(TUMBLER_BOXES, device="cuda"),
             CCD_STEPS, False),
            (f"bullet_barrage-{BARRAGE_BULLETS}",
             lambda: scenes.bullet_barrage(BARRAGE_BULLETS, device="cuda"),
             WARM_STEPS, True)):
        w = make()
        w.compile()
        swept = None
        for _ in range(steps):
            before = (w.state, w.stats.toi_pairs)
            w.step()
            if w.stats.toi_pairs > before[1]:
                swept = before[0]
        if at_sweep:
            assert swept is not None, (
                f"{tag}: no TOI sweep ran in {steps} steps")
            state, where = swept, "at its last TOI sweep step"
        else:
            state, where = w.state, f"after {steps} steps"
        step = w._step
        args = world._step_work(state, 1 / 60, w.capacity, step.classes,
                                step.substeps, step.continuous,
                                world.StepStats(), until="layout")
        assert args[10] == step.tail_w
        err, live, tail, _, warm, _ = _kernel_vs_twin(f"{tag} {where}", args)
        assert live > 0, f"{tag}: live contact lanes expected"
        results[tag] = dict(err=err)
    return results


def _same_twice(tag, args, first):
    """Launch the solver kernel again on `args` and hold it to `first`, the
    outputs of an earlier launch, bit for bit: its Jacobi sums are fixed
    point, so no order of its atomics shows."""
    from box2d_tpu_torch import contact_solver as cs

    again = cs.contact_solve(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y), (
            f"{tag}: two launches on the same inputs differ by "
            f"{float((x - y).abs().max()):.3e}")


def _kernel_vs_twin(tag, args):
    """The solver kernel and its twin on the same inputs: prints the
    layout and the error, holds them to ATOL / RTOL, and bit for bit where
    no lane is in the overflow tail; a second launch must give the same
    bits. Returns (error, live lanes, live tail lanes, tail windows, warm
    lanes, window stats)."""
    from box2d_tpu_torch import contact_solver as cs

    idx, data, acc, body, l0, chunk = (args[1], args[2], args[3], args[4],
                                       args[8], args[7])
    kb, ka = cs.contact_solve(*args)
    tb, ta = cs.contact_solve_reference(*args)
    _same_twice(tag, args, (kb, ka))
    err_b = float((kb - tb).abs().max())
    err_a = float((ka - ta).abs().max())
    live = int((idx[0] >= 0).sum())
    tail = int((idx[0, l0:] >= 0).sum())
    tail_windows = _tail_windows(args)
    warm = int((acc[0:2] != 0).any(0).sum())
    note, wst = _kernel_note(args, cs.build())
    print(f"[kernel] {tag}: Nb={body.shape[1]} L={data.shape[1]}"
          f" chunk={chunk} live lanes={live} warm lanes={warm} live tail"
          f" lanes={tail} in {len(tail_windows)} windows of at most "
          f"{args[10]} lanes {tail_windows} max_abs_err body={err_b:.3e}"
          f" acc={err_a:.3e}")
    print(f"[kernel] {tag}: {note}")
    torch.testing.assert_close(kb, tb, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(ka, ta, atol=ATOL, rtol=RTOL)
    if tail == 0:
        # no window shares a body: each body gets its lanes' deltas in the
        # twin's order, so the two agree bit for bit
        assert err_b == 0.0 and err_a == 0.0, f"{tag}: not bit-exact"
    return max(err_b, err_a), live, tail, tail_windows, warm, wst


def phase_joint_kernel_vs_twin():
    """The kernel with a joint region against the twin, at the inputs the
    port's step packs: joint_farm(1000) after WARM_STEPS steps (timed), the
    all-types scene after 8 steps (every joint branch; untimed) and the
    hubs of HUB_SPOKES joints after 8 steps (the overflow color's joints,
    swept as kind-pure Jacobi windows, some cut at the window width;
    untimed)."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry, scenes, types, world
    from box2d_tpu_torch.api import World

    results = {}
    cases = (("joint_farm-1000", lambda: scenes.joint_farm(1000,
                                                           device="cuda"),
              WARM_STEPS, True),
             ("all-types", lambda: all_types_scene(World, types, geometry,
                                                   device="cuda"), 8, False),
             *((f"hub-{n}", lambda n=n: hub_scene(
                 World, types, geometry, spokes=n, device="cuda"), 8, False)
               for n in HUB_SPOKES))
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
        idx, acc, body, jr = args[1], args[3], args[4], args[11]
        assert jr is not None, f"{tag}: no joint region was packed"
        kb, ka, kj = cs.contact_solve(*args)
        tb, ta, tj = cs.contact_solve_reference(*args)
        _same_twice(tag, args, (kb, ka, kj))
        errs = [float((x - y).abs().max()) if x.numel() else 0.0
                for x, y in ((kb, tb), (ka, ta), (kj, tj))]
        jlive = int((jr.idx[0] >= 0).sum())
        jwarm = int((jr.acc != 0).any(0).sum())
        jtypes = sorted(set(jr.type[jr.idx[0] >= 0].tolist()))
        ncol = int((jr.offsets[1:] > jr.offsets[:-1]).sum())
        note, wst = _kernel_note(args, cs.build())
        print(f"[kernel] {tag}: Nb={body.shape[1]} LJ={jr.data.shape[1]} "
              f"live joint lanes={jlive} in {ncol} colors, types {jtypes}, "
              f"warm joint lanes={jwarm}, live contact lanes="
              f"{int((idx[0] >= 0).sum())} live tail lanes="
              f"{int((idx[0, args[8]:] >= 0).sum())} coloring overflowed="
              f"{jr.overflow} max_abs_err body={errs[0]:.3e} "
              f"contact acc={errs[1]:.3e} joint acc={errs[2]:.3e}")
        print(f"[kernel] {tag}: {note}")
        for x, y in ((kb, tb), (ka, ta), (kj, tj)):
            torch.testing.assert_close(x, y, atol=ATOL, rtol=RTOL)
        if not jr.overflow and not (idx[0, args[8]:] >= 0).any():
            assert max(errs) == 0.0, f"{tag}: not bit-exact"
        assert jlive > 0, f"{tag}: live joint lanes expected"
        assert jwarm > 0, f"{tag}: warm joint impulses expected"
        assert float((kj - jr.acc).abs().max()) > 0, f"{tag}: nothing solved"
        res = dict(err=max(errs))
        if name == "all-types":
            assert jtypes == [0, 1, 4, 5, 7], (
                f"{tag}: joint types {jtypes}")
        if name.startswith("hub"):
            table = cs.window_table(idx, *args[7:12])
            widths = [hi - lo for kind, _, lo, hi in table
                      if kind == "joint_jacobi"]
            assert jr.overflow and len(widths) > 3, f"{tag}: {widths}"
            assert max(widths) == cs.JOINT_WINDOW, (
                f"{tag}: no joint window was cut at the window width")
        if timed:
            res["ms"] = _time_ms(lambda: cs.contact_solve(*args))
            res["plain_ms"] = _time_ms(
                lambda: cs.contact_solve_reference(*args))
            res["bound_ms"], res["bound_by"] = _bound_ms(args)
            print(f"[kernel] {tag}: median of {TIMED_CALLS} calls: kernel "
                  f"{res['ms']:.4f} ms, twin {res['plain_ms']:.4f} ms, "
                  f"bound {res['bound_ms']:.6f} ms ({res['bound_by']}); "
                  f"{res['ms'] / wst['windows'] * 1e3:.3f} us per serial "
                  f"window")
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
    nbytes, flops, *counts = _k3_work(args, phase)
    return _bound_of(nbytes, flops) + tuple(counts)


def _k3_batched_bound_ms(args, phase):
    """_k3_bound_ms of one batched K3 call: the bytes and operations of all
    its worlds' tables, each read once. Returns (ms, "bytes" or
    "operations", candidates)."""
    work = [_k3_work(tuple(a[w] for a in args[:6]), phase)
            for w in range(args[1].shape[0])]
    return _bound_of(sum(x[0] for x in work), sum(x[1] for x in work)) + (
        sum(x[3] for x in work),)


def _bound_of(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k3_work(args, phase):
    """(bytes, float operations, live lanes, candidates, neighbours, widest
    range) of one K3 call on one table (see _k3_bound_ms)."""
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
    return nbytes, flops, live, candidates, neighbours, widest


def phase_particle_kernels():
    """K3 and K4 against their twins at the inputs the port's
    dam_break(PARTICLES) step gives them (port_fixtures.record_particle_calls:
    the three window passes of the first sub-iteration after WARM_STEPS
    steps, and the rank repair of the latest step up to then that took it;
    in this scene its jump precondition fails in every sub-iteration in
    which a particle falling past the tank crosses y = 0, where the cell
    key's row wraps: ROADMAP.md section 3), timed. Then on inputs made to
    stress them: K3 on tables that send blocks down its global-memory path
    (k3_table), K4 on tables with a run of equal keys two blocks long and
    with every lane moved (rank_table, at its two window sizes), each
    against its twin and K4 also against the stable argsort, bit for bit.
    K3 counts the blocks that took each of its paths. Launches made here do
    not count toward the main path."""
    from box2d_tpu_torch import particles_kernels as pk

    windows, (newkey, offs, rb), rank_step = record_particle_calls(
        PARTICLES, WARM_STEPS)
    tag = f"dam_break-{PARTICLES} after {WARM_STEPS} steps"
    k3 = dict(err=0.0, ms=[], plain_ms=[], bound_ms=[], bound_by=set())
    for args, pname in zip(windows, ("weight", "pressure", "damping")):
        phase = args[6]
        paths = torch.zeros(2, dtype=torch.int32, device="cuda")
        kern = pk.window_pass(*args, paths=paths)
        twin = pk.window_pass_reference(*args)
        torch.cuda.synchronize()
        err = float((kern - twin).abs().max())
        bound_ms, bound_by, live, cand, neigh, widest = _k3_bound_ms(
            args, phase)
        ms = _time_ms(lambda: pk.window_pass(*args))
        plain_ms = _time_ms(lambda: pk.window_pass_reference(*args))
        print(f"[kernel] K3 {pname}, {tag}: n={args[1].shape[0]} live "
              f"lanes={live} candidates={cand} neighbours={neigh} widest "
              f"range={widest} blocks staged / global={paths.tolist()} "
              f"max_abs_err={err:.3e}; median of "
              f"{TIMED_CALLS} calls: kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        # the twin sums each range in lane order like the kernel, and the
        # kernel is built with -fmad=false; the bound covers any order
        torch.testing.assert_close(kern, twin, atol=ATOL, rtol=RTOL)
        assert float(kern.abs().max()) > 0, f"K3 {pname}: all zero"
        assert paths.tolist() == list(pk.k3_block_paths(args[1], args[2]))
        k3["err"] = max(k3["err"], err)
        k3["ms"].append(ms)
        k3["plain_ms"].append(plain_ms)
        k3["bound_ms"].append(bound_ms)
        k3["bound_by"].add(bound_by)
    for kind in ("row boundary", "dense cell"):
        base = tuple(x.cuda() for x in k3_table(kind))
        want = pk.k3_block_paths(base[1], base[2])
        assert want[1] > 0, f"K3 {kind}: no block takes the global path"
        for phase, pname in enumerate(("weight", "pressure", "damping")):
            paths = torch.zeros(2, dtype=torch.int32, device="cuda")
            kern = pk.window_pass(*base, phase, paths=paths)
            twin = pk.window_pass_reference(*base, phase)
            torch.cuda.synchronize()
            err = float((kern - twin).abs().max())
            print(f"[kernel] K3 {pname}, {kind} table: n="
                  f"{base[1].shape[0]} blocks staged / global="
                  f"{paths.tolist()} max_abs_err={err:.3e}")
            torch.testing.assert_close(kern, twin, atol=ATOL, rtol=RTOL)
            assert float(kern.abs().max()) > 0, f"K3 {kind}: all zero"
            assert paths.tolist() == list(want), f"K3 {kind}: paths"
            k3["err"] = max(k3["err"], err)

    ident = torch.arange(newkey.shape[0], dtype=torch.int32, device="cuda")
    moved = int((pk.rank_pass_reference(newkey, offs, rb) != ident).sum())
    cases = [(f"dam_break-{PARTICLES} after {rank_step} steps (the latest "
              f"that took the repair)", newkey, offs, rb)]
    for n, seed, equal in ((5000, 1, True), (5000, 2, False),
                           (99856, 3, False)):
        what = ("lanes [256, 768) holding one key, the rest moved" if equal
                else "every lane moved one row and one column")
        cases.append((f"n={n}, {what}",
                      *(x.cuda() if torch.is_tensor(x) else x
                        for x in rank_table(n, seed, equal))))
    err = 0
    for name, nk, of, w in cases:
        kern = pk.rank_pass(nk, of, w)
        twin = pk.rank_pass_reference(nk, of, w)
        want = library_rank(nk)
        torch.cuda.synchronize()
        e = max(int((kern.long() - x.long()).abs().max()) for x in (twin, want))
        print(f"[kernel] K4, {name}: n={nk.shape[0]} window={w} "
              f"max_abs_err={e} against its twin and the stable argsort")
        assert torch.equal(kern, twin), f"K4 {name}: differs from its twin"
        assert torch.equal(kern, want), f"K4 {name}: differs from argsort"
        err = max(err, e)
    n = newkey.shape[0]
    # the least the function needs, not the kernel's work: keys and
    # offsets read once, ranks written once; one compare per lane to see it
    # is in order, and a binary search of the window per lane that moves
    nbytes = 4 * (2 * n + offs.numel())
    # (int32 compares, counted at the float32 rate: the card's published
    # peaks give no int32 rate)
    ops = n + moved * math.ceil(math.log2(rb))
    k4 = dict(err=err, ms=_time_ms(lambda: pk.rank_pass(newkey, offs, rb)),
              plain_ms=_time_ms(
                  lambda: pk.rank_pass_reference(newkey, offs, rb)),
              library_ms=_time_ms(lambda: library_rank(newkey)))
    k4["bound_ms"], k4["bound_by"] = _bound_of(nbytes, ops)
    print(f"[kernel] K4, {cases[0][0]}: n={n} blocks={offs.shape[0]} "
          f"window={rb} lanes that move={moved}; median of {TIMED_CALLS} "
          f"calls: kernel {k4['ms']:.4f} ms, twin {k4['plain_ms']:.4f} ms, "
          f"argsort + inverse scatter {k4['library_ms']:.4f} ms, bound "
          f"{k4['bound_ms']:.6f} ms ({k4['bound_by']})")
    assert k4["ms"] <= k4["library_ms"], "K4 is slower than the library sort"
    return k3, k4


def _check_finite(w, tag):
    """Finite leaves; returns (leaves, profile)."""
    from box2d_tpu_torch.state import state_to_numpy

    leaves = state_to_numpy(w.state)
    for k, v in leaves.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), f"{tag}: non-finite {k}"
    prof = {k.split(".", 1)[1]: int(v) for k, v in leaves.items()
            if k.startswith("profile.")}
    return leaves, prof


def _check_state(w, tag):
    """Finite leaves and a clean profile; returns (leaves, profile)."""
    leaves, prof = _check_finite(w, tag)
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


def _in_tank_box(p, r):
    """The particles of p (..., 2) inside a box of the dam_break tank
    shrunk by the radius r."""
    hit = np.zeros(p.shape[:-1], bool)
    for (cx, cy), (hx, hy) in TANK:
        hit |= ((np.abs(p[..., 0] - cx) < hx - r)
                & (np.abs(p[..., 1] - cy) < hy - r))
    return hit


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
    born_inside = _in_tank_box(spawn, r)
    now_inside = _in_tank_box(pos, r)
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


def phase_ccd_paths():
    """bullet_barrage(BARRAGE_BULLETS) and tumbler(TUMBLER_BOXES) from
    spawn: one warm run that reads every step's profile, then the timed
    run with the launch and TOI-loop counts set to 0 just before it and
    read just after; then two small worlds on the card against the CPU."""
    from box2d_tpu_torch import api, scenes
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import types as t

    paths = (
        (f"bullet_barrage-{BARRAGE_BULLETS}", lambda: scenes.bullet_barrage(
            BARRAGE_BULLETS, device="cuda"), True),
        (f"tumbler-{TUMBLER_BOXES}", lambda: scenes.tumbler(
            TUMBLER_BOXES, device="cuda"), False),
    )
    flags = ("overflow_ccd", "events_dropped", "overflow_pairs",
             "store_drops")
    # tumbler(2000)'s pair buffer and contact store overflow at the
    # reference's default capacity: the JAX package's own bench run
    # records 59 overflowing pairs and 5 store drops there
    # (BENCH_FULL.json "tumbler"), and tests/test_torch_tumbler.py holds
    # the port's counts to the JAX package's on a smaller drum. So on that
    # path only the first two counters are held to 0
    held = {tag: 2 if tag.startswith("tumbler") else len(flags)
            for tag, _, _ in paths}
    launches = {}
    for tag, make, ccd in paths:
        w = make()
        w.compile()
        state0 = w.state
        dyn = (state0.bodies.type == 2).cpu().numpy()
        n_dyn = int(dyn.sum())
        worst = np.zeros(len(flags), np.int64)
        for _ in range(CCD_STEPS):     # warm run: every step's profile
            w.step()
            prof = w.state.profile
            worst = np.maximum(worst, torch.stack(
                [getattr(prof, f) for f in flags]).cpu().numpy())
        worst = dict(zip(flags, worst.tolist()))
        assert not any(worst[f] for f in flags[:held[tag]]), (
            f"{tag}: warm run {worst}")
        w.state = state0
        w.reset_stats()
        cs.LAUNCHES = 0
        cs.JOINT_LAUNCHES = 0
        t0 = time.perf_counter()
        w.run(CCD_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = w.stats
        n_launch, n_joint = cs.LAUNCHES, cs.JOINT_LAUNCHES
        rounds = st.rounds
        leaves, prof = _check_finite(w, tag)
        for f in flags[:held[tag]]:
            assert prof[f] == 0, f"{tag}: profile.{f} = {prof[f]}"
        work_steps = st.steps - st.idle_steps
        assert n_launch > 0, f"{tag}: the solver kernel was never launched"
        assert n_launch == work_steps, (
            f"{tag}: {n_launch} kernel launches for {work_steps} work steps")
        assert n_joint == 0, f"{tag}: {n_joint} launches carried joints"
        assert prof["overflow_ccd"] == 0, f"{tag}: CCD overflow"
        if ccd:
            assert st.ccd_gate_openings > 0, f"{tag}: the gate never opened"
            assert st.toi_pairs > 0 and st.toi_hits > 0, (
                f"{tag}: {st.toi_pairs} TOI pairs, {st.toi_hits} hits")
            spawn_y = state0.bodies.center[:, 1].cpu().numpy()
            below = dyn & (spawn_y < WALL_TOP)
            x = leaves["bodies.center"][:, 0]
            assert below.any() and x[below].max() < FIRST_WALL_FAR_FACE, (
                f"{tag}: a bullet got past the first wall, x = "
                f"{x[below].max()}")
            note = (f"{int(below.sum())} bullets below the walls' top, "
                    f"largest x {x[below].max():.4f} (< "
                    f"{FIRST_WALL_FAR_FACE})")
        else:
            assert st.ccd_gate_openings == 0, f"{tag}: CCD gate opened"
            # the drum turns about (0, 10); its inner walls are 9.5 m from
            # that axis. The 45 x 45 spawn grid of 2,000 boxes reaches
            # past them, and the boxes outside fall away.
            axis = np.array([0.0, DRUM_AXIS_Y])
            r0 = np.linalg.norm(state0.bodies.center.cpu().numpy() - axis,
                                axis=1)
            r1 = np.linalg.norm(leaves["bodies.center"] - axis, axis=1)
            note = (f"boxes within {DRUM_INNER} m of the drum's axis at "
                    f"spawn {int((dyn & (r0 < DRUM_INNER)).sum())}, now "
                    f"{int((dyn & (r1 < DRUM_INNER)).sum())}")
        gated = max(st.ccd_gate_openings, 1)
        sps = CCD_STEPS / wall
        print(f"[main] {tag}: {n_dyn} dynamic bodies, {CCD_STEPS} steps "
              f"from spawn in {wall:.3f} s: {sps:.2f} steps/s, "
              f"{sps * n_dyn:.1f} body-steps/s; syncs/step "
              f"{st.syncs / st.steps:.2f}; idle steps {st.idle_steps}; "
              f"kernel launches {n_launch}; ccd gate openings "
              f"{st.ccd_gate_openings}; TOI pairs {st.toi_pairs} "
              f"({st.toi_pairs / gated:.2f} a gated step), hits "
              f"{st.toi_hits}, fraction-0 retries {st.toi_retries}; TOI "
              f"loop rounds a gated step "
              + ", ".join(f"{k} {v / gated:.2f}" for k, v in rounds.items())
              + f"; {note}; worst over the warm run {worst}; final profile "
              f"{prof}")
        launches[tag] = n_launch

    # the kernel path against the twin path on small worlds
    def barrage(dev):
        return scenes.bullet_barrage(8, device=dev)

    def chain_sensor(dev):
        return chain_sensor_scene(api.World, t, g, device=dev)

    for tag, make in (("bullet_barrage-8", barrage),
                      ("chain_sensor", chain_sensor)):
        ws, counts = {}, {}
        for dev in ("cuda", "cpu"):
            w = ws[dev] = make(dev)
            w.compile()
            begin = end = 0
            for _ in range(SMALL_STEPS):
                w.step()
                ev = w.state.events
                begin += int(ev.sensor_begin_count)
                end += int(ev.sensor_end_count)
            st = w.stats
            counts[dev] = dict(sensor_begin=begin, sensor_end=end,
                               toi_pairs=st.toi_pairs, toi_hits=st.toi_hits,
                               gate=st.ccd_gate_openings)
        err = float((ws["cuda"].state.bodies.center.cpu()
                     - ws["cpu"].state.bodies.center).abs().max())
        print(f"[main] {tag} x{SMALL_STEPS} steps, cuda vs cpu: max |d "
              f"bodies.center| = {err:.3e} (bound 1e-4); counts cuda "
              f"{counts['cuda']}, cpu {counts['cpu']}")
        assert err <= 1e-4, f"{tag} bodies.center differs by {err}"
        assert counts["cuda"] == counts["cpu"], f"{tag}: counts differ"
        if tag == "chain_sensor":
            assert counts["cpu"]["sensor_begin"] > 0
            assert counts["cpu"]["sensor_end"] > 0
        else:
            assert counts["cpu"]["toi_hits"] > 0
    return launches



# the queries and host-API phase
QUERY_STEPS = 120           # pyramid-140 settles this long before queries
QUERY_RAYS = 1024
QUERY_POINTS = 16           # a 16 x 16 grid of points
QUERY_CALLS = 5             # median of 5 device times
MOVER_FRAMES = 120
MOVER_SPEED = 20.0          # m/s along +x from MOVER_X0
MOVER_X0 = -100.0
QUERY_ROWS = 140
PILE = QUERY_ROWS / 2       # the pile's half width and half height
RAY_ORIGIN = (-120.0, 150.0)
SPARE_LANES = 2048
SPAWNED = 2000
LIFE_STEPS = (120, 60)
SETTER_STEPS = (30, 120)


def _count_launches(fn):
    """CUDA kernels one call of fn launches, from torch.profiler's trace
    (None where the trace holds no device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n or None


def _device_work(fn):
    """(CUDA kernels, their summed device ms) of one call of fn, from
    torch.profiler's trace ((None, None) where it holds no device
    event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return None, None
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def _close(tag, a, b, exact=False, atol=1e-5, rtol=1e-4):
    """a (card) against b (CPU): equal for masks, ids and counts; atol /
    rtol for floats (a query's outputs 1e-5 / 1e-4). Returns the largest
    difference."""
    a = a.cpu()
    if exact or a.dtype in (torch.bool, torch.int32, torch.int64):
        assert torch.equal(a, b), f"{tag}: card and CPU differ"
        return 0.0
    err = float((a - b).abs().max()) if a.numel() else 0.0
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol,
                               msg=f"{tag}: max |card - cpu| {err}")
    return err


def _query(tag, fn_card, fn_cpu, fields):
    """Run one query on the card copy and the CPU copy, hold them to
    each other, print its device time, launches and reads."""
    from box2d_tpu_torch.world import StepStats

    st = StepStats()
    out = fn_card(st)
    ref = fn_cpu()
    errs = []
    for name, exact in fields:
        a = out if name is None else getattr(out, name)
        b = ref if name is None else getattr(ref, name)
        errs.append(_close(f"{tag} {name or ''}", a, b, exact))
    ms = median_ms(lambda: fn_card(None), QUERY_CALLS)
    launches = _count_launches(lambda: fn_card(None))
    print(f"[queries] {tag}: median of {QUERY_CALLS} {ms:.3f} ms, kernel "
          f"launches {launches if launches else 'not measured'}, device "
          f"reads {st.syncs + st.rounds['reads']} (loop rounds "
          f"{ {k: v for k, v in st.rounds.items() if v} }), max |card - "
          f"cpu| {max(errs, default=0.0):.3e}")
    return out


def phase_queries_and_host_api():
    """(a) The scene queries at pyramid-140 after QUERY_STEPS steps, each
    on the card and on a CPU copy of the same state; the mover walks into
    the pile; an explosion, then 60 steps. (b) Runtime spawns, destroys,
    type flips and filters at pyramid-140 with SPARE_LANES spare lanes.
    (c) Joint setters on every revolute joint of joint_farm(1000). (d) A
    scripted API sequence on pyramid-8 and a particle tank with round
    obstacles, each on the card against the CPU. Returns the solver and
    particle kernel launches of these paths."""
    t_phase = time.perf_counter()
    launches = {}
    for part in (_queries_at_pyramid, _lifecycle_at_pyramid,
                 _joint_setters, _small_worlds_against_cpu):
        t0 = time.perf_counter()
        launches.update(part())
        print(f"[life] {part.__name__}: {time.perf_counter() - t0:.1f} s")
    print(f"[life] queries and host API phase in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _queries_at_pyramid():
    """Phase 5 (a): the scene queries at pyramid-140, card against CPU."""
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import queries as q
    from box2d_tpu_torch import scenes
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    # --- (a) queries ------------------------------------------------------
    w = scenes.pyramid(rows=QUERY_ROWS, device="cuda")
    w.compile()
    w.run(QUERY_STEPS)
    st = w.state
    cpu = state_from_numpy(state_to_numpy(st), "cpu")
    n_shapes = int(st.shapes.enabled.sum())
    ang = np.linspace(-1.45, -0.3, QUERY_RAYS)
    trans = (300.0 * np.stack([np.cos(ang), np.sin(ang)], 1)).astype(
        np.float32)
    orig = np.tile(np.float32(RAY_ORIGIN), (QUERY_RAYS, 1))
    ray = dict(origin=torch.from_numpy(orig), translation=torch.from_numpy(
        trans))
    ray_c = {k: v.cuda() for k, v in ray.items()}
    fields = (("hit", True), ("shape", True), ("point", False),
              ("normal", False), ("fraction", False))
    r = _query(f"cast_ray_closest x{QUERY_RAYS}",
               lambda s: q.cast_ray_closest(st, stats=s, **ray_c),
               lambda: q.cast_ray_closest(cpu, **ray), fields)
    assert int(r.hit.sum()) > QUERY_RAYS // 2, "rays missed the pile"
    r = _query(f"cast_ray_all x{QUERY_RAYS} (max_hits 16)",
               lambda s: q.cast_ray_all(st, max_hits=16, stats=s, **ray_c),
               lambda: q.cast_ray_all(cpu, max_hits=16, **ray),
               (("count", True),) + fields[1:])
    assert int(r.count.max()) == 16, "no ray crossed 16 shapes"
    gx, gy = np.meshgrid(np.linspace(1.0 - PILE, PILE - 1.0, QUERY_POINTS),
                         np.linspace(0.5, 2.0 * PILE - 0.5, QUERY_POINTS))
    pts = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    r = _query(f"overlap_point x{len(pts)}",
               lambda s: q.overlap_point(st, torch.from_numpy(pts).cuda(),
                                         stats=s),
               lambda: q.overlap_point(cpu, torch.from_numpy(pts)),
               ((None, True),))
    assert r.any(), "no grid point lies in a box"
    left = (-PILE - 1.0, -1.0, -PILE / 3.0, 2.0 * PILE + 1.0)
    r = _query("overlap_aabb (left third)",
               lambda s: q.overlap_aabb(st, left),
               lambda: q.overlap_aabb(cpu, left), ((None, True),))
    assert int(r.sum()) > n_shapes // 10
    box = g.box(0.5, 0.5)
    proxy = (box.verts, box.count, box.radius, (0.0, PILE / 2.0),
             (1.0, 0.0))
    _query("overlap_shape (1 m box)",
           lambda s: q.overlap_shape(st, *proxy, stats=s),
           lambda: q.overlap_shape(cpu, *proxy), ((None, True),))
    cast = (box.verts, box.count, box.radius, (0.5, 2.0 * PILE + 30.0),
            (1.0, 0.0), (0.0, -200.0))
    r = _query("cast_shape_closest (1 m box)",
               lambda s: q.cast_shape_closest(st, *cast, stats=s),
               lambda: q.cast_shape_closest(cpu, *cast), fields)
    assert bool(r.hit), "the box cast missed the pile"

    # the mover: collide_mover -> solve_planes -> cast_mover -> clip_vector
    def walk(state, dev):
        c = torch.tensor([MOVER_X0, 1.05], device=dev)
        v = torch.tensor([MOVER_SPEED, 0.0], device=dev)
        half = torch.tensor([0.0, 0.5], device=dev)
        limits = torch.full((8,), 1e3, device=dev)
        clip = torch.ones(8, dtype=torch.bool, device=dev)
        for _ in range(MOVER_FRAMES):
            n, off, valid = q.collide_mover(state, c - half, c + half, 0.5)
            delta, push = q.solve_planes(v / 60.0, n, off, limits, valid)
            frac = q.cast_mover(state, c - half, c + half, 0.5, delta)
            c = c + frac * delta
            v = q.clip_vector(v, n, push, clip, valid)
        return c

    t0 = time.perf_counter()
    c_card = walk(st, "cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_cpu = walk(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    err = _close("mover", c_card, c_cpu)
    aabbs = q.compute_shape_aabbs(cpu)
    dyn = (cpu.bodies.type[cpu.shapes.body.long()] == 2) & cpu.shapes.enabled
    face = float(aabbs[dyn, 0].min())
    gap = face - (float(c_card[0]) + 0.5)
    print(f"[queries] mover x{MOVER_FRAMES} frames: {t_card:.3f} s on the "
          f"card ({t_card / MOVER_FRAMES * 1e3:.2f} ms a frame; the CPU "
          f"copy {t_cpu:.3f} s); stops at "
          f"x = {float(c_card[0]):.4f}, {gap:.5f} m left of the pile's "
          f"leftmost face x = {face:.4f}; max |card - cpu| {err:.3e}")
    assert abs(gap) <= 0.01, f"the mover stopped {gap} m from the pile"

    blast = ((0.0, 0.5), 10.0, 50.0)
    exploded = _query("explode (radius 10, 50 per length)",
                      lambda s: q.explode(st, *blast, stats=s),
                      lambda: q.explode(cpu, *blast), ())
    ref = q.explode(cpu, *blast)
    for name in ("v", "w"):
        _close(f"explode {name}", getattr(exploded.bodies, name),
               getattr(ref.bodies, name))
    w.state = exploded
    w.run(60)
    leaves, _ = _check_finite(w, "pyramid-140 exploded")
    note = _pyramid_check(leaves, "pyramid-140 exploded")
    print(f"[queries] pyramid-140 after the explosion and 60 steps: {note}")

    return {}


def _lifecycle_at_pyramid():
    """Phase 5 (b): runtime spawns, destroys, type flips and filters at
    pyramid-140 with SPARE_LANES spare lanes."""
    import dataclasses

    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import scenes
    from box2d_tpu_torch import types as t
    from box2d_tpu_torch import world

    launches = {}
    # --- (b) lifecycle at pyramid-140 scale -------------------------------
    w = scenes.pyramid(rows=140, device="cuda")
    cap = w.builder.default_capacity()
    n0 = cap.max_bodies
    cap = dataclasses.replace(
        cap, max_bodies=n0 + SPARE_LANES, max_shapes=n0 + SPARE_LANES,
        max_contact_pairs=4 * (n0 + SPARE_LANES))
    w.compile(cap)
    print(f"[life] pyramid-140 compiled with {SPARE_LANES} spare lanes: "
          f"{w.capacity}")
    side = int(math.ceil(math.sqrt(SPAWNED)))
    t0 = time.perf_counter()
    spawned = []
    for i in range(SPAWNED):
        x = -0.6 * side / 2 + 0.6 * (i % side)
        y = 142.0 + 0.6 * (i // side)
        b = w.create_body(t.BodyDef(type=2, position=(x, y)))
        w.create_polygon_shape(b, t.ShapeDef(), g.box(0.25, 0.25))
        spawned.append(b)
    torch.cuda.synchronize()
    spawn_s = time.perf_counter() - t0
    w.run(LIFE_STEPS[0])
    torch.cuda.synchronize()
    step = w._step
    args = world._step_work(w.state, 1 / 60, w.capacity, step.classes,
                            step.substeps, step.continuous,
                            world.StepStats(), until="layout",
                            hooks=step.hooks)
    _kernel_vs_twin(f"pyramid-140 + {SPAWNED} spawned boxes after "
                    f"{LIFE_STEPS[0]} steps", args)
    t0 = time.perf_counter()
    gone = spawned[::2]
    for b in gone:
        w.destroy_body(b)
    torch.cuda.synchronize()
    destroy_s = time.perf_counter() - t0
    kept = spawned[1::2]
    for b in kept[:100]:
        w.set_body_type(b, 1)
        w.set_linear_velocity(b, (0.0, 0.5))
    for b in kept[100:200]:
        for sh in w.body_shapes(b):
            w.set_filter(sh, t.Filter(group_index=-7))
    w.reset_stats()
    cs.LAUNCHES = 0
    t0 = time.perf_counter()
    w.run(LIFE_STEPS[1])
    torch.cuda.synchronize()
    life_s = time.perf_counter() - t0
    n_launch = cs.LAUNCHES
    launches["pyramid-140 lifecycle"] = n_launch
    work = w.stats.steps - w.stats.idle_steps
    assert n_launch == work > 0, f"{n_launch} launches, {work} work steps"
    assert w.validate() == [], "validate() found violations"
    c = w.counters()
    want = n0 + SPAWNED - len(gone)
    assert c["body_count"] == want and c["shape_count"] == want, c
    raised = False
    try:
        w.body_position(gone[0])
    except ValueError:
        raised = True
    assert raised, "a destroyed body's handle did not raise"
    leaves, prof = _check_finite(w, "pyramid-140 lifecycle")
    note = _pyramid_check(leaves, "pyramid-140 lifecycle")
    print(f"[life] {SPAWNED} spawns (body + box) in {spawn_s:.3f} s: "
          f"{SPAWNED / spawn_s:.1f} spawns/s; {len(gone)} destroys in "
          f"{destroy_s:.3f} s: {len(gone) / destroy_s:.1f} destroys/s; 100 "
          f"flipped to kinematic, 100 in filter group -7; "
          f"{LIFE_STEPS[1]} steps in {life_s:.3f} s: "
          f"{LIFE_STEPS[1] / life_s:.2f} steps/s; solver launches "
          f"{n_launch}; counters {c}; {note}; final profile {prof}")

    return launches


def _joint_setters():
    """Phase 5 (c): joint setters on every revolute joint of
    joint_farm(1000)."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes
    from box2d_tpu_torch import world
    from box2d_tpu_torch.state import state_to_numpy

    launches = {}
    # --- (c) joint setters at joint_farm-1000 -----------------------------
    w = scenes.joint_farm(1000, device="cuda")
    w.compile()
    w.run(SETTER_STEPS[0])
    rev = np.nonzero(state_to_numpy(w.state)["joints.type"] == 3)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in rev.tolist():
        w.enable_joint_motor(j, True)
        w.set_joint_motor_speed(j, 1.0)
        w.set_joint_max_motor_force(j, 20.0)
        w.set_joint_limits(j, -0.4, 0.4)
    torch.cuda.synchronize()
    set_s = time.perf_counter() - t0
    step = w._step
    args = world._step_work(w.state, 1 / 60, w.capacity, step.classes,
                            step.substeps, step.continuous,
                            world.StepStats(), until="layout",
                            joint_types=step.joint_types, hooks=step.hooks)
    kb, ka, kj = cs.contact_solve(*args)
    tb, ta, tj = cs.contact_solve_reference(*args)
    _same_twice("joint_farm after the setters", args, (kb, ka, kj))
    jerr = max(float((x - y).abs().max()) for x, y in
               ((kb, tb), (ka, ta), (kj, tj)))
    for x, y in ((kb, tb), (ka, ta), (kj, tj)):
        torch.testing.assert_close(x, y, atol=ATOL, rtol=RTOL)
    w.reset_stats()
    cs.LAUNCHES = cs.JOINT_LAUNCHES = 0
    w.run(SETTER_STEPS[1])
    torch.cuda.synchronize()
    launches["joint_farm-1000 setters"] = cs.JOINT_LAUNCHES
    work = w.stats.steps - w.stats.idle_steps
    assert cs.JOINT_LAUNCHES == cs.LAUNCHES == work > 0
    leaves, _ = _check_state(w, "joint_farm-1000 setters")
    note = _joint_farm_check(leaves, "joint_farm-1000 setters")
    calls = 4 * len(rev)
    print(f"[life] joint_farm-1000: {calls} setter calls on {len(rev)} "
          f"revolute joints in {set_s:.3f} s: {calls / set_s:.1f} calls/s; "
          f"joint kernel vs twin after the setters max_abs_err "
          f"{jerr:.3e}; {SETTER_STEPS[1]} steps, joint launches "
          f"{cs.JOINT_LAUNCHES}; {note}")

    return launches


def _lockstep(tag, wc, wp, fields, each=None):
    """SMALL_STEPS steps of a world on the card (wc) and its twin on the
    CPU (wp), each step from the same state: the card's state is copied to
    the CPU before it. Every step's fields must agree within 1e-4 and its
    event counts exactly; `each(state)`, where given, checks more of the
    step from the card's state before it. Then the CPU world runs the
    same steps from the same start without the copies, and the
    free-running divergence is printed: last-bit differences between the
    two devices' math (sin, cos, reductions) grow chaotically in a
    scattered pile. The CPU world
    is left at its last lockstep state. Returns the card world's events,
    one per step."""
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    start = state_to_numpy(wc.state)
    worst = {f: 0.0 for f in fields}
    frames = []
    for i in range(SMALL_STEPS):
        if each is not None:
            each(wc.state)
        wp.state = state_from_numpy(state_to_numpy(wc.state), "cpu")
        _, evc = wc.run(1, collect_events=True)
        _, evp = wp.run(1, collect_events=True)
        for f in fields:
            group, leaf = f.split(".")
            worst[f] = max(worst[f], _close(
                f"{tag} step {i} {f}", getattr(getattr(wc.state, group),
                                               leaf),
                getattr(getattr(wp.state, group), leaf), atol=1e-4,
                rtol=0.0))
        for name in ("contact_begin_count", "contact_end_count",
                     "hit_count", "body_move_count", "joint_force_count",
                     "sensor_begin_count"):
            assert torch.equal(getattr(evc, name).cpu(),
                               getattr(evp, name)), f"{tag} step {i} {name}"
        frames.append(evc)
    locked = wp.state
    wp.state = state_from_numpy(start, "cpu")
    wp.run(SMALL_STEPS)
    group, leaf = fields[0].split(".")
    free = float((getattr(getattr(wc.state, group), leaf).cpu()
                  - getattr(getattr(wp.state, group), leaf)).abs().max())
    wp.state = locked
    print(f"[life] {tag} x{SMALL_STEPS} steps, cuda vs cpu from the same "
          f"state each step: max |d| "
          + ", ".join(f"{f} {v:.3e}" for f, v in worst.items())
          + f" (bound 1e-4); running free from the same start the two "
          f"devices part by {free:.3e} in {fields[0]}")
    return frames


def _small_worlds_against_cpu():
    """Phase 5 (d): the scripted API sequence on pyramid-8 and the
    obstacle tank, card against CPU, in lockstep (_lockstep)."""
    import dataclasses

    from box2d_tpu_torch import api
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes
    from box2d_tpu_torch import types as t
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    launches = {}

    def scripted(dev):
        w = scenes.pyramid(rows=8, device=dev)
        cap = w.builder.default_capacity()
        w.compile(dataclasses.replace(
            cap, max_bodies=cap.max_bodies + 16,
            max_shapes=cap.max_shapes + 16, max_joints=cap.max_joints + 4,
            max_verts=8))
        w.run(10)
        return w, api_sequence(w, t, g)

    (wc, hc), (wp, hp) = scripted("cuda"), scripted("cpu")
    assert hc == hp, f"handles differ: {hc} {hp}"
    err = _close("api sequence bodies.center", wc.state.bodies.center,
                 wp.state.bodies.center, atol=1e-4, rtol=0.0)
    frames = _lockstep("pyramid-8 API sequence", wc, wp,
                       ("bodies.center", "bodies.v"))
    assert wc.counters() == wp.counters(), "counters differ"

    def pair_set(w):
        cd = w.contact_data()
        return {(int(a), int(b)) for a, b in zip(cd["shape_a"],
                                                 cd["shape_b"])}

    pairs = pair_set(wc)
    assert pairs == pair_set(wp) and pairs, "contact_data pairs differ"
    assert wc.validate() == []
    # run(collect_events=True) on both from the same state: the stacked
    # counts agree
    start = state_to_numpy(wc.state)
    ev = {}
    for dev, w in (("cuda", wc), ("cpu", wp)):
        w.state = state_from_numpy(start, dev)
        ev[dev] = w.run(2, collect_events=True)[1]
    for name in ("contact_begin_count", "body_move_count"):
        assert torch.equal(getattr(ev["cuda"], name).cpu(),
                           getattr(ev["cpu"], name)), name
    assert ev["cuda"].body_move_count.shape == (2,)
    assert wc._step.tail_w == wp._step.tail_w
    print(f"[life] pyramid-8 API sequence: handles {hc}; after the "
          f"sequence max |d bodies.center| {err:.3e}; counters "
          f"{wc.counters()}; {len(pairs)} touching pairs; "
          f"{sum(int(f.contact_begin_count) for f in frames)} begin events; "
          f"tail width {wc._step.tail_w} (mode {wc._step.mode})")

    ws = {}
    for dev in ("cuda", "cpu"):
        ws[dev] = obstacle_tank(PARTICLE_TANK, api.World, t, g, device=dev)
        ws[dev].compile()
    pk.K3_LAUNCHES = pk.K4_LAUNCHES = 0
    ws["cuda"].run(SMALL_STEPS)
    k3, k4 = pk.K3_LAUNCHES, pk.K4_LAUNCHES
    assert k3 == 12 * SMALL_STEPS and k4 > 0, (k3, k4)
    launches["obstacle tank K3"] = k3
    launches["obstacle tank K4"] = k4
    for w in ws.values():
        w.compile()
    _lockstep(f"obstacle tank ({PARTICLE_TANK} particles, a circle and a "
              f"capsule)", ws["cuda"], ws["cpu"],
              ("particles.pos", "particles.vel"))
    print(f"[life] obstacle tank: K3 launches {k3}, K4 launches {k4} in "
          f"{SMALL_STEPS} steps from spawn")
    return launches


# ---------------------------------------------------------------------------
# phase 6: batching
# ---------------------------------------------------------------------------

def phase_batching():
    """Batches of worlds (box2d_tpu_torch/batch.py) and flat batches
    (scenes.replicate). Returns the batched solver's row of the kernels
    line, the batched joint launch's rows at 64 and 1,024 worlds, the
    batched window pass's rows at (h) and (i), and the launches of the
    other kernels on these paths."""
    t0 = time.perf_counter()
    row = _vmapped_batch()
    print(f"[batch] vmapped batch done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _cluster_path_batch()
    print(f"[batch] cluster-path batch done in "
          f"{time.perf_counter() - t0:.1f} s")
    jrows = _vmapped_jointed()
    t1 = time.perf_counter()
    launches = _flat_batches()
    launches.update(_rl_loop())
    flat_launches, flat_rates = _flat_particle_batches()
    launches.update(flat_launches)
    print(f"[batch] flat batches done in {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    prows, plaunches = _vmapped_particles(flat_rates)
    launches.update(plaunches)
    print(f"[batch] vmapped particle worlds done in "
          f"{time.perf_counter() - t2:.1f} s")
    return row, jrows, prows, launches


def _batch_setup(rows, device="cuda"):
    """pyramid(rows) built on `device`, its capacity as the JAX package's
    vmapped bench sets it (bp_repair_cap 0, batched), its pair classes and
    the batched step."""
    import dataclasses

    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.narrowphase import classes_for_shape_types

    w = scenes.pyramid(rows=rows, device=device)
    state, cap = w.builder.build(device=device)
    cap = dataclasses.replace(cap, bp_repair_cap=0, batched=True)
    classes = classes_for_shape_types(
        s["geom"].type for s in w.builder._shapes)
    return state, cap, classes, world.make_batched_step(cap, classes, 4,
                                                        True)


def _spread(leaves):
    """The largest difference of a float leaf between any world and world
    0 of a batch's leaves; raises if a discrete leaf differs."""
    for key, v in leaves.items():
        if v.dtype.kind != "f":
            assert np.array_equal(v, np.broadcast_to(v[:1], v.shape)), (
                f"identical worlds: {key} differs")
    return max(float(np.abs(v - v[:1]).max()) for v in leaves.values()
               if v.dtype.kind == "f" and v.size)


def _batched_bound_ms(args, dead_lanes=False):
    """_bound_ms of the batched call: the bytes and operations of all its
    worlds (live lanes only), joint regions included. dead_lanes: also the
    bytes the contract moves for every dead lane (its idx read, its
    accumulators read and written: out_acc and the joint accumulators are
    written whole)."""
    scalars, idx, data, acc, body, params, nsub = args[:7]
    live = int((idx[:, 0] >= 0).sum())
    nb = body.shape[0] * body.shape[2]
    stages = 3 * nsub + 1
    nbytes = 4 * (live * (2 + 33 + 9 + 9) + nb * (8 + 8 + 12)
                  + 8 * body.shape[0])
    flops = (live * stages * FLOP_CONTACT_LANE_STAGE
             + nb * nsub * FLOP_BODY_SUBSTEP)
    if len(args) > 11:
        # each world's joint region, as _bound_ms counts one world's
        joints = args[11]
        jlive = int((joints.idx[:, 0] >= 0).sum())
        nbytes += 4 * (jlive * (2 + 39 + 9 + 9 + 1) + joints.offsets.numel()
                       + joints.overflow.numel())
        flops += jlive * 3 * nsub * FLOP_JOINT_LANE_STAGE
        if dead_lanes:
            nbytes += 4 * (joints.idx[:, 0].numel() - jlive) * (1 + 9 + 9)
    if dead_lanes:
        nbytes += 4 * (idx[:, 0].numel() - live) * (1 + 9 + 9)
    return _bound_of(nbytes, flops)


def _perturbed_args(base, n_w, seed, bstep, kick_body=5):
    """The batched solver's arguments for a perturbed batch of `base`
    (jitter from `seed`, world n_w - 1's body kick_body kicked) after
    WARM_STEPS steps."""
    from box2d_tpu_torch import batch as bt
    from box2d_tpu_torch.state import state_from_numpy

    b = state_from_numpy(perturbed_leaves(
        base, n_w, seed=seed, kick=(n_w - 1, kick_body, (2.0, 1.0))), "cuda")
    for _ in range(WARM_STEPS):
        b = bstep(b, 1 / 60)
    return bt.batched_kernel_args(b, 1 / 60, bstep)


def _single_args(args, w):
    """contact_solve's arguments for world w of a batched call's (its
    joint region, when the call has them, with world w's overflow
    flag)."""
    from box2d_tpu_torch.joints import JointRows

    jr = None
    if len(args) > 11:
        j = args[11]
        jr = JointRows(j.idx[w], j.data[w], j.acc[w], j.type[w],
                       j.offsets[w], bool(j.overflow[w]))
    return tuple(a[w] for a in args[:6]) + tuple(args[6:11]) + (jr,)


def _plan_of(args):
    """The batched launch's plan for these arguments (as
    contact_solve_batched picks it) and its launch shape."""
    from box2d_tpu_torch import contact_solver as cs

    plan = cs.plan_for(args)
    return plan, cs.launch_shape(len(args) > 11, batched=True, plan=plan)


def _other_path(args, plan):
    """The batched launch on `args` by the kernel its plan does not take
    (the cluster kernel for a small-world plan; else the small-world
    kernel at GROUP_MAX threads, one world a CTA): its outputs, their
    median device time, and its launch shape. The launch counters are
    left as they were: these launches only compare the two kernels."""
    from box2d_tpu_torch import contact_solver as cs

    other = other_plan(plan, cs.GROUP_MAX)
    full = args[:11] + ((args[11] if len(args) > 11 else None),)
    counts = (cs.BATCHED_LAUNCHES, cs.BATCHED_JOINT_LAUNCHES,
              cs.SMALL_LAUNCHES)
    try:
        out = cs._launch_batched(full, other)
        ms = median_ms(lambda: cs._launch_batched(full, other))
    finally:
        (cs.BATCHED_LAUNCHES, cs.BATCHED_JOINT_LAUNCHES,
         cs.SMALL_LAUNCHES) = counts
    return out, ms, cs.launch_shape(len(args) > 11, batched=True, plan=other)


def _path_note(tag, args):
    """One line on the batched launch at these arguments: the kernel its
    plan picks, threads a world, worlds a CTA, the CTAs the card holds at
    once, what ptxas said of the instance, and its device time beside
    world 0's single launch and beside the other kernel's on the same
    arrays, whose result must be the same bit for bit (both equal the
    single launches). Returns the plan."""
    from box2d_tpu_torch import contact_solver as cs

    joints = len(args) > 11
    plan, sh = _plan_of(args)
    ptx = _ptxas_kernels(cs.build().ptxas_log)
    single = _single_args(args, 0)
    got = cs.contact_solve_batched(*args)
    ms = median_ms(lambda: cs.contact_solve_batched(*args))
    one_ms = median_ms(lambda: cs.contact_solve(*single))
    other, other_ms, other_sh = _other_path(args, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, other)), (
        f"{tag}: the small-world and the cluster kernel differ")
    suffix = "_joints" if joints else ""
    if plan.path == "small":
        assert sh["smem_per_cta"] <= SMEM_OPT_IN, sh
        where = (f"the small-world kernel: {plan.threads_per_world} threads "
                 f"a world, {plan.worlds_per_cta} worlds a CTA, "
                 f"{sh['smem_per_cta']} bytes of shared memory a CTA, "
                 f"{sh['ctas_per_sm']} CTAs an SM ({sh['resident_ctas']} "
                 f"resident, {sh['resident_worlds']} worlds), "
                 f"{sh['registers']} registers and {sh['local_bytes']} "
                 f"bytes of local memory a thread; ptxas "
                 f"{ptx.get('small' + suffix, 'not reported')}")
        other_where = (f"the cluster kernel "
                       f"({other_sh['max_active_clusters']} clusters "
                       f"resident)")
    else:
        where = (f"the cluster kernel: a cluster of {sh['cluster']} CTAs x "
                 f"{sh['threads']} threads a world "
                 f"({sh['max_active_clusters']} resident); ptxas "
                 f"{ptx.get('batched' + suffix, 'not reported')}")
        other_where = (f"the small-world kernel at "
                       f"{other_sh['threads_per_world']} threads a world "
                       f"({other_sh['smem_per_cta']} bytes of shared memory "
                       f"a CTA, {other_sh['resident_worlds']} worlds "
                       f"resident)")
    print(f"[batch] path {tag}: capacity bound {plan.bound} lanes, "
          f"{where}; median {ms:.4f} ms for {args[0].shape[0]} worlds, "
          f"world 0's single launch {one_ms:.4f} ms; {other_where} on the "
          f"same arrays {other_ms:.4f} ms, equal bit for bit")
    return plan


def _batched_against_single(tag, args):
    """The batched launch on `args` against the W single launches on each
    world's arrays and against the batched twin, each launch made
    JACOBI_REPEATS times. The kernel's Jacobi sums are fixed point, so the
    batched launch must equal the single launches, and every launch the
    first, bit for bit. The twin runs on the card with deterministic
    algorithms, so that its index_add_ sums in a fixed order. Prints the
    launches' distance from the twin (the single launches' too, at the
    value where the batched launch is furthest from it) and the values
    outside ATOL / RTOL of it. A call with joint regions (args[11]) holds
    the joint accumulators too, each single launch on its world's region.
    Returns them; the caller asserts."""
    from box2d_tpu_torch import contact_solver as cs

    n_w, l0 = args[0].shape[0], args[8]
    _path_note(tag, args)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        twin = cs.contact_solve_batched_reference(*args)
        twin2 = cs.contact_solve_batched_reference(*args)
    finally:
        torch.use_deterministic_algorithms(False)
    tail = [int((args[1][w, 0, l0:] >= 0).sum()) for w in range(n_w)]
    r = dict(bt=0.0, st=0.0, st_at_bt=0.0, out_bt=0, out_st=0, unequal=[])
    first = None

    def outside(x, y):
        return sum(int((~torch.isclose(a, b, rtol=RTOL, atol=ATOL)).sum())
                   for a, b in zip(x, y))

    def dist(x, y):
        return max(float((a - b).abs().max()) for a, b in zip(x, y))

    for k in range(JACOBI_REPEATS):
        ob = cs.contact_solve_batched(*args)
        one = [cs.contact_solve(*_single_args(args, w)) for w in range(n_w)]
        sb = [torch.stack([o[i] for o in one]) for i in range(len(ob))]
        torch.cuda.synchronize()
        for what, x, y in (("batched against single", ob, sb),
                           ("batched against the first", ob,
                            first[0] if first else ob),
                           ("single against the first", sb,
                            first[1] if first else sb)):
            if not all(torch.equal(a, b) for a, b in zip(x, y)):
                r["unequal"].append(f"launch {k}: {what} by "
                                    f"{dist(x, y):.3e}")
        r["out_bt"] += outside(ob, twin)
        r["out_st"] += outside(sb, twin)
        r["st"] = max(r["st"], dist(sb, twin))
        for o, sv, t in zip(ob, sb, twin):
            d = (o - t).abs()
            at = int(d.argmax())
            if float(d.view(-1)[at]) >= r["bt"]:
                r["bt"] = float(d.view(-1)[at])
                r["st_at_bt"] = float((sv - t).abs().view(-1)[at])
        first = first or (ob, sb)
    live = [w for w in range(n_w) if tail[w]]
    print(f"[batch] batched launch {tag}, {JACOBI_REPEATS} launches of it "
          f"and of the {n_w} single launches: {len(live)} worlds with a "
          f"live tail ({min(tail)}-{max(tail)} lanes); batched, single and "
          f"repeated launches equal bit for bit: {not r['unequal']}; "
          f"against the twin (twice: {dist(twin, twin2):.3e} apart): "
          f"batched {r['bt']:.3e} (single launches {r['st_at_bt']:.3e} at "
          f"that value), single launches {r['st']:.3e}; values outside "
          f"atol {ATOL} / rtol {RTOL} of the twin: batched {r['out_bt']}, "
          f"single {r['out_st']}")
    return r


def _vmapped_batch():
    """64 x pyramid-20 through make_batched_step: the timed run from spawn,
    the batched launch against single launches and its twin, lockstep
    against the single-world step, identical worlds staying identical."""
    from box2d_tpu_torch import batch as bt
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import world
    from box2d_tpu_torch.state import (broadcast_state, state_from_numpy,
                                       state_to_numpy, unstack_state)

    n_w = BATCH_WORLDS
    state, cap, classes, bstep = _batch_setup(BATCH_ROWS)
    n_dyn = int((state.bodies.type == 2).sum()) * n_w
    batch0 = broadcast_state(state, n_w)
    b = batch0
    for _ in range(BATCH_STEPS):          # warm run
        b = bstep(b, 1 / 60)
    torch.cuda.synchronize()
    bstep.stats = bt.BatchStats()
    cs.BATCHED_LAUNCHES = cs.SMALL_LAUNCHES = 0
    cs.LAUNCHES = 0
    t0 = time.perf_counter()
    b = batch0
    for _ in range(BATCH_STEPS):
        b = bstep(b, 1 / 60)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = bstep.stats
    n_batched, n_single = cs.BATCHED_LAUNCHES, cs.LAUNCHES
    work = st.steps - st.idle_steps
    assert n_batched == work == st.solver_launches > 0, (
        f"{n_batched} batched launches for {work} work steps")
    assert cs.SMALL_LAUNCHES == n_batched, (
        f"{cs.SMALL_LAUNCHES} of {n_batched} batched launches took the "
        f"small-world kernel")
    assert n_single == 0, f"{n_single} single-world launches in the batch"
    assert st.ccd_gate_openings == 0, "CCD gate opened"
    leaves = state_to_numpy(b)
    for k, v in leaves.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), f"batch: non-finite {k}"
    dyn = leaves["bodies.type"] == 2
    min_y = float(leaves["bodies.center"][..., 1][dyn].min())
    assert min_y >= 0.45, f"batch: a dynamic body sank to y={min_y}"
    prof = {k.split(".", 1)[1]: v for k, v in leaves.items()
            if k.startswith("profile.")}
    for k in ("overflow_pairs", "store_drops", "events_dropped"):
        assert int(prof[k].max()) == 0, f"batch: profile.{k}"
    # identical worlds stay identical running free: every phase of the
    # step, the solver's Jacobi sums included, gives the same bits
    # whatever order its atomics take
    free_spread = _spread(leaves)
    assert free_spread == 0.0, (
        f"identical worlds parted by {free_spread} in {BATCH_STEPS} steps")
    sps = BATCH_STEPS / wall
    print(f"[batch] {n_w} x pyramid-{BATCH_ROWS} vmapped: {n_dyn} dynamic "
          f"bodies, {BATCH_STEPS} steps from spawn in {wall:.3f} s: "
          f"{sps:.2f} steps/s, {sps * n_dyn:.1f} body-steps/s; reads/step "
          f"{st.syncs / st.steps:.2f}; idle steps {st.idle_steps}; solver "
          f"launches/step {n_batched / work:.2f} (one for all {n_w} worlds); "
          f"identical worlds running free: max spread {free_spread:.3e} "
          f"after {BATCH_STEPS} steps; min dynamic y {min_y:.4f}")
    # identical worlds stay identical, in lockstep: each step starts from
    # copies of world 0
    b = batch0
    for _ in range(LOCKSTEP_STEPS):
        b = bstep(broadcast_state(unstack_state(b, 0), n_w), 1 / 60)
        spread = _spread(state_to_numpy(b))
        assert spread == 0.0, f"identical worlds parted by {spread}"
    print(f"[batch] {n_w} identical worlds, {LOCKSTEP_STEPS} steps from "
          f"spawn in lockstep: equal bit for bit at every step")

    # a perturbed batch: jitter from a numpy seed, one box kicked
    base = state_to_numpy(state)
    pert = state_from_numpy(perturbed_leaves(
        base, n_w, seed=JACOBI_SEEDS[0], kick=(n_w - 1, 5, (2.0, 1.0))),
        "cuda")
    spawn_args = bt.batched_kernel_args(pert, 1 / 60, bstep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idle0 = bstep.stats.idle_steps
    for _ in range(WARM_STEPS):
        pert = bstep(pert, 1 / 60)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / WARM_STEPS * 1e3
    assert bstep.stats.idle_steps == idle0, "the perturbed batch idled"
    reads0 = bstep.stats.syncs
    launches_step, busy_ms = _device_work(lambda: bstep(pert, 1 / 60))
    busy = (f"{busy_ms:.3f} ms of device time, idle "
            f"{100 * (1 - busy_ms / step_ms):.1f}% of a {step_ms:.3f} ms "
            f"step" if busy_ms else "device time not measured")
    print(f"[batch] the perturbed batch's first {WARM_STEPS} steps, all "
          f"work steps: {step_ms:.3f} ms a step; one more under the "
          f"profiler: CUDA launches {launches_step or 'not measured'}, "
          f"reads {bstep.stats.syncs - reads0}, {busy}")
    args = bt.batched_kernel_args(pert, 1 / 60, bstep)
    # the batched launch against W single launches and its twin, on the
    # perturbed batch at spawn (a live Jacobi window in every world's
    # overflow tail) and after WARM_STEPS steps (no live tail), and on
    # every seed's batch after WARM_STEPS steps with TAIL_BUCKETS color
    # buckets moved into each world's tail (three Jacobi windows whose
    # lanes share bodies)
    cases = [("at spawn", spawn_args),
             (f"after {WARM_STEPS} steps", args)]
    for seed in JACOBI_SEEDS:
        a = args if seed == JACOBI_SEEDS[0] else _perturbed_args(
            base, n_w, seed, bstep)
        tails = [move_buckets_to_tail(
            _single_args(a, w), range(TAIL_BUCKETS), TAIL_BUCKETS * a[7])
            for w in range(n_w)]
        n_tail = [len(_tail_windows(t)) for t in tails]
        cases.append((f"seed {seed}, {TAIL_BUCKETS} buckets moved into each "
                      f"tail ({min(n_tail)}-{max(n_tail)} Jacobi windows a "
                      f"world)", tuple(torch.stack([t[i] for t in tails])
                                        for i in range(6)) + a[6:11]))
    results = [_batched_against_single(*c) for c in cases]
    for tag, r in zip([c[0] for c in cases], results):
        assert not r["unequal"], (f"batch {tag}: launches not bit for bit: "
                                  f"{r['unequal'][:3]}")
        assert r["out_bt"] == 0, (
            f"batch {tag}: {r['out_bt']} values of the batched launch "
            f"outside atol {ATOL} / rtol {RTOL} of the twin")
    err_twin = max(r["bt"] for r in results)
    live = int((args[1][:, 0] >= 0).sum())
    ms = _time_ms(lambda: cs.contact_solve_batched(*args))
    plan, sh = _plan_of(args)
    plain_ms = _time_ms(lambda: cs.contact_solve_batched_reference(*args))
    single = _single_args(args, 0)
    one_ms = _time_ms(lambda: cs.contact_solve(*single))
    bound_ms, bound_by = _batched_bound_ms(args)
    contract_ms = _batched_bound_ms(args, dead_lanes=True)[0]
    print(f"[batch] {n_w} worlds after {WARM_STEPS} perturbed steps: "
          f"{live} live lanes; the batched launch ({plan.path} kernel, "
          f"{plan.threads_per_world} threads a world, "
          f"{sh.get('resident_worlds')} worlds resident at once): median of "
          f"{TIMED_CALLS} calls {ms:.4f} ms, one world alone {one_ms:.4f} "
          f"ms, twin {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}; live lanes), {contract_ms:.6f} ms from the bytes "
          f"the contract moves (every lane's accumulators in and out)")

    # worlds 0 and 63 of a perturbed batch against the single-world step,
    # in lockstep (each single step starts from the batch's world)
    single = world.make_step(cap, classes, 4, True)
    assert single.tail_w == bstep.tail_w
    pert = state_from_numpy(perturbed_leaves(
        base, n_w, seed=11, kick=(0, 7, (1.5, 0.5))), "cuda")
    worst = 0.0
    for _ in range(LOCKSTEP_STEPS):
        nxt = bstep(pert, 1 / 60)
        for w in (0, n_w - 1):
            want = state_to_numpy(single(unstack_state(pert, w), 1 / 60))
            got = state_to_numpy(unstack_state(nxt, w))
            for key, a in got.items():
                bb = want[key]
                if a.dtype.kind == "f":
                    d = float(np.abs(a - bb).max()) if a.size else 0.0
                    worst = max(worst, d)
                    assert d <= 1e-5, f"lockstep world {w} {key}: {d}"
                else:
                    assert np.array_equal(a, bb), f"lockstep world {w} {key}"
        pert = nxt
    print(f"[batch] worlds 0 and {n_w - 1} of a perturbed batch against "
          f"the single-world step, {LOCKSTEP_STEPS} steps in lockstep: max "
          f"|d| {worst:.3e} (bound 1e-5), discrete fields equal")
    return {"launches": n_batched, "max_abs_err": err_twin,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "single_ms": one_ms,
            "contract_ms": contract_ms}


# worlds of the batches whose capacity keeps the cluster kernel, and their
# scenes: pyramid-60 (1,831 bodies) and joint_farm(300) (1,500 bodies; a
# color's bucket and its 1,200 joint lanes take 1,584)
CLUSTER_WORLDS = 4
CLUSTER_ROWS = 60
CLUSTER_RAGDOLLS = 300


def _cluster_path_batch():
    """CLUSTER_WORLDS perturbed pyramid-60 and joint_farm(300) worlds,
    whose capacities' plans keep the cluster kernel (its contact-only and
    its jointed instance), after WARM_STEPS steps: each batched launch
    against its single launches and itself, bit for bit, and its twin; no
    launch takes the small-world kernel."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch.state import state_to_numpy

    n_w = CLUSTER_WORLDS
    state, _, _, bstep = _batch_setup(CLUSTER_ROWS)
    cases = [(f"{n_w} x pyramid-{CLUSTER_ROWS}", _perturbed_args(
        state_to_numpy(state), n_w, JACOBI_SEEDS[0], bstep))]
    state, _, bstep = _rl_batch(1, ragdolls=CLUSTER_RAGDOLLS)
    args = _perturbed_args(state_to_numpy(state), n_w, JACOBI_SEEDS[0],
                           bstep, kick_body=1)
    assert len(args) == 12, "the batched step packed no joint region"
    cases.append((f"with joint regions, {n_w} x joint_farm("
                  f"{CLUSTER_RAGDOLLS})", args))
    for tag, args in cases:
        plan, _ = _plan_of(args)
        assert plan.path == "cluster", f"{tag}: {plan}"
        small0 = cs.SMALL_LAUNCHES
        r = _batched_against_single(f"{tag} after {WARM_STEPS} steps", args)
        assert cs.SMALL_LAUNCHES == small0, (
            f"{tag}: a launch took the small kernel")
        assert not r["unequal"], (f"{tag}: launches not bit for bit: "
                                  f"{r['unequal'][:3]}")
        assert r["out_bt"] == 0, (f"{tag}: {r['out_bt']} values outside "
                                  f"atol {ATOL} / rtol {RTOL} of the twin")


def _batch_statics(builder):
    """(pair classes, joint types, sensor shape ids) of a built world, as
    api.World.compile takes them."""
    from box2d_tpu_torch.joints import joint_types_present
    from box2d_tpu_torch.narrowphase import classes_for_shape_types
    from box2d_tpu_torch.sensors import sensor_shape_ids

    return (classes_for_shape_types(s["geom"].type for s in builder._shapes),
            joint_types_present(j["_type"] for j in builder._joints),
            sensor_shape_ids(builder._shapes))


def _rl_batch(n_w, device="cuda", ragdolls=1):
    """joint_farm(ragdolls) built on `device` with Capacity.batched (the
    default repair tier): its spawn state, n_w copies of it and its
    batched step."""
    import dataclasses

    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.state import broadcast_state

    w = scenes.joint_farm(ragdolls=ragdolls, device=device)
    state, cap = w.builder.build(device=device)
    cap = dataclasses.replace(cap, batched=True)
    classes, jtypes, sensors = _batch_statics(w.builder)
    bstep = world.make_batched_step(
        cap, classes, 4, w.builder.def_.enable_continuous,
        joint_types=jtypes, sensor_ids=sensors)
    return state, broadcast_state(state, n_w), bstep


def _rl_run(bstep, batch0, steps):
    """The vmapped RL loop: each step writes every world's torso motor
    speed (joint 0) into the batched (W, J) joint arrays on the card, then
    steps the batch."""
    import dataclasses

    n_w = batch0.bodies.center.shape[0]
    dev = batch0.bodies.center.device
    t_idx = torch.arange(steps, device=dev, dtype=torch.float32)[:, None]
    w_idx = torch.arange(n_w, device=dev, dtype=torch.float32)[None]
    actions = 2.0 * torch.sin(0.05 * t_idx + w_idx) + torch.where(
        w_idx % 2 == 0, 1.5, -1.5)
    lanes = (torch.arange(n_w, device=dev),
             torch.zeros(n_w, dtype=torch.long, device=dev))
    b = batch0
    for k in range(steps):
        b = dataclasses.replace(b, joints=dataclasses.replace(
            b.joints, motor_speed=b.joints.motor_speed.index_put(
                lanes, actions[k])))
        b = bstep(b, 1 / 60)
    return b


def _vmapped_rl(n_w, steps):
    """n_w x joint_farm(1) as a batch of worlds, `steps` steps of the RL
    loop from spawn after one warm run, timed: one joint-region solver
    launch a work step, the actions reaching the dynamics (the torso
    angular velocities split by the parity of their world). Returns the
    step, the batch after the run, the launches and the timing line's
    numbers."""
    from box2d_tpu_torch import batch as bt
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch.state import state_to_numpy

    tag = f"{n_w} x joint_farm(1) vmapped RL loop"
    state, batch0, bstep = _rl_batch(n_w)
    _rl_run(bstep, batch0, min(steps, WARM_STEPS))      # warm run
    torch.cuda.synchronize()
    bstep.stats = bt.BatchStats()
    cs.BATCHED_LAUNCHES = cs.BATCHED_JOINT_LAUNCHES = cs.SMALL_LAUNCHES = 0
    cs.LAUNCHES = cs.JOINT_LAUNCHES = 0
    t0 = time.perf_counter()
    b = _rl_run(bstep, batch0, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = bstep.stats
    n_joint, n_single = cs.BATCHED_JOINT_LAUNCHES, cs.LAUNCHES
    work = st.steps - st.idle_steps
    assert n_joint == cs.BATCHED_LAUNCHES == work == st.solver_launches > 0, (
        f"{tag}: {n_joint} joint-region launches for {work} work steps")
    assert cs.SMALL_LAUNCHES == n_joint, (
        f"{tag}: {cs.SMALL_LAUNCHES} of {n_joint} launches took the "
        f"small-world kernel")
    assert n_single == 0, f"{tag}: {n_single} single-world launches"
    leaves = state_to_numpy(b)
    for k, v in leaves.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), f"{tag}: non-finite {k}"
    w_t = leaves["bodies.w"][:, 1]
    even, odd = w_t[0::2].mean(), w_t[1::2].mean()
    assert even > odd + 0.1, (
        f"{tag}: actions did not differentiate worlds: even {even:.3f} "
        f"vs odd {odd:.3f}")
    step_ms = wall / steps * 1e3
    reads0 = st.syncs
    launches_step, busy_ms = _device_work(lambda: bstep(b, 1 / 60))
    busy = (f"{busy_ms:.3f} ms of device time, idle "
            f"{100 * (1 - busy_ms / step_ms):.1f}% of a {step_ms:.3f} ms "
            f"step" if busy_ms else "device time not measured")
    n_body = int((state.bodies.type == 2).sum()) * n_w
    sps = steps / wall
    print(f"[batch] {tag}: {n_body} dynamic bodies, {steps} steps from "
          f"spawn in {wall:.3f} s: {sps:.2f} steps/s, {sps * n_body:.1f} "
          f"body-steps/s; reads/step {st.syncs / st.steps:.2f}; idle steps "
          f"{st.idle_steps}; solver launches/step {n_joint / work:.2f} (one "
          f"for all {n_w} worlds, with their joint regions); one more step "
          f"under the profiler: CUDA launches "
          f"{launches_step or 'not measured'}, reads {st.syncs - reads0}, "
          f"{busy}; torso angular velocity even worlds {even:.3f}, odd "
          f"{odd:.3f}; tail windows of {bstep.tail_w} lanes")
    return state, bstep, n_joint


def _timed_once(fn):
    """(fn(), its time in ms from CUDA events around the one call, queued
    behind the device-side wait of median_ms)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def _joint_batch_row(tag, args, calls, plain_ms=None, loop_ms=None):
    """The batched joint launch's row figures at `args`: median device ms
    over `calls` calls, its twin's, W single launches' (one timed block of
    all W, and W times the median of world 0's), the bound and the
    clusters the card holds at once. plain_ms / loop_ms: the twin's and
    the single launches' times where the caller took them already (one
    call each, with _timed_once)."""
    from box2d_tpu_torch import contact_solver as cs

    n_w = args[0].shape[0]
    ms = median_ms(lambda: cs.contact_solve_batched(*args), calls)
    if plain_ms is None:
        plain_ms = median_ms(
            lambda: cs.contact_solve_batched_reference(*args),
            max(1, calls // 5))
    singles = [_single_args(args, w) for w in range(n_w)]

    def all_single():
        for a in singles:
            cs.contact_solve(*a)

    if loop_ms is None:
        loop_ms = median_ms(all_single, max(1, calls // 5))
    one_ms = median_ms(lambda: cs.contact_solve(*singles[0]), calls)
    bound_ms, bound_by = _batched_bound_ms(args)
    contract_ms = _batched_bound_ms(args, dead_lanes=True)[0]
    plan, sh = _plan_of(args)
    jr = args[11]
    print(f"[batch] {tag}: the batched joint launch ({plan.path} kernel, "
          f"{plan.threads_per_world} threads a world, "
          f"{plan.worlds_per_cta} worlds a CTA, {sh.get('resident_worlds')} "
          f"worlds resident at once): "
          f"{int((args[1][:, 0] >= 0).sum())} "
          f"live contact lanes, {int((jr.idx[:, 0] >= 0).sum())} live joint "
          f"lanes, worlds whose coloring overflowed "
          f"{int(jr.overflow.sum())}; median {ms:.4f} ms; the {n_w} single "
          f"launches {loop_ms:.4f} ms one after another ({n_w} x world 0's "
          f"{one_ms:.4f} ms = {n_w * one_ms:.4f} ms); twin {plain_ms:.4f} "
          f"ms; bound {bound_ms:.6f} ms ({bound_by}; live lanes), "
          f"{contract_ms:.6f} ms from the bytes the contract moves")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, single_loop_ms=loop_ms,
                single_sum_ms=n_w * one_ms, single_ms=one_ms,
                contract_ms=contract_ms,
                resident_worlds=sh.get("resident_worlds"))


def _hub_batch_args():
    """The batched solver's arguments for three hub worlds
    (port_fixtures.hub_scene: 24 joints of three types on one dynamic
    hub, whose joint coloring overflows) after two steps, world 1 with all
    but three of its joints disabled: a world whose coloring overflows
    beside one that does not, with fewer live joints under one LJ."""
    import dataclasses

    from box2d_tpu_torch import api, geometry, types, world
    from box2d_tpu_torch import batch as bt
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    w = hub_scene(api.World, types, geometry, device="cuda")
    state, cap = w.builder.build(device="cuda")
    classes, jtypes, sensors = _batch_statics(w.builder)
    bstep = world.make_batched_step(
        dataclasses.replace(cap, batched=True), classes, 4, False,
        joint_types=jtypes, sensor_ids=sensors)
    leaves = perturbed_leaves(state_to_numpy(state), 3, seed=50,
                              kick=(2, 1, (0.0, 1.0)))
    leaves["joints.enabled"][1, 3:] = False
    b = state_from_numpy(leaves, "cuda")
    for _ in range(2):
        b = bstep(b, 1 / 60)
    args = bt.batched_kernel_args(b, 1 / 60, bstep)
    flags = args[11].overflow.tolist()
    assert flags == [1, 0, 1], f"hub batch: overflow flags {flags}"
    return args


def _vmapped_jointed():
    """Phase 6 (e)-(g): the RL loop as a batch of 64 and of 1,024 worlds,
    and 64 api_scene worlds with sensors, both hooks and the repair tier.
    Returns the batched joint launch's two rows (64 and 1,024 worlds)."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch.state import state_to_numpy

    # (e) 64 worlds: timed, then the batched launch held to 64 single
    # launches and itself (bit for bit) and to its twin on the card
    t0 = time.perf_counter()
    state, bstep, n_e = _vmapped_rl(RL_WORLDS, RL_STEPS)
    base = state_to_numpy(state)
    results = []
    results.append(_batched_against_single(
        "with joint regions, 3 x hub (coloring overflow in worlds 0 and 2, "
        "not in world 1)", _hub_batch_args()))
    seed = JACOBI_SEEDS[0]
    args = _perturbed_args(base, RL_WORLDS, seed, bstep, kick_body=1)
    assert len(args) == 12, "the batched step packed no joint region"
    results.append(_batched_against_single(
        f"with joint regions, {RL_WORLDS} x joint_farm(1) seed {seed} "
        f"after {WARM_STEPS} steps", args))
    for r in results:
        assert not r["unequal"], (f"batched joint launch not bit for bit: "
                                  f"{r['unequal'][:3]}")
        assert r["out_bt"] == 0, (
            f"batched joint launch: {r['out_bt']} values outside atol "
            f"{ATOL} / rtol {RTOL} of the twin")
    row_e = _joint_batch_row(f"{RL_WORLDS} x joint_farm(1)", args,
                             TIMED_CALLS)
    row_e.update(launches=n_e, max_abs_err=max(r["bt"] for r in results))
    print(f"[batch] (e) done in {time.perf_counter() - t0:.1f} s")

    # (f) 1,024 worlds: timed; the batched launch once against the 1,024
    # single launches, bit for bit
    t0 = time.perf_counter()
    state, bstep, n_f = _vmapped_rl(RL_BIG_WORLDS, RL_BIG_STEPS)
    args = _perturbed_args(state_to_numpy(state), RL_BIG_WORLDS, 11, bstep,
                           kick_body=1)
    ob = cs.contact_solve_batched(*args)
    singles = [_single_args(args, w) for w in range(RL_BIG_WORLDS)]
    one, loop_ms = _timed_once(lambda: [cs.contact_solve(*a)
                                        for a in singles])
    for i, x in enumerate(ob):
        assert torch.equal(x, torch.stack([o[i] for o in one])), (
            f"{RL_BIG_WORLDS} worlds: the batched joint launch differs from "
            f"the single launches (output {i})")
    twin, plain_ms = _timed_once(
        lambda: cs.contact_solve_batched_reference(*args))
    err_f = max(float((a - b).abs().max()) for a, b in zip(ob, twin))
    print(f"[batch] {RL_BIG_WORLDS} x joint_farm(1) after {WARM_STEPS} "
          f"perturbed steps: the batched joint launch equals the "
          f"{RL_BIG_WORLDS} single launches bit for bit; max |d| from its "
          f"twin {err_f:.3e}")
    row_f = _joint_batch_row(f"{RL_BIG_WORLDS} x joint_farm(1)", args, 5,
                             plain_ms=plain_ms, loop_ms=loop_ms)
    row_f.update(launches=n_f, max_abs_err=err_f)
    print(f"[batch] (f) done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _vmapped_api_scene()
    print(f"[batch] (g) done in {time.perf_counter() - t0:.1f} s")
    return row_e, row_f


def _vmapped_api_scene():
    """(g) 64 perturbed api_scene worlds (world 1 kicked, world 2 asleep)
    with every event kind, the default repair tier, Capacity.batched, the
    custom filter and pre_solve hooks of tests/test_torch_api.py and no
    continuous pass, API_STEPS steps; worlds API_LOCKSTEP (the kicked
    and the asleep world among them) held to the single-world step in
    lockstep at every step, and every world at the last step (each single
    step starts from the batch's world): floats within 1e-5, discrete
    leaves (events, pairs, tiers, colors) equal."""
    import dataclasses

    from box2d_tpu_torch import api, geometry, types, world
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch.state import (state_from_numpy, state_to_numpy,
                                       unstack_state)

    def keep_pair(state, a, b):
        return (a + b) % 3 != 0

    def one_way(state, a, b, manifold):
        return (manifold.normal[:, 1] < 0.9) | (a % 2 == 0)

    tag = f"{API_WORLDS} x api_scene vmapped"
    w = with_all_events(api_scene(api.World, types, geometry,
                                  device="cuda"), API_THRESHOLD)
    cap = dataclasses.replace(w.builder.default_capacity(), max_verts=8,
                              batched=True)
    state, cap = w.builder.build(cap, device="cuda")
    assert cap.bp_repair_cap > 0
    classes, jtypes, sensors = _batch_statics(w.builder)
    kw = dict(joint_types=jtypes, sensor_ids=sensors,
              custom_filter=keep_pair, pre_solve=one_way)
    bstep = world.make_batched_step(cap, classes, 4, False, **kw)
    single = world.make_step(cap, classes, 4, False, **kw)
    assert single.tail_w == bstep.tail_w
    b = state_from_numpy(perturbed_leaves(
        state_to_numpy(state), API_WORLDS, seed=21, kick=API_KICK,
        asleep=(API_ASLEEP,)), "cuda")
    worst = 0.0
    small0 = cs.SMALL_LAUNCHES
    kinds = np.zeros((API_STEPS, API_WORLDS), np.int64)
    dropped = 0
    n_events = dict(contact=0, hit=0, sensor=0, joint=0)
    t_batch = 0.0
    for k in range(API_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt = bstep(b, 1 / 60)
        torch.cuda.synchronize()
        t_batch += time.perf_counter() - t0
        got_all = state_to_numpy(nxt)
        held = range(API_WORLDS) if k == API_STEPS - 1 else API_LOCKSTEP
        for wi in held:
            want = state_to_numpy(single(unstack_state(b, wi), 1 / 60))
            for key, bb in want.items():
                a = got_all[key][wi]
                if a.dtype.kind == "f":
                    d = float(np.abs(a - bb).max()) if a.size else 0.0
                    worst = max(worst, d)
                    assert d <= 1e-5, f"{tag} step {k + 1} world {wi} {key}"
                else:
                    assert np.array_equal(a, bb), (
                        f"{tag} step {k + 1} world {wi} {key}")
        kinds[k] = got_all["profile.pair_rebuild"]
        # the filter's drops: a rebuild's candidates that are not valid
        full = kinds[k] == 2
        dropped += int((got_all["profile.pair_count"]
                        - got_all["broadphase.valid"].sum(axis=1))[full].sum())
        sa, sb = got_all["broadphase.shape_a"], got_all["broadphase.shape_b"]
        dropped_ok = (got_all["broadphase.valid"] & ((sa + sb) % 3 == 0))
        assert not dropped_ok.any(), (
            f"{tag}: a pair the custom filter drops at local ids is valid")
        for name, key in (("contact", "contact_begin_count"),
                          ("hit", "hit_count"),
                          ("sensor", "sensor_begin_count"),
                          ("joint", "joint_force_count")):
            n_events[name] += int(got_all[f"events.{key}"].sum())
        b = nxt
    assert cs.SMALL_LAUNCHES - small0 == bstep.stats.solver_launches > 0, (
        f"{tag}: {cs.SMALL_LAUNCHES - small0} small-kernel launches, "
        f"{bstep.stats.solver_launches} solver launches")
    assert (kinds == 1).any(), f"{tag}: no world took the repair tier"
    assert dropped > 0, f"{tag}: the custom filter dropped no pair"
    assert all(n > 0 for n in n_events.values()), f"{tag}: {n_events}"
    st = bstep.stats
    leaves = state_to_numpy(b)
    for key in ("overflow_pairs", "events_dropped"):
        assert int(leaves[f"profile.{key}"].max()) == 0, f"{tag}: {key}"
    sps = API_STEPS / t_batch
    print(f"[batch] {tag} (every joint type, a sensor box, a filtered box, "
          f"an open chain; hooks, repair tier, every event kind on): "
          f"{API_STEPS} steps, the batched step alone {t_batch:.3f} s "
          f"({sps:.2f} steps/s); reads/step {st.syncs / st.steps:.2f}; "
          f"solver launches {st.solver_launches}; steps where some world "
          f"repaired {int((kinds == 1).any(axis=1).sum())}, kept "
          f"{int((kinds == 0).any(axis=1).sum())}, rebuilt "
          f"{int((kinds == 2).any(axis=1).sum())}; pairs the filter dropped "
          f"in rebuilds {dropped}; events in all worlds {n_events}; worlds "
          f"{API_LOCKSTEP} at every step and all {API_WORLDS} at the last "
          f"against the single-world step in lockstep: max "
          f"|d| {worst:.3e} (bound 1e-5), discrete leaves and events equal")


def _flat_batches():
    """scenes.replicate of pyramid-20 x 64 and pyramid-8 x 1,024, each
    timed from spawn after one warm run."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes

    out = {}
    for n_w, rows in FLAT:
        tag = f"{n_w} x pyramid-{rows} flat"
        w = scenes.replicate(scenes.pyramid(rows=rows, device="cuda"), n_w)
        w.compile()
        n_dyn = int((w.state.bodies.type == 2).sum())
        state0 = w.state
        w.run(FLAT_STEPS)
        torch.cuda.synchronize()
        w.state = state0
        w.reset_stats()
        cs.LAUNCHES = 0
        t0 = time.perf_counter()
        w.run(FLAT_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = w.stats
        n_launch = cs.LAUNCHES
        leaves, prof = _check_finite(w, tag)
        overflow = {k: prof[k] for k in (
            "overflow_pairs", "overflow_colors", "overflow_ccd",
            "store_drops", "events_dropped")}
        work = st.steps - st.idle_steps
        assert n_launch == work > 0, f"{tag}: {n_launch} launches"
        scene_note = _pyramid_check(leaves, tag)
        sps = FLAT_STEPS / wall
        print(f"[batch] {tag}: {n_dyn} dynamic bodies, kernel mode "
              f"{w._step.mode}, tail windows of {w._step.tail_w} lanes; "
              f"{FLAT_STEPS} steps from spawn in {wall:.3f} s: {sps:.2f} "
              f"steps/s, {sps * n_dyn:.1f} body-steps/s; reads/step "
              f"{st.syncs / st.steps:.2f}; solver launches {n_launch}; "
              f"overflow counters at the last step {overflow}; "
              f"{scene_note}")
        out[tag] = n_launch
    return out


def _rl_loop():
    """tests/test_rl_demo.py on the card: 64 ragdolls tiled into one world,
    a per-world motor speed written on the card every step (no host read
    for it), rewards from the event surface summed on the card."""
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes

    base = scenes.joint_farm(ragdolls=1, device="cuda")
    w = scenes.replicate(base, RL_WORLDS)
    w.compile()
    n_joints = len(base.builder._joints)
    n_bodies = len(base.builder._bodies)
    n_shapes = len(base.builder._shapes)
    dev = w.state.bodies.center.device
    motor_lanes = torch.arange(RL_WORLDS, device=dev) * n_joints
    world_of_body = torch.arange(w.state.bodies.center.shape[0],
                                 device=dev) // n_bodies
    t_idx = torch.arange(FLAT_RL_STEPS, device=dev,
                         dtype=torch.float32)[:, None]
    w_idx = torch.arange(RL_WORLDS, device=dev, dtype=torch.float32)[None]
    actions = 2.0 * torch.sin(0.05 * t_idx + w_idx) + torch.where(
        w_idx % 2 == 0, 1.5, -1.5)
    rewards = torch.zeros((FLAT_RL_STEPS, RL_WORLDS), device=dev)
    w.reset_stats()
    cs.LAUNCHES = 0
    cs.JOINT_LAUNCHES = 0
    import dataclasses
    t0 = time.perf_counter()
    for k in range(FLAT_RL_STEPS):
        s = w.state
        w.state = dataclasses.replace(s, joints=dataclasses.replace(
            s.joints, motor_speed=s.joints.motor_speed.index_put(
                (motor_lanes,), actions[k])))
        w.step(1 / 60)
        ev = w.state.events
        moved = torch.zeros(RL_WORLDS, device=dev).index_add(
            0, world_of_body, ev.body_moved.float())
        cb_ok = (torch.arange(ev.contact_begin.shape[0], device=dev)
                 < ev.contact_begin_count)
        cb_world = torch.where(cb_ok, ev.contact_begin[:, 0] // n_shapes,
                               RL_WORLDS).long()
        contacts = torch.zeros(RL_WORLDS + 1, device=dev).index_add(
            0, cb_world, torch.ones_like(cb_world, dtype=torch.float32))
        rewards[k] = moved + 0.1 * contacts[:RL_WORLDS]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = w.stats
    r = rewards.cpu().numpy()
    assert np.isfinite(r).all() and r.sum() > 0.0, "RL: rewards"
    w_t = w.state.bodies.w.cpu().numpy()[1::n_bodies]
    even, odd = w_t[0::2], w_t[1::2]
    assert even.mean() > odd.mean() + 0.1, (
        f"RL: actions did not differentiate worlds: even {even.mean():.3f} "
        f"vs odd {odd.mean():.3f}")
    work = st.steps - st.idle_steps
    assert cs.JOINT_LAUNCHES == work > 0, f"RL: {cs.JOINT_LAUNCHES} K2j"
    print(f"[batch] RL loop, {RL_WORLDS} x joint_farm(1) flat, "
          f"{FLAT_RL_STEPS} steps in {wall:.3f} s: "
          f"{FLAT_RL_STEPS / wall:.2f} steps/s; reads/step "
          f"{st.syncs / st.steps:.2f}; joint-sweep (K2j) launches "
          f"{cs.JOINT_LAUNCHES}; torso angular velocity even worlds "
          f"{even.mean():.3f}, odd {odd.mean():.3f}; reward sum "
          f"{r.sum():.1f}")
    return {"rl joint_sweep": cs.JOINT_LAUNCHES}


def _flat_particle_batches():
    """64 x dam_break(500) and 8 x dam_break(12000) tiled into one world
    each: per-block shape culling on, K3 and K4; then the culled coupling
    held to the dense one for one step. Returns (launches, steps/s of
    each)."""
    from box2d_tpu_torch import particles as tpart
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    out, rates = {}, {}
    for n_w, n in FLAT_PARTICLES:
        tag = f"{n_w} x dam_break-{n} flat"
        w = scenes.replicate(scenes.dam_break(n, device="cuda"), n_w)
        w.compile()
        cfg = w._step.particle_cfg
        assert cfg.max_body_shapes > cfg.block_shape_slots, (
            f"{tag}: the culled path is not taken")
        n_live = int(w.state.particles.alive.sum())
        state0 = w.state
        w.run(5)
        torch.cuda.synchronize()
        w.state = state0
        w.reset_stats()
        pk.K3_LAUNCHES = 0
        pk.K4_LAUNCHES = 0
        t0 = time.perf_counter()
        w.run(FLAT_PARTICLE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = w.stats
        k3, k4 = pk.K3_LAUNCHES, pk.K4_LAUNCHES
        leaves, prof = _check_finite(w, tag)
        assert k3 == 12 * FLAT_PARTICLE_STEPS, f"{tag}: {k3} K3 launches"
        assert k4 == st.rank_repairs, f"{tag}: {k4} K4 launches"
        # the reference's sizing of the culling slots overflows where a
        # block of sorted particles spans several copies of a grid row
        # (tests/test_torch_culling.py holds the count to the JAX
        # package's): printed, and held to the CPU's count on one step
        stt = w.state
        cpu = state_from_numpy(state_to_numpy(stt), "cpu")
        card = tpart.particle_step(stt.particles, stt, 1 / 60, cfg,
                                   world.StepStats())
        host = tpart.particle_step(cpu.particles, cpu, 1 / 60, cfg,
                                   world.StepStats())
        ov_card, ov_cpu = int(card[3]), int(host[3])
        assert ov_card == ov_cpu, f"{tag}: overflow {ov_card} vs {ov_cpu}"
        alive = card[0].alive.cpu()
        assert torch.equal(alive, host[0].alive), f"{tag}: card alive"
        # phase 4's card-against-CPU bounds for particles (dam_break-1000):
        # sums in other orders flip a few particles across a threshold
        d_card = []
        for x, y, tol in ((card[0].pos, host[0].pos, 1e-3),
                          (card[0].vel, host[0].vel, 1e-2)):
            x = x.cpu()[alive]
            torch.testing.assert_close(x, y[alive], rtol=0, atol=tol)
            d_card.append(float((x - y[alive]).abs().max()))
        note = (f"card against CPU, one culled step: overflow {ov_card} = "
                f"{ov_cpu}, max |d| pos {d_card[0]:.3e}, vel "
                f"{d_card[1]:.3e}")
        if n == FLAT_PARTICLES[0][1]:
            # the culled coupling against the dense one, one step on the
            # card, with slots enough that no block overflows (still fewer
            # than the nearby shapes, so the culled path runs)
            wide = cfg._replace(block_shape_slots=cfg.max_body_shapes - 4)
            dense = cfg._replace(block_shape_slots=cfg.max_body_shapes)
            a = tpart.particle_step(stt.particles, stt, 1 / 60, wide,
                                    world.StepStats())
            assert int(a[3]) == 0, f"{tag}: overflow with {wide} slots"
            b = tpart.particle_step(stt.particles, stt, 1 / 60, dense,
                                    world.StepStats())
            alive = a[0].alive
            assert torch.equal(alive, b[0].alive), f"{tag}: culled alive"
            errs = []
            for x, y in ((a[0].pos[alive], b[0].pos[alive]),
                         (a[0].vel[alive], b[0].vel[alive]), (a[1], b[1]),
                         (a[2], b[2])):
                torch.testing.assert_close(x, y, rtol=CULL_RTOL,
                                           atol=CULL_ATOL)
                errs.append(float((x - y).abs().max()) if x.numel() else 0.0)
            note += (f"; culled ({wide.block_shape_slots} slots, no "
                     f"overflow) against dense coupling, one step: max |d| "
                     f"pos {errs[0]:.3e}, vel {errs[1]:.3e}, body dv "
                     f"{errs[2]:.3e}, dw {errs[3]:.3e} (rtol {CULL_RTOL}, "
                     f"atol {CULL_ATOL})")
        sps = FLAT_PARTICLE_STEPS / wall
        print(f"[batch] {tag}: {n_live} live particles, max_body_shapes "
              f"{cfg.max_body_shapes}, block_shape_slots "
              f"{cfg.block_shape_slots}; {FLAT_PARTICLE_STEPS} steps in "
              f"{wall:.3f} s: {sps:.2f} steps/s, {sps * n_live:.1f} "
              f"particle-steps/s; K3 launches {k3}; K4 repairs {k4} against "
              f"{st.full_sorts} full sorts; overflow_particles "
              f"{prof['overflow_particles']} (the reference's slot sizing, "
              f"ROADMAP section 3); {note}")
        out[f"{tag} K3"] = k3
        out[f"{tag} K4"] = k4
        rates[(n_w, n)] = (sps, st.syncs / st.steps)
    return out, rates


def _compare_worlds(got, want, exact_only=False):
    """Two single-world states leaf by leaf: discrete leaves (counts, ids,
    flags, alive) must be equal; returns (the largest float difference,
    whether every float leaf is equal bit for bit)."""
    from box2d_tpu_torch.state import state_to_numpy

    a, b = state_to_numpy(got), state_to_numpy(want)
    assert sorted(a) == sorted(b)
    worst, same = 0.0, True
    for key in b:
        if b[key].dtype.kind != "f":
            assert np.array_equal(a[key], b[key]), f"{key} differs"
            continue
        if a[key].tobytes() != b[key].tobytes():
            same = False
            assert not exact_only, f"{key} differs"
            if a[key].size:
                worst = max(worst, float(np.abs(a[key] - b[key]).max()))
    return worst, same


def _k3_plan_note(plan):
    """A K3 batched plan as chip_smoke prints it: the kernel, and on the
    small-world kernel its groups and what the card reports of the
    damping instance at that shape."""
    from box2d_tpu_torch import particles_kernels as pk

    if plan.path == "grid":
        return (f"grid kernel ({-(-plan.n // pk.B_BLK)} blocks of "
                f"{pk.B_BLK} lanes a world)")
    shape = pk.k3_small_shape(plan, pk.PH_DAMPING)
    return (f"small-world kernel ({-(-plan.n // plan.lanes)} groups of "
            f"{plan.lanes} lanes a world, 3 threads a lane, groups a CTA: "
            f"{plan.groups_per_cta}; {shape['smem_per_cta']} "
            f"bytes of shared memory a CTA, {shape['ctas_per_sm']} CTAs an "
            f"SM, {shape['registers']} registers, {shape['local_bytes']} "
            f"local bytes a thread)")


def _other_k3_plan(plan):
    """The batched K3 plan on the kernel `plan` does not take; None where
    a world's table does not fit a CTA's shared memory on the small
    kernel (the kernel's own count)."""
    from box2d_tpu_torch import particles_kernels as pk

    if plan.path == "small":
        return pk.k3_batched_plan(plan.n, "grid")
    small = pk.k3_batched_plan(plan.n, "small")
    shape = pk.k3_small_shape(small, pk.PH_DAMPING)
    return small if shape["smem_per_cta"] <= SMEM_OPT_IN else None


def _k3_against_all(tag, args):
    """One batched K3 call on the kernel its plan picks, against the other
    kernel on the same arrays (where the table fits both), its W single
    launches and a second launch of itself, bit for bit, and its twin run
    on the card (atol 1e-5, rtol 0), the grid kernel's blocks counted by
    path. Returns (plan, other plan, |kernel - twin|, the result)."""
    from box2d_tpu_torch import particles_kernels as pk

    n_w, n, phase = args[1].shape[0], args[1].shape[1], args[6]
    plan = pk.k3_batched_plan(n)
    other = _other_k3_plan(plan)
    kern = pk.window_pass_batched(*args)
    again = pk.window_pass_batched(*args)
    one = torch.stack([pk.window_pass(*(a[w] for a in args[:6]), phase)
                       for w in range(n_w)])
    # with paths, the grid kernel
    paths = torch.zeros(2, dtype=torch.int32, device="cuda")
    grid = pk.window_pass_batched(*args, paths=paths)
    alt = (None if other is None or other.path == "grid"
           else pk.window_pass_batched(*args, plan=other))
    twin = pk.window_pass_batched_reference(*args)
    torch.cuda.synchronize()
    err = float((kern - twin).abs().max()) if kern.numel() else 0.0
    assert torch.equal(kern, again), f"{tag}: not repeatable"
    assert torch.equal(kern, one), f"{tag}: not the single launches'"
    assert torch.equal(kern, grid), f"{tag}: not the grid kernel's"
    assert alt is None or torch.equal(kern, alt), f"{tag}: not the small's"
    torch.testing.assert_close(kern, twin, atol=1e-5, rtol=0)
    assert paths.tolist() == list(pk.k3_block_paths(args[1], args[2]))
    return plan, other, err, kern


def _batched_k3_check(tag, calls, row):
    """The batched K3 launch on recorded inputs (_k3_against_all), its plan
    printed; then timed on its kernel and on the other one, against the
    twin and the W single launches one after another. Adds to `row`."""
    from box2d_tpu_torch import particles_kernels as pk

    for args, pname in zip(calls, ("weight", "pressure", "damping")):
        n_w, phase = args[1].shape[0], args[6]
        plan, other, err, kern = _k3_against_all(f"{tag} K3 {pname}", args)
        assert float(kern.abs().max()) > 0, f"{tag} K3 {pname}: all zero"
        bound_ms, bound_by, cand = _k3_batched_bound_ms(args, phase)
        ms = _time_ms(lambda: pk.window_pass_batched(*args))
        other_ms = (None if other is None else _time_ms(
            lambda: pk.window_pass_batched(*args, plan=other)))
        plain_ms = _time_ms(lambda: pk.window_pass_batched_reference(*args))
        loop_ms = _time_ms(lambda: [pk.window_pass(
            *(a[w] for a in args[:6]), phase) for w in range(n_w)])
        other_note = ("the small-world kernel cannot hold a world's table"
                      if other is None else
                      f"the {other.path} kernel on the same arrays "
                      f"{other_ms:.4f} ms")
        print(f"[batch] K3 batched {pname}, {tag}: {n_w} worlds x "
              f"{args[1].shape[1]} lanes, candidates {cand}; plan: "
              f"{_k3_plan_note(plan)}; equal bit for bit to its {n_w} "
              f"single launches, to itself"
              f"{'' if other is None else ' and to the ' + other.path}"
              f"{'' if other is None else ' kernel'}, max |kernel - twin| "
              f"{err:.3e}; median of {TIMED_CALLS} calls: "
              f"kernel {ms:.4f} ms, {other_note}, the {n_w} single launches "
              f"{loop_ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by})")
        row["path"] = plan.path
        row["err"] = max(row["err"], err)
        row["ms"].append(ms)
        row["other_ms"].append(other_ms)
        row["plain_ms"].append(plain_ms)
        row["bound_ms"].append(bound_ms)
        row["bound_by"].add(bound_by)


def _k3_batched_stress():
    """K3 batched on port_fixtures.k3_batched_table's stress worlds (dead
    lanes, a field across y = 0, one dense cell, a world with no live
    particle) at VPART_STRESS's shapes (W = 1 and W = 1,024 among them,
    and the widest table the small kernel takes), each phase held by
    _k3_against_all. Launches made here do not count toward the main
    path. Returns the largest |kernel - twin|."""
    from box2d_tpu_torch import particles_kernels as pk

    worst = 0.0
    for n_w, n in VPART_STRESS:
        n = n or pk.K3_SMALL_LANES
        base = tuple(x.cuda() for x in k3_batched_table(n_w, n, seed=n_w))
        for phase, pname in enumerate(("weight", "pressure", "damping")):
            tag = f"K3 batched {pname}, stress {n_w} x {n}"
            plan, other, err, _ = _k3_against_all(tag, base + (phase,))
            worst = max(worst, err)
        print(f"[batch] K3 batched, stress tables {n_w} worlds x {n} lanes "
              f"({', '.join(K3_KINDS[:min(n_w, 4)])}): plan "
              f"{_k3_plan_note(plan)}; each phase equal bit for bit to the "
              f"{other.path if other else 'no other'} kernel, its {n_w} "
              f"single launches and itself, max |kernel - twin| "
              f"{worst:.3e}")
    return worst


def _vmapped_particles(flat_rates):
    """Phase 6 (h), (i): VPART's batches of dam_break worlds through
    make_batched_step: the timed run from spawn (one batched K3 launch a
    phase for all worlds, 12 a step, no K4, no single K3), its rates
    beside the flat batch of the same size from this run, its launches,
    reads and device share a step; the batched K3 launch against single
    launches, itself and its twin; the worlds of VPART_LOCKSTEP in
    lockstep with the single-world step. Then the gated batch. Returns the
    kernels line's rows and the launches."""
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.state import (state_from_numpy, state_to_numpy,
                                       unstack_state)

    rows, launches = [], {}
    for n_w, n, steps in VPART:
        tag = f"{n_w} x dam_break-{n} vmapped"
        w = scenes.dam_break(n, device="cuda")
        w.compile()
        cfg = w._step.particle_cfg
        r = float(w.state.particles.params.radius)
        leaves0 = perturbed_leaves(state_to_numpy(w.state), n_w, seed=11,
                                   particle_jitter=0.005,
                                   param_spread=VPART_SPREAD / n_w)
        batch0 = state_from_numpy(leaves0, "cuda")
        n_live = int(batch0.particles.alive.sum())

        def make():
            return world.make_batched_step(w.capacity, w._classes, 4,
                                           w._step.continuous,
                                           particle_cfg=cfg)

        bstep = make()
        b = batch0
        for _ in range(VPART_WARM):
            b = bstep(b, 1 / 60)
        torch.cuda.synchronize()
        bstep = make()
        pk.K3_LAUNCHES = pk.K3_BATCHED_LAUNCHES = pk.K4_LAUNCHES = 0
        pk.K3_SMALL_LAUNCHES = 0
        t0 = time.perf_counter()
        b = batch0
        for _ in range(steps):
            b = bstep(b, 1 / 60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3b, k3, k4 = pk.K3_BATCHED_LAUNCHES, pk.K3_LAUNCHES, pk.K4_LAUNCHES
        k3s = pk.K3_SMALL_LAUNCHES
        st = bstep.stats
        plan = pk.k3_batched_plan(w.state.particles.pos.shape[0])
        assert k3b == 12 * steps, f"{tag}: {k3b} batched K3 launches"
        # every batched launch on the kernel its plan picks
        assert k3s == (k3b if plan.path == "small" else 0), (
            f"{tag}: {k3s} launches on the small-world kernel")
        assert k3 == 0 and k4 == 0, f"{tag}: K3 {k3}, K4 {k4} launches"
        assert st.rank_repairs == 0 and st.full_sorts == 4 * steps
        leaves = state_to_numpy(b)
        for key, v in leaves.items():
            if v.dtype.kind == "f":
                assert np.isfinite(v).all(), f"{tag}: non-finite {key}"
        alive = leaves["particles.alive"]
        assert alive.sum() == n_live, f"{tag}: particles died"
        ov = leaves["profile.overflow_particles"]
        assert (ov == 0).all(), f"{tag}: particle overflow {ov}"
        tunnelled = int((_in_tank_box(leaves["particles.pos"], r)
                         & ~_in_tank_box(leaves0["particles.pos"], r)
                         & alive).sum())
        assert tunnelled == 0, f"{tag}: {tunnelled} particles tunnelled"
        kernels, busy = _device_work(lambda: bstep(b, 1 / 60))
        sps = steps / wall
        flat_sps, flat_reads = flat_rates[(n_w, n)]
        ms_step = 1e3 * wall / steps
        idle = ("not measured" if busy is None else
                f"{100 * max(0.0, 1 - busy / ms_step):.1f}%")
        print(f"[batch] ({'h' if n_w == VPART[0][0] else 'i'}) {tag}: "
              f"{n_live} live particles in {n_w} worlds; {steps} steps from "
              f"spawn in {wall:.3f} s: {sps:.2f} steps/s, "
              f"{sps * n_live:.1f} particle-steps/s (the flat batch of the "
              f"same size in this run: {flat_sps:.2f} steps/s, "
              f"{flat_reads:.2f} reads a step); reads/step "
              f"{st.syncs / st.steps:.2f}; batched K3 launches {k3b} "
              f"({k3b / steps:.0f}/step; on the small-world kernel {k3s}: "
              f"{_k3_plan_note(plan)}), single K3 0, K4 0; rigid work "
              f"steps {st.steps - st.idle_steps}, solver launches "
              f"{st.solver_launches}; one step: {kernels} kernels, device "
              f"busy {busy if busy is None else round(busy, 3)} ms of "
              f"{ms_step:.3f}, idle {idle}; overflow 0, tunnelled 0")
        launches[f"{tag} K3 batched"] = k3b
        row = dict(err=0.0, ms=[], other_ms=[], plain_ms=[], bound_ms=[],
                   bound_by=set(), launches=k3b, small_launches=k3s,
                   tag=tag)
        _batched_k3_check(tag, record_batched_k3(bstep, b), row)
        rows.append(row)

        # lockstep: each world of VPART_LOCKSTEP stepped alone from the
        # batch's state before each step (the single step without the
        # rank repair, which the batch never takes)
        one = world.make_step(w.capacity, w._classes, 4, w._step.continuous,
                              w._jtypes, cfg._replace(rank_repair=False))
        lock = tuple(sorted({0, 1, n_w - 1}))
        b, worst, same = batch0, 0.0, True
        for _ in range(VPART_LOCKSTEP_STEPS):
            prev, b = b, bstep(b, 1 / 60)
            for k in lock:
                d, eq = _compare_worlds(unstack_state(b, k),
                                        one(unstack_state(prev, k), 1 / 60))
                worst, same = max(worst, d), same and eq
        print(f"[batch] {tag}: worlds {lock} in lockstep with the "
              f"single-world step for {VPART_LOCKSTEP_STEPS} steps: counts, "
              f"alive and overflow equal; floats max |d| {worst:.3e}, bit "
              f"for bit: {same} (the path's index_add_ of the body "
              f"impulses and its row reductions are float sums)")
        assert worst <= 1e-5, f"{tag}: lockstep {worst}"
    # the stress tables all take the small-world kernel: their error
    # goes to its rows
    stress = _k3_batched_stress()
    for row in rows:
        if row["path"] == "small":
            row["err"] = max(row["err"], stress)
    launches.update(_vmapped_gated())
    return rows, launches


def _vmapped_gated():
    """VPART_GATED worlds of every_gate_tank (each with every particle
    flag, spring, elastic and barrier groups, a solid and a rigid group
    and a dynamic box) through make_batched_step, running free beside the
    single-world gated step of each world for VPART_GATED_STEPS steps:
    equal bit for bit (the gated path's sums run in a fixed order), one
    batched solver launch a rigid work step, no K3 or K4."""
    from box2d_tpu_torch import api
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import types as t
    from box2d_tpu_torch import world
    from box2d_tpu_torch.state import (state_from_numpy, state_to_numpy,
                                       unstack_state)

    n_w, n = VPART_GATED
    wg = every_gate_tank(api.World, t, g, particles=n, device="cuda")
    wg.compile()
    cfg = wg._step.particle_cfg
    assert cfg.has_barrier and cfg.has_rigid and cfg.has_solid
    tag = (f"{n_w} x every_gate_tank-"
           f"{int(wg.state.particles.alive.sum())} vmapped")
    b = state_from_numpy(perturbed_leaves(
        state_to_numpy(wg.state), n_w, seed=13, particle_jitter=0.005,
        param_spread=VPART_SPREAD / n_w), "cuda")
    bstep = world.make_batched_step(wg.capacity, wg._classes, 4,
                                    wg._step.continuous,
                                    joint_types=wg._jtypes,
                                    particle_cfg=cfg)
    singles = [unstack_state(b, k) for k in range(n_w)]
    ones = [world.make_step(wg.capacity, wg._classes, 4, wg._step.continuous,
                            wg._jtypes, cfg) for _ in range(n_w)]
    pk.K3_LAUNCHES = pk.K3_BATCHED_LAUNCHES = pk.K4_LAUNCHES = 0
    cs.SMALL_LAUNCHES = 0
    wall = 0.0
    for _ in range(VPART_GATED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = bstep(b, 1 / 60)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        for k in range(n_w):
            singles[k] = ones[k](singles[k], 1 / 60)
            _compare_worlds(unstack_state(b, k), singles[k], exact_only=True)
    st = bstep.stats
    k3 = pk.K3_LAUNCHES + pk.K3_BATCHED_LAUNCHES + pk.K4_LAUNCHES
    work = st.steps - st.idle_steps
    assert k3 == 0, f"{tag}: {k3} K3 / K4 launches"
    assert work > 0 and st.solver_launches == work == cs.SMALL_LAUNCHES, (
        f"{tag}: {st.solver_launches} solver launches ({cs.SMALL_LAUNCHES} "
        f"on the small-world kernel), {work} work steps")
    print(f"[batch] {tag}: {VPART_GATED_STEPS} batched steps in {wall:.3f} "
          f"s ({VPART_GATED_STEPS / wall:.2f} steps/s), reads/step "
          f"{st.syncs / st.steps:.2f}, depth rounds {st.rounds['depth']}; "
          f"every world equal bit for bit to its single-world gated step, "
          f"running free, at each of the {VPART_GATED_STEPS} steps; batched "
          f"solver launches {st.solver_launches} in {work} work steps, all "
          f"on the small-world kernel; K3 0, K4 0")
    return {f"{tag} solver batched": st.solver_launches}


# ---------------------------------------------------------------------------
# phase 7: particle groups
# ---------------------------------------------------------------------------

GROUP_PARTICLES = 100000
GROUP_STEPS = 120
GROUP_CHECK_AT = 30     # the second card-against-CPU step of groups_tank
#                         (the third is from the end of the run)
GATE_PARTICLES = 4096


def phase_particle_groups():
    """The gated particle path at full scale and every gate on a small
    tank, on the card against the CPU. Returns its kernel launches."""
    t0 = time.perf_counter()
    launches = _groups_tank()
    launches.update(_every_gate_tank())
    print(f"[groups] phase 7 in {time.perf_counter() - t0:.1f} s")
    return launches


def _triad_shape_error(pt):
    """Mean over the live elastic triads and their corners of |R p_rest -
    p| (m): p a corner's offset from its triad's midpoint, R the rotation
    that best fits the rest offsets to them (SolveElastic's)."""
    from box2d_tpu_torch import math2d as m2
    from box2d_tpu_torch.particles import P_ELASTIC

    ta, tb, tc = (x.long() for x in (pt.triad_a, pt.triad_b, pt.triad_c))
    live = (((pt.triad_flags & P_ELASTIC) != 0) & pt.alive[ta]
            & pt.alive[tb] & pt.alive[tc])
    p = [pt.pos[i] for i in (ta, tb, tc)]
    mid = (p[0] + p[1] + p[2]) / 3.0
    p = [x - mid for x in p]
    rest = (pt.triad_pa, pt.triad_pb, pt.triad_pc)
    rc = sum(m2.dot(r, x) for r, x in zip(rest, p))
    rs = sum(m2.cross(r, x) for r, x in zip(rest, p))
    rot = m2.rot_normalize(torch.stack([rc, rs], dim=-1))
    err = sum(m2.length(m2.rot_vec(rot, r) - x)
              for r, x in zip(rest, p)) / 3.0
    return float(err[live].mean())


def _particle_step_against_cpu(tag, wc, wp, state):
    """One particle_step, each world's own configuration, from `state` on
    the card and from its copy on the CPU. The body impulses it returns,
    its overflow and the particle leaves it moves must be equal bit for
    bit (the gated path sums in a fixed order on both devices). Returns
    the number of bodies the particles pushed."""
    from box2d_tpu_torch.particles import particle_step
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    cpu = state_from_numpy(state_to_numpy(state), "cpu")
    pc, dvc, dwc, ovc = particle_step(state.particles, state, 1 / 60,
                                      wc._step.particle_cfg)
    pp, dvp, dwp, ovp = particle_step(cpu.particles, cpu, 1 / 60,
                                      wp._step.particle_cfg)
    for name, a, b in (("body_dv", dvc, dvp), ("body_dw", dwc, dwp),
                       ("overflow", ovc, ovp), ("pos", pc.pos, pp.pos),
                       ("vel", pc.vel, pp.vel)):
        _close(f"{tag} particle_step {name}", a, b, exact=True)
    return int(((dvp != 0).any(dim=1) | (dwp != 0)).sum())


def _repeat_distance(w, start):
    """The world's step run twice from `start` on the card. Returns the
    largest difference between the two results over the float leaves of
    the particles and over those of the rest of the state, and whether
    every other particle leaf is equal. The particle step reads only the
    step's start, so its leaves repeat bit for bit when its sums do."""
    from box2d_tpu_torch.state import state_to_numpy

    out = []
    for _ in range(2):
        w.state = start
        w.step()
        out.append(state_to_numpy(w.state))
    d_part, d_rest, same = 0.0, 0.0, True
    for k, a in out[0].items():
        b = out[1][k]
        if a.dtype.kind == "f":
            d = float(np.abs(a - b).max()) if a.size else 0.0
            if k.startswith("particles."):
                d_part = max(d_part, d)
            else:
                d_rest = max(d_rest, d)
        elif k.startswith("particles."):
            same &= bool(np.array_equal(a, b))
    return d_part, d_rest, same


def _groups_tank():
    """Phase 7 (a) and (d): groups_tank(GROUP_PARTICLES) from spawn."""
    from box2d_tpu_torch import api
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import types as t
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    tag = f"groups_tank-{GROUP_PARTICLES}"
    t0 = time.perf_counter()
    w = groups_tank(api.World, t, g, particles=GROUP_PARTICLES,
                    device="cuda")
    w.compile()
    t_build = time.perf_counter() - t0
    cfg = w._step.particle_cfg
    assert cfg.has_viscous and cfg.has_elastic and not cfg.has_spring
    state0 = w.state
    pt0 = state0.particles
    n_live = int(pt0.alive.sum())
    n_pairs = int((pt0.pair_flags != 0).sum())
    n_triads = int((pt0.triad_flags != 0).sum())
    err0 = _triad_shape_error(pt0)
    # the warm run; its state after GROUP_CHECK_AT steps is kept for the
    # card-against-CPU check
    w.run(GROUP_CHECK_AT)
    at_check = w.state
    w.run(GROUP_STEPS - GROUP_CHECK_AT)
    torch.cuda.synchronize()
    w.state = state0
    w.reset_stats()
    cs.LAUNCHES = 0
    pk.K3_LAUNCHES = 0
    pk.K4_LAUNCHES = 0
    t0 = time.perf_counter()
    w.run(GROUP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = w.stats
    n_solve, k3, k4 = cs.LAUNCHES, pk.K3_LAUNCHES, pk.K4_LAUNCHES
    leaves, prof = _check_state(w, tag)
    rigid = st.steps - st.idle_steps
    assert k3 == 0 and k4 == 0, (
        f"{tag}: K3 {k3} / K4 {k4} launches on the gated path")
    assert n_solve == rigid > 0, f"{tag}: {n_solve} solver launches"
    assert st.full_sorts == 4 * GROUP_STEPS and st.rank_repairs == 0
    alive = leaves["particles.alive"]
    assert alive.sum() == n_live, f"{tag}: particles died"
    pos = leaves["particles.pos"][alive]
    diameter = 2 * float(leaves["particles.params.radius"])
    low = float(pos[:, 1].min())
    assert low > -diameter, (
        f"{tag}: a particle ended at y = {low}, more than a diameter below "
        f"the ground's top")
    dyn = leaves["bodies.type"] == 2
    box_low = float(leaves["bodies.center"][dyn, 1].min())
    assert box_low > 0.0, f"{tag}: a box fell through the ground"
    err = _triad_shape_error(w.state.particles)
    end = w.state
    n_kern, dev_ms = _device_work(w.step)
    ms = wall / GROUP_STEPS * 1e3
    idle = ("not measured" if dev_ms is None
            else f"{100 * (1 - dev_ms / ms):.1f}%")
    sps = GROUP_STEPS / wall
    print(f"[groups] {tag}: {n_live} live particles (water, viscous, "
          f"elastic), {n_pairs} pairs, {n_triads} triads, "
          f"{int(dyn.sum())} boxes; built in {t_build:.1f} s; "
          f"{GROUP_STEPS} steps from spawn in {wall:.3f} s: {sps:.2f} "
          f"steps/s, {sps * n_live:.1f} particle-steps/s, {ms:.2f} ms a "
          f"step; reads/step {st.syncs / st.steps:.2f}; device work of one "
          f"step (torch.profiler): {n_kern} kernels, {dev_ms} ms, idle "
          f"{idle}; K3 0, K4 0, full sorts {st.full_sorts}; solver "
          f"launches {n_solve} (rigid steps {rigid}); overflow_particles "
          f"{prof['overflow_particles']} (max_body_shapes "
          f"{cfg.max_body_shapes}, block_shape_slots "
          f"{cfg.block_shape_slots}); elastic triad shape error "
          f"{err0:.3e} m at spawn, {err:.3e} m after {GROUP_STEPS} steps; "
          f"lowest particle y {low:.4f}, lowest box centre y "
          f"{box_low:.4f}")

    # one step from spawn, one after GROUP_CHECK_AT and one after
    # GROUP_STEPS steps against a CPU
    # World from the same state
    wp = groups_tank(api.World, t, g, particles=GROUP_PARTICLES,
                     device="cpu")
    wp.compile()
    notes = []
    total_pushed = 0
    for label, start in (("spawn", state0),
                         (f"{GROUP_CHECK_AT} steps", at_check),
                         (f"{GROUP_STEPS} steps", end)):
        w.state = start
        wp.state = state_from_numpy(state_to_numpy(start), "cpu")
        t0 = time.perf_counter()
        wp.step()
        t_cpu = time.perf_counter() - t0
        w.step()
        assert torch.equal(w.state.particles.alive.cpu(),
                           wp.state.particles.alive), f"{tag}: alive"
        d = [_close(f"{tag} one step from {label} {f}",
                    getattr(getattr(w.state, f.split(".")[0]),
                            f.split(".")[1]),
                    getattr(getattr(wp.state, f.split(".")[0]),
                            f.split(".")[1]), atol=1e-4, rtol=0.0)
             for f in ONE_STEP_FIELDS]
        pushed = _particle_step_against_cpu(f"{tag} from {label}", w, wp,
                                            start)
        notes.append(f"from {label}: max |d| " + ", ".join(
            f"{f} {x:.3e}" for f, x in zip(ONE_STEP_FIELDS, d))
            + f"; particle_step alone equal bit for bit, body impulses on "
            f"{pushed} bodies (CPU step {t_cpu:.1f} s)")
        total_pushed += pushed
    assert total_pushed > 0, f"{tag}: no body took a particle impulse"
    print(f"[groups] {tag} card against CPU, one step (bound 1e-4): "
          + "; ".join(notes))

    # (d) repeatability: the scatter-adds run in lane order on the card
    d_part, d_rest, same = _repeat_distance(w, end)
    print(f"[groups] {tag} repeatability: one step twice from the state "
          f"after {GROUP_STEPS} steps, max |d| particles {d_part:.3e} "
          f"(other particle leaves equal: {same}), the rest of the state "
          f"{d_rest:.3e}")
    assert d_part == 0.0 and same and d_rest == 0.0, (
        f"{tag}: the step differs")
    return {f"{tag} solver": n_solve, f"{tag} K3": k3, f"{tag} K4": k4}


def _every_gate_tank():
    """Phase 7 (b), (c), (d): every_gate_tank(GATE_PARTICLES)."""
    from box2d_tpu_torch import api
    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import geometry as g
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import types as t
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    ws = {}
    for dev in ("cuda", "cpu"):
        ws[dev] = every_gate_tank(api.World, t, g, particles=GATE_PARTICLES,
                                  device=dev)
        ws[dev].compile()
    wc, wp = ws["cuda"], ws["cpu"]
    cfg = wc._step.particle_cfg
    assert all(getattr(cfg, f) for f in cfg._fields if f.startswith("has_"))
    pt = wc.state.particles
    n = int(pt.alive.sum())
    tag = f"every_gate_tank-{n}"
    start = state_to_numpy(wc.state)
    cs.LAUNCHES = 0
    pk.K3_LAUNCHES = 0
    pk.K4_LAUNCHES = 0
    pushed = []
    _lockstep(f"{tag} (every flag, solid and rigid groups)", wc, wp,
              ("particles.pos", "particles.vel") + ONE_STEP_FIELDS[2:],
              each=lambda st: pushed.append(_particle_step_against_cpu(
                  tag, wc, wp, st)))
    assert sum(pushed) > 0, f"{tag}: no body took a particle impulse"
    print(f"[groups] {tag}: particle_step alone, card against CPU from "
          f"each lockstep state: equal bit for bit (body impulses, "
          f"overflow, positions, velocities); bodies pushed a step "
          f"{pushed}")
    n_solve, k3, k4 = cs.LAUNCHES, pk.K3_LAUNCHES, pk.K4_LAUNCHES
    assert k3 == 0 and k4 == 0 and n_solve > 0, (n_solve, k3, k4)
    st = wc.stats
    assert st.rounds["depth"] > 0, f"{tag}: no depth relaxation"
    print(f"[groups] {tag}: {int((pt.pair_flags != 0).sum())} pairs, "
          f"{int((pt.triad_flags != 0).sum())} triads; solver launches "
          f"{n_solve}, K3 0, K4 0; depth relaxation rounds "
          f"{st.rounds['depth']}, its reads {st.rounds['reads']}; "
          f"reads/step {st.syncs / st.steps:.2f}")

    # (c) the six particle methods, card against CPU, then one step
    after = state_to_numpy(wc.state)
    got = {}
    for dev, w in ws.items():
        w.state = state_from_numpy(after, w.device)

        def put(a, w=w):
            return torch.as_tensor(a, device=w.device)

        got[dev] = [particle_api_case(w, name, lambda x: x.cpu().numpy(),
                                      put)
                    for name in PARTICLE_API]
    for name, a, b in zip(PARTICLE_API, got["cuda"], got["cpu"]):
        if name == "stuck_particles":
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
        else:
            assert a == b, f"{name}: {a} against {b}"
    la, lb = state_to_numpy(wc.state), state_to_numpy(wp.state)
    worst = 0.0
    for k in (k for k in la if k.startswith("particles.")):
        assert la[k].shape == lb[k].shape, k
        if la[k].dtype.kind == "f":
            np.testing.assert_allclose(la[k], lb[k], rtol=0, atol=1e-5,
                                       err_msg=k)
            worst = max(worst, float(np.abs(la[k] - lb[k]).max()))
        else:
            assert np.array_equal(la[k], lb[k]), k
    joined = la["particles.pair_a"].shape[0], la["particles.triad_a"].shape[0]
    for w in ws.values():
        w.step()
    d = [_close(f"{tag} step after the API calls particles.{f}",
                getattr(wc.state.particles, f),
                getattr(wp.state.particles, f), atol=1e-4, rtol=0.0)
         for f in ("pos", "vel")]
    shown = {name: ([len(x) for x in r] if name == "stuck_particles"
                    else r)
             for name, r in zip(PARTICLE_API, got["cuda"])}
    print(f"[groups] {tag} particle API card against CPU: results "
          f"{shown} (stuck_particles: counts), particle leaves max |d| "
          f"{worst:.3e} (bound 1e-5), pairs / "
          f"triads after the join {joined}; one step after: max |d| pos "
          f"{d[0]:.3e}, vel {d[1]:.3e} (bound 1e-4)")

    # (d) repeatability of the every-gate step on the card
    d_part, d_rest, same = _repeat_distance(
        wc, state_from_numpy(start, wc.device))
    print(f"[groups] {tag} repeatability: one step twice from spawn, max "
          f"|d| particles {d_part:.3e} (other particle leaves equal: "
          f"{same}), the rest of the state {d_rest:.3e}")
    assert d_part == 0.0 and same and d_rest == 0.0, (
        f"{tag}: the step differs")
    return {f"{tag} solver": n_solve, f"{tag} K3": k3, f"{tag} K4": k4}


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernel_vs_twin()
    jkern = phase_joint_kernel_vs_twin()
    k3, k4 = phase_particle_kernels()
    launches = phase_main_path()
    ccd_launches = phase_ccd_paths()
    print(f"[main] solver launches on the continuous-collision paths: "
          f"{ccd_launches}")
    api_launches = phase_queries_and_host_api()
    print(f"[main] kernel launches on the queries and host-API paths: "
          f"{api_launches}")
    t6 = time.perf_counter()
    batched, (jbatch, jbatch_big), prows, batch_launches = phase_batching()
    print(f"[main] kernel launches on the batching paths: {batch_launches}; "
          f"phase 6 in {time.perf_counter() - t6:.1f} s")
    group_launches = phase_particle_groups()
    print(f"[main] kernel launches on the particle-group paths: "
          f"{group_launches}")
    big = kern[(140, WARM_STEPS)]
    small = kern[(20, WARM_STEPS)]
    farm = jkern["joint_farm-1000"]
    mean = statistics.fmean
    # no single PyTorch call computes either function (a persistent
    # multi-stage constraint solve), so library_ms is null
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    # K1 and K2 are one kernel: its row at pyramid-20 (the mode-1 TPU
    # kernel's scenes) and at pyramid-140 (the tiled one's)
    print(json.dumps({"kernels": [{
        "name": "contact_solve_mode1",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/contact_solver.cu",
        "replaces": "box2d_tpu/solver_pallas.py:410 (run_solver_kernel; "
                    "body _solver_kernel :101)",
        "launches": launches["pyramid-20"],
        "max_abs_err": max(small["err"],
                           kern[f"bullet_barrage-{BARRAGE_BULLETS}"]["err"]),
        "ms": small["ms"],
        "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"],
        "bound_by": small["bound_by"],
        "library_ms": None,
    }, {
        "name": "contact_solve",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/contact_solver.cu",
        "replaces": "box2d_tpu/solver_pallas.py:1747 "
                    "(run_solver_kernel_tiled; body _tiled_kernel :1250)",
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
    }, {
        # the mode-1 kernel under jax.vmap: one launch for every world of
        # a batch; bound from the bytes and operations of all its worlds
        "name": "contact_solve_batched",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/contact_solver.cu",
        "replaces": "box2d_tpu/solver_pallas.py:410 (run_solver_kernel "
                    "under jax.vmap, bench.py:143-149)",
        "launches": batched["launches"],
        "max_abs_err": batched["max_abs_err"],
        "ms": batched["ms"],
        "plain_ms": batched["plain_ms"],
        "bound_ms": batched["bound_ms"],
        "bound_by": batched["bound_by"],
        "library_ms": None,
    }] + [{
        # the jointed kernel under jax.vmap: one launch for W worlds with
        # their joint regions, at 64 (e) and 1,024 (f) worlds of the RL
        # loop; bound from the bytes and operations of all its worlds
        "name": f"contact_solve_joints_batched_{n_w}",
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/joint_sweep.cuh",
        "replaces": "box2d_tpu/solver_pallas.py:681 (_joint_sweep, traced "
                    "into :1815, under jax.vmap)",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
    } for n_w, r in ((RL_WORLDS, jbatch), (RL_BIG_WORLDS, jbatch_big))] + [{
        # K3 under jax.vmap: one launch a phase for W worlds' tables, at
        # (h) 64 x dam_break-500 and (i) 8 x dam_break-12000; per launch,
        # the mean over its three phases; bound from all worlds' tables;
        # no single PyTorch call computes a neighbour sum. path: the
        # kernel k3_batched_plan picks ("small": window_small_kernel,
        # "grid": window_kernel on a (blocks, W) grid), small_launches
        # its launches on the small kernel, other_ms the other kernel's
        # time on the same arrays (null where the table does not fit the
        # small kernel)
        "name": name,
        "path": r["path"],
        "small_launches": r["small_launches"],
        "other_ms": (None if None in r["other_ms"]
                     else mean(r["other_ms"])),
        "route": "cuda",
        "source": "box2d_tpu_torch/csrc/particles.cu",
        "replaces": "box2d_tpu/particles_pallas.py:396 (window_pass under "
                    "jax.vmap, box2d_tpu/particles.py:855-877)",
        "launches": r["launches"],
        "max_abs_err": r["err"],
        "ms": mean(r["ms"]),
        "plain_ms": mean(r["plain_ms"]),
        "bound_ms": mean(r["bound_ms"]),
        "bound_by": "/".join(sorted(r["bound_by"])),
        "library_ms": None,
    } for name, r in zip(("particle_window_batched",
                          "particle_window_batched_8x12000"), prows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
