#!/usr/bin/env python3
"""Where a step of the PyTorch / CUDA port spends its time on one GPU.

    python3 profile_port.py [joint_farm-1000 | pyramid-140 | pyramid-20 |
                             dam_break-100000 | tumbler-2000 |
                             bullet_barrage-100 | groups_tank-100000]...

For each scene: steps it 100 times from spawn (warm), times 20 unprofiled
steps on the host clock (ended by torch.cuda.synchronize()), then traces 10
more steps with torch.profiler and prints the wall time per step, the sum of
the CUDA kernel time per step (so the device's idle share), the number of
kernels and device reads per step, and the ten kernels with the most device
time. A scene with continuous collision (bullet_barrage, whose bullets
reach the first wall about 12 steps from spawn) is run over its first
STEPS_CCD steps from spawn instead, after one warm run of them: timed as a
whole, then step by step with its continuous pass broken out (per gated
step, per gated step whose TOI sweep did not run and per step whose TOI
sweep ran: the pass's wall time and its share of the step, both ended by
a synchronize, its device reads, the TOI pairs and the rounds of each TOI
loop), then traced for the pass's kernels and device time. The first line is the card's name and power limit. It needs
a CUDA device; there is no CPU path.
"""

import subprocess
import sys
import time
from contextlib import nullcontext

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WARM, TIMED, TRACED = 100, 20, 10
STEPS_CCD = 30


def make(name):
    from box2d_tpu_torch import scenes

    kind, _, size = name.partition("-")
    if kind == "joint_farm":
        return scenes.joint_farm(int(size))
    if kind == "pyramid":
        return scenes.pyramid(rows=int(size))
    if kind == "dam_break":
        return scenes.dam_break(int(size))
    if kind == "tumbler":
        return scenes.tumbler(int(size))
    if kind == "bullet_barrage":
        return scenes.bullet_barrage(int(size))
    if kind == "groups_tank":
        # the gated particle path: water, viscous and elastic groups with
        # ten boxes on top (port_fixtures.groups_tank)
        from box2d_tpu_torch import api, geometry, types
        from port_fixtures import groups_tank

        return groups_tank(api.World, types, geometry, particles=int(size))
    raise SystemExit(f"unknown scene {name}")


# the ranges the traced run marks; the trace holds a device-side twin of
# each, which is not a kernel
RANGES = ("step", "continuous_pass")


class PassRecorder:
    """Wraps world.continuous_pass: for each call, whether the gate
    opened, the TOI pairs it swept, its device reads, the TOI loops'
    rounds and its wall time (ended by a synchronize); it also marks the
    call as a "continuous_pass" range for a profiler."""

    def __init__(self):
        from box2d_tpu_torch import world

        self.world = world
        self.inner = world.continuous_pass
        self.calls = []
        world.continuous_pass = self

    def __call__(self, state, bs, dt, stats, *caps):
        before = (stats.ccd_gate_openings, stats.toi_pairs, stats.syncs,
                  dict(stats.rounds))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("continuous_pass"):
            out = self.inner(state, bs, dt, stats, *caps)
        torch.cuda.synchronize()
        self.calls.append(dict(
            ms=(time.perf_counter() - t0) * 1e3,
            gated=stats.ccd_gate_openings > before[0],
            pairs=stats.toi_pairs - before[1],
            reads=stats.syncs - before[2],
            rounds={k: v - before[3][k] for k, v in stats.rounds.items()}))
        return out

    def restore(self):
        self.world.continuous_pass = self.inner


def _subtree(ev):
    """(kernels launched, their device ms) under a profiler event."""
    n = len(ev.kernels)
    ms = sum(k.duration for k in ev.kernels) / 1e3
    for child in ev.cpu_children:
        cn, cms = _subtree(child)
        n += cn
        ms += cms
    return n, ms


def _kernel_rows(prof):
    return [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in RANGES]


def run(name):
    w = make(name)
    w.compile()
    ccd = name.startswith("bullet_barrage")
    if ccd:
        run_ccd(name, w)
        return
    w.run(WARM)
    torch.cuda.synchronize()
    w.reset_stats()
    t0 = time.perf_counter()
    w.run(TIMED)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / TIMED * 1e3
    st = w.stats
    syncs = st.syncs / st.steps
    idle_steps = st.idle_steps
    gate = st.ccd_gate_openings
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w.run(TRACED)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    busy_ms = sum(r[1] for r in rows) / TRACED
    n_kernels = sum(r[2] for r in rows) / TRACED
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    print(f"[profile] {name}: after {WARM} steps, {wall_ms:.3f} ms/step "
          f"unprofiled ({idle_steps} idle steps of {TIMED}); kernel busy "
          f"{busy_ms:.3f} ms/step, device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of a step; "
          f"{n_kernels:.0f} kernels/step; {syncs:.2f} device reads/step; "
          f"CCD gate openings {gate} of {TIMED}")
    _top(name, rows, TRACED)


def _top(name, rows, steps):
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"[profile] {name}:   {ms / steps:.4f} ms/step "
              f"x{count / steps:.1f}  {key[:100]}")


def run_ccd(name, w):
    """The first STEPS_CCD steps from spawn, after one warm run of them:
    timed unprofiled, then traced with the continuous pass broken out."""
    state0 = w.state
    w.run(STEPS_CCD)
    torch.cuda.synchronize()
    w.state = state0
    w.reset_stats()
    t0 = time.perf_counter()
    w.run(STEPS_CCD)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / STEPS_CCD * 1e3
    st = w.stats
    print(f"[profile] {name}: the first {STEPS_CCD} steps from spawn, "
          f"{wall_ms:.3f} ms/step unprofiled; {st.syncs / st.steps:.2f} "
          f"device reads/step; CCD gate openings {st.ccd_gate_openings}; "
          f"TOI pairs {st.toi_pairs}, hits {st.toi_hits}, retries "
          f"{st.toi_retries}")

    def stepwise(traced):
        """STEPS_CCD steps from spawn, each ended by a synchronize; returns
        the continuous pass's records and each step's ms."""
        w.state = state0
        w.reset_stats()
        rec = PassRecorder()
        step_ms = []
        try:
            for _ in range(STEPS_CCD):
                t0 = time.perf_counter()
                with record_function("step") if traced else nullcontext():
                    w.step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            rec.restore()
        return rec.calls, step_ms

    calls, step_ms = stepwise(False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_calls, traced_ms = stepwise(True)
    rows = _kernel_rows(prof)
    busy_ms = sum(r[1] for r in rows) / STEPS_CCD
    n_kernels = sum(r[2] for r in rows) / STEPS_CCD
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    # the host-side ranges (the trace also holds their device-side twins)
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    steps = [e for e in host if e.name == "step"]
    passes = [e for e in host if e.name == "continuous_pass"]
    if len(steps) != STEPS_CCD or len(passes) != len(traced_calls):
        raise SystemExit(f"{len(steps)} step ranges, {len(passes)} pass "
                         f"ranges for {len(traced_calls)} calls")
    stepped = sum(step_ms) / STEPS_CCD
    traced = sum(traced_ms) / STEPS_CCD
    print(f"[profile] {name}: step by step (a synchronize ends each step "
          f"and each continuous pass) {stepped:.3f} ms/step; traced "
          f"{traced:.3f} ms/step, kernel busy {busy_ms:.3f} ms/step, "
          f"device idle {100 * (1 - busy_ms / traced):.1f}% of a traced "
          f"step, {n_kernels:.0f} kernels/step")
    for i, (call, ev) in enumerate(zip(calls, passes)):
        call["kernels"], call["device_ms"] = _subtree(ev)
        call["step_ms"] = step_ms[i]
    for what, sel in (("gated step", lambda c: c["gated"]),
                      ("gated step with no TOI sweep",
                       lambda c: c["gated"] and c["pairs"] == 0),
                      ("step with a TOI sweep", lambda c: c["pairs"] > 0)):
        cs = [c for c in calls if sel(c)]
        if not cs:
            print(f"[profile] {name}: no {what}")
            continue
        n = len(cs)
        mean = lambda k: sum(c[k] for c in cs) / n
        rounds = {k: sum(c["rounds"][k] for c in cs) / n
                  for k in cs[0]["rounds"]}
        print(f"[profile] {name}: per {what} ({n} of {STEPS_CCD}): "
              f"continuous pass {mean('ms'):.3f} ms of a {mean('step_ms'):.3f}"
              f" ms step ({100 * mean('ms') / mean('step_ms'):.1f}%); "
              f"{mean('kernels'):.0f} kernels, {mean('device_ms'):.4f} ms "
              f"device time (traced); {mean('reads'):.1f} device reads; "
              f"{mean('pairs'):.1f} TOI pairs; TOI loop rounds "
              + ", ".join(f"{k} {v:.1f}" for k, v in rounds.items()))
    _top(name, rows, STEPS_CCD)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: torch.cuda.is_available() is false")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    for name in sys.argv[1:] or ["joint_farm-1000", "pyramid-140",
                                 "dam_break-100000"]:
        run(name)


if __name__ == "__main__":
    main()
