#!/usr/bin/env python3
"""Where a step of the PyTorch / CUDA port spends its time on one GPU.

    python3 profile_port.py [joint_farm-1000 | pyramid-140 | pyramid-20 |
                             dam_break-100000]...

For each scene: steps it 100 times from spawn (warm), times 20 unprofiled
steps on the host clock (ended by torch.cuda.synchronize()), then traces 10
more steps with torch.profiler and prints the wall time per step, the sum of
the CUDA kernel time per step (so the device's idle share), the number of
kernels and device reads per step, and the ten kernels with the most device
time. The first line is the card's name and power limit. It needs a CUDA
device; there is no CPU path.
"""

import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

WARM, TIMED, TRACED = 100, 20, 10


def make(name):
    from box2d_tpu_torch import scenes

    kind, _, size = name.partition("-")
    if kind == "joint_farm":
        return scenes.joint_farm(int(size))
    if kind == "pyramid":
        return scenes.pyramid(rows=int(size))
    if kind == "dam_break":
        return scenes.dam_break(int(size))
    raise SystemExit(f"unknown scene {name}")


def run(name):
    w = make(name)
    w.compile()
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w.run(TRACED)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows) / TRACED
    n_kernels = sum(r[2] for r in rows) / TRACED
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    print(f"[profile] {name}: after {WARM} steps, {wall_ms:.3f} ms/step "
          f"unprofiled ({idle_steps} idle steps of {TIMED}); kernel busy "
          f"{busy_ms:.3f} ms/step, device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of a step; "
          f"{n_kernels:.0f} kernels/step; {syncs:.2f} device reads/step")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"[profile] {name}:   {ms / TRACED:.4f} ms/step "
              f"x{count / TRACED:.1f}  {key[:100]}")


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
