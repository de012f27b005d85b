#!/usr/bin/env python3
"""Times the solver kernel of one or more checkouts of the port on one GPU.

    python3 time_solver.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds a
box2d_tpu_torch package. For each ROOT, in the order given, a process of
its own imports that checkout's package, builds its kernel, and times
`contact_solve` with CUDA events (the median of TIMED_CALLS calls after one
warm call) at the solver inputs that checkout's own step packs after
WARM_STEPS steps from spawn, for pyramid-20 (K1), pyramid-140 (K2) and
joint_farm(1000) (K2j): the timed cases of chip_smoke.py. To compare two
versions on one card, give them in turns, e.g. parent, change, change,
parent, with the parent unpacked by `git archive` into a directory that
.gitignore lists. The first line is the card's name and power limit; the
last, one JSON object with every time. It needs a CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys

WARM_STEPS = 30
TIMED_CALLS = 20
CASES = ("pyramid-20", "pyramid-140", "joint_farm-1000")


def worker(root):
    """Time one checkout's kernel; prints one JSON object of ms by case."""
    sys.path.insert(0, root)
    import torch

    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import scenes, world

    assert os.path.dirname(os.path.abspath(cs.__file__)) == os.path.join(
        root, "box2d_tpu_torch"), cs.__file__
    cs.build()
    out = {}
    for case in CASES:
        kind, size = case.split("-")
        w = (scenes.pyramid(rows=int(size), device="cuda") if kind == "pyramid"
             else scenes.joint_farm(int(size), device="cuda"))
        w.compile()
        w.run(WARM_STEPS)
        st = w._step
        args = world._step_work(w.state, 1 / 60, w.capacity, st.classes,
                                st.substeps, st.continuous, world.StepStats(),
                                until="layout", joint_types=st.joint_types)
        cs.contact_solve(*args)
        times = []
        for _ in range(TIMED_CALLS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            cs.contact_solve(*args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        out[case] = statistics.median(times)
    print(json.dumps(out))


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(os.path.abspath(sys.argv[2]))
        return
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [
        os.path.dirname(os.path.abspath(__file__))]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(root=root, ms=ms))
        print(f"[time_solver] {root}: " + ", ".join(
            f"{case} {ms[case]:.4f} ms" for case in CASES), flush=True)
    print(json.dumps({"timed_calls": TIMED_CALLS, "runs": runs}))


if __name__ == "__main__":
    main()
