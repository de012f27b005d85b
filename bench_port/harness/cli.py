"""One run of one cell: set-up, the measured window, the correctness check
and the result line.

    --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up runs from the process's start to the first timed step: the imports,
the scene built on the card, the seed's worlds, and one warm episode that
builds and loads the port's kernels (nvcc's libraries are kept in
box2d_tpu_torch/_build inside the checkout, so only a checkout's first run
builds them). With --trace 0 the line holds the cell's end-to-end metrics,
with --trace 1 its per-layer metrics and the device's busy and window
seconds.

run_cell's `control` and `fault` put the bfloat16 control or a planted
fault (harness.faults) in the program's place, for the tests; readings.py
takes the same readings on the card."""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
import time
import types

from . import check, registry, window

FORBIDDEN = ("jax", "jaxlib", "flax", "box2d_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(checkout: str) -> dict:
    """The build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(checkout, ".bench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (box2d_tpu_torch is not box2d_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("no device metric without a card")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def snap_steps(seed: int, episode_steps: int, n: int) -> list:
    """The steps of the window's first episode that the check follows: the
    first (the reset) and n - 1 drawn from the seed."""
    rest = random.Random(seed).sample(range(1, episode_steps), n - 1)
    return sorted([0] + rest)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", control=None, fault=None):
    """Set up, measure and check one run; returns (result, checks) where
    checks is [(name, value, limit)], or raises."""
    import torch

    from . import faults

    tr = cell["traffic_data"]
    loop = registry.load_module("loops", cell["loop"])
    ref = check.reference(cell)
    t_build = time.perf_counter()
    driver = loop.build(cell, seed, device)
    t_warm = time.perf_counter()
    spawn_gap = check.spawn_gap(cell, driver.built)
    driver.built = None
    if fault:
        driver.advance = faults.wrap(fault, driver.advance, driver.kind)
    episode = tr["episode_steps"]
    for k in range(episode):
        if k == 0:
            driver.reset()
        driver.step()
    print(f"set-up: imports {t_build - t0:.3f} s, scene and worlds "
          f"{t_warm - t_build:.3f} s, warm episode "
          f"{time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    names = cell["per_layer"] if trace else cell["end_to_end"]
    mods = {n: registry.load_module("metrics", n) for n in names}
    hooks = {n: m.count for n, m in mods.items() if hasattr(m, "count")}
    if trace:
        if torch.device(device).type == "cuda":
            window._sync(device)
            p = window._start_profiler()
            p.stop()
        for name, hook in hooks.items():
            # the hooks' own first calls, outside the window
            hook(driver, driver.state, driver.state)
    win = window.run(driver, seconds, episode,
                     snap_steps(seed, episode, cell["compare_steps"]),
                     trace, hooks, device,
                     keep=lambda s: check.primary(s, ref.PRIMARY))
    setup_s = win.first_step_at - t0
    dev_info = device_info(device) if torch.device(device).type == "cuda" \
        else None
    ctx = types.SimpleNamespace(window=win, setup_s=setup_s,
                                units=driver.units, kind=driver.kind,
                                cell=cell)
    metrics = {}
    for n, m in mods.items():
        v = m.read(ctx)
        if v is not None:
            metrics[n] = {"value": float(v), "unit": m.UNIT}
    inputs = driver.inputs
    driver.release()
    del driver
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.numbers(cell, win.snaps, win.last, inputs, control)
    numbers["spawn_m"] = spawn_gap
    checks = [(n, numbers.get(n, float("inf")), lim)
              for n, lim in cell["limits"].items()]
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": win.steps,
              "failed": win.failed, "metrics": metrics, "device": dev_info}
    if trace and win.trace is not None:
        result["device"] = dict(dev_info or {}, busy_s=win.trace.busy_s(),
                                window_s=win.traced_s)
        result["breakdown"] = {"device_ops": win.trace.device_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks


def main(argv, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = registry.cell(args.workload)
    checkout = os.path.dirname(registry.ROOT)
    for k, v in cache_dirs(checkout).items():
        os.environ[k] = v
    import torch

    if not torch.cuda.is_available():
        print("bench_port: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t0, "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    return 0
