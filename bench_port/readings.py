"""The readings a cell's correctness limits are set from (PERF.md §2),
in one process, set-up once:

    python3 bench_port/readings.py <cell> [sound seeds] [control seeds]

For each seed it steps one episode up to the last step the check samples
and prints, as one JSON line, the largest gaps of the program's steps to
the reference and, on the first seeds, those of the bfloat16 control;
then those of each planted fault (harness.faults) on three seeds. Needs a
CUDA device."""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv):
    import torch

    from harness import check, cli, faults, registry, scene

    name = argv[0]
    n_sound = int(argv[1]) if len(argv) > 1 else 12
    n_ctrl = int(argv[2]) if len(argv) > 2 else 3
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = registry.cell(name)
    tr = cell["traffic_data"]
    ref = check.reference(cell)
    seeds = [2**31 + 977 * i + 13 for i in range(n_sound)]
    driver = registry.load_module("loops", cell["loop"]).build(
        cell, seeds[0], "cuda")
    built, sound = driver.built, driver.advance

    def episode(seed, fault=None):
        driver.spawn, driver.inputs = scene.spawn(built, cell, seed,
                                                  tr.get("worlds"))
        driver.advance = (faults.wrap(fault, sound, driver.kind) if fault
                          else sound)
        at = cli.snap_steps(seed, tr["episode_steps"], cell["compare_steps"])
        snaps = []
        driver.reset()
        for k in range(max(at) + 1):
            pre = check.primary(driver.state, ref.PRIMARY) if k in at \
                else None
            driver.step()
            if pre is not None:
                snaps.append((k, pre, check.primary(driver.state,
                                                    ref.PRIMARY)))
        return snaps, check.primary(driver.state, ref.PRIMARY)

    def numbers(snaps, last, control=None):
        return check.numbers(cell, snaps, last, driver.inputs, control)

    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        snaps, last = episode(seed)
        out = {"cell": name, "seed": seed, "kind": "sound",
               "gaps": numbers(snaps, last)}
        if i < n_ctrl:
            out["control"] = numbers(snaps, None, "bf16")
        out["s"] = round(time.perf_counter() - t, 2)
        print(json.dumps(out), flush=True)
    for fault in faults.NAMES:
        if fault == "half" and driver.kind != "batch":
            continue
        for seed in seeds[:3]:
            snaps, last = episode(seed, fault)
            print(json.dumps({"cell": name, "seed": seed, "kind": fault,
                              "gaps": numbers(snaps, last)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
