#!/usr/bin/env python3
"""Times the kernels of one or more checkouts of the port on one GPU.

    python3 time_solver.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds a
box2d_tpu_torch package. For each ROOT, in the order given, a process of
its own imports that checkout's package, builds its kernels, and times each
with CUDA events (the median of TIMED_CALLS calls after one warm call) at
the inputs that checkout's own step gives it:
- the solver kernel, `contact_solve`, at the solver inputs packed after
  WARM_STEPS steps from spawn for pyramid-20 (K1), pyramid-140 (K2) and
  joint_farm(1000) (K2j): the timed cases of chip_smoke.py;
- the particle kernels at dam_break(100000) (record_particle_calls): K3,
  `window_pass`, in its three phases, and K4, `rank_pass`, with beside it
  the library call that computes the same function,
  torch.argsort(stable=True) and the inverse scatter (library_rank);
- the solver kernel's Jacobi windows: pyramid-140 at spawn (two
  2,560-lane tail windows) and pyramid-20 after WARM_STEPS steps with
  three color buckets moved into its tail (three 128-lane windows), and,
  where the checkout has `contact_solve_batched`, the batched launch on
  64 perturbed pyramid-20 worlds after WARM_STEPS steps, as it is and
  with three buckets moved into every world's tail, and, where it takes
  joint regions, on 64 and 1,024 perturbed joint_farm(1) worlds (the RL
  batches of chip_smoke.py phase 6 (e), (f)) after WARM_STEPS steps.
To compare two versions on one card, give them in turns, e.g. parent,
change, change, parent, with the parent unpacked by `git archive` into a
directory that .gitignore lists. The first line is the card's name and
power limit; the last, one JSON object with every time. It needs a CUDA
device.

    python3 time_solver.py --one-process ROOT [ROOT ...]

times the solver kernel of every ROOT in one process, on the same inputs
(this checkout's pyramid-20, pyramid-140 and joint_farm(1000) after
WARM_STEPS steps, whose overflow tails are empty, so that every version
does the same work), in turns over ROUNDS rounds (in the order given,
then backward); each ROOT's package is loaded under a name of its own and
called through its own `contact_solve`. It then times the batched launch
of every ROOT that has one the same way, on this checkout's batches (64
x pyramid-20, 64 and 1,024 x joint_farm(1)), every version's result
equal to the first's bit for bit. Then the particle window pass: K3
in its three phases at dam_break(100000)'s inputs (record_particle_calls)
and K3 batched at the inputs of chip_smoke.py phase 6's batches, (h) 64 x
dam_break(500) and (i) 8 x dam_break(12000) (batched_k3_calls), each
through every ROOT's own wrapper, every version equal to the first bit
for bit. It also counts the SASS instructions of each build's
contact-only solver kernel and of K3's three single-world instances
(cuobjdump). It tells a difference in a kernel's code from one in its
inputs or its process.

    python3 time_solver.py --k3-paths

times K3 batched on both its kernels, the small-world kernel (at the
groups k3_batched_plan gives, and at groups of 128 lanes) and the grid
kernel, at K3_PATH_CASES: batches of dam_break
worlds of growing width (batched_k3_calls), the kernels' results equal
bit for bit, in turns over ROUNDS rounds. It shows where the two
kernels' times cross (particles_kernels.K3_SMALL_LANES).

    python3 time_solver.py --paths

times this checkout's batched launch on both its kernels, the one
contact_solver.batched_plan picks and the other (the cluster kernel, or
the small-world kernel at GROUP_MAX threads a world, one world a CTA),
at PATH_CASES: PATH_WORLDS perturbed worlds of pyramids and joint farms
of growing width after WARM_STEPS steps, the two kernels' results equal
bit for bit, in turns over ROUNDS rounds. It shows where the plan's
choice of kernel turns.
"""

import concurrent.futures
import importlib.util
import inspect
import json
import os
import subprocess
import sys

from port_fixtures import (TIMED_CALLS, WARM_STEPS, batched_k3_calls,
                           library_rank, median_ms, move_buckets_to_tail,
                           other_plan, perturbed_leaves,
                           record_particle_calls)

ROUNDS = 4
CASES = ("pyramid-20", "pyramid-140", "joint_farm-1000",
         "K3 weight", "K3 pressure", "K3 damping", "K4",
         "K4 library (argsort + scatter)",
         "pyramid-140 at spawn", "pyramid-20 tail",
         "64 x pyramid-20 batched", "64 x pyramid-20 batched tail",
         "64 x joint_farm(1) batched", "1,024 x joint_farm(1) batched")
# the batched cases of --one-process: (case, worlds, scene, seed)
BATCHED = (("64 x pyramid-20 batched", 64, "pyramid", 7),
           ("64 x joint_farm(1) batched", 64, "joint_farm", 7),
           ("1,024 x joint_farm(1) batched", 1024, "joint_farm", 11))
# the batches of --paths: (scene, rows or ragdolls), PATH_WORLDS worlds
PATH_CASES = (("pyramid", 20), ("pyramid", 30), ("pyramid", 40),
              ("pyramid", 60), ("pyramid", 80), ("pyramid", 84),
              ("joint_farm", 1), ("joint_farm", 100), ("joint_farm", 300),
              ("joint_farm", 700))
PATH_WORLDS = 4
# K3 batched in --one-process: (case, worlds, particles a world), chip_smoke
# phase 6 (h), (i)
K3_BATCHED = (("(h) 64 x dam_break(500) K3 batched", 64, 500),
              ("(i) 8 x dam_break(12000) K3 batched", 8, 12000))
# the batches of --k3-paths: (worlds, particles a world)
K3_PATH_CASES = tuple((64, n) for n in (100, 250, 500, 1000, 1300, 1600,
                                         2000, 3000, 4000)) + tuple(
    (8, n) for n in (500, 1000, 2000, 4000))
# the Jacobi cases: the color buckets moved into the overflow tail
TAIL_BUCKETS = 3
BATCH_WORLDS = 64


def _layout(w, steps):
    """The solver's arguments for World w after `steps` steps."""
    from box2d_tpu_torch import world

    w.compile()
    w.run(steps)
    st = w._step
    return world._step_work(w.state, 1 / 60, w.capacity, st.classes,
                            st.substeps, st.continuous, world.StepStats(),
                            until="layout", joint_types=st.joint_types)


def _batch_args(n_w=BATCH_WORLDS, scene="pyramid", seed=7, size=None):
    """The batched solver's arguments for a perturbed batch of n_w worlds
    after WARM_STEPS steps: pyramid-20 (or pyramid-`size`) as
    chip_smoke.py phase 6 batches it (bp_repair_cap 0; the last world's
    box 5 kicked), or joint_farm(1) (or joint_farm(size)) as its RL
    batches (e), (f) do (the default repair tier; the last world's body 1
    kicked)."""
    import dataclasses

    from box2d_tpu_torch import batch as bt
    from box2d_tpu_torch import scenes, world
    from box2d_tpu_torch.joints import joint_types_present
    from box2d_tpu_torch.narrowphase import classes_for_shape_types
    from box2d_tpu_torch.sensors import sensor_shape_ids
    from box2d_tpu_torch.state import state_from_numpy, state_to_numpy

    w = (scenes.pyramid(rows=size or 20, device="cuda")
         if scene == "pyramid"
         else scenes.joint_farm(ragdolls=size or 1, device="cuda"))
    state, cap = w.builder.build(device="cuda")
    classes = classes_for_shape_types(
        s["geom"].type for s in w.builder._shapes)
    if scene == "pyramid":
        cap = dataclasses.replace(cap, bp_repair_cap=0, batched=True)
        bstep = world.make_batched_step(cap, classes, 4, True)
        kick = 5
    else:
        bstep = world.make_batched_step(
            dataclasses.replace(cap, batched=True), classes, 4,
            w.builder.def_.enable_continuous,
            joint_types=joint_types_present(
                j["_type"] for j in w.builder._joints),
            sensor_ids=sensor_shape_ids(w.builder._shapes))
        kick = 1
    b = state_from_numpy(perturbed_leaves(
        state_to_numpy(state), n_w, seed=seed,
        kick=(n_w - 1, kick, (2.0, 1.0))), "cuda")
    for _ in range(WARM_STEPS):
        b = bstep(b, 1 / 60)
    return bt.batched_kernel_args(b, 1 / 60, bstep)


def worker(root):
    """Time one checkout's kernels; prints one JSON object of ms by case."""
    sys.path.insert(0, root)
    import torch

    from box2d_tpu_torch import contact_solver as cs
    from box2d_tpu_torch import particles_kernels as pk
    from box2d_tpu_torch import scenes, world

    assert os.path.dirname(os.path.abspath(cs.__file__)) == os.path.join(
        root, "box2d_tpu_torch"), cs.__file__
    cs.build()
    pk.build()
    out = {}
    for case in CASES[:3]:
        kind, size = case.split("-")
        w = (scenes.pyramid(rows=int(size), device="cuda") if kind == "pyramid"
             else scenes.joint_farm(int(size), device="cuda"))
        w.compile()
        w.run(WARM_STEPS)
        st = w._step
        args = world._step_work(w.state, 1 / 60, w.capacity, st.classes,
                                st.substeps, st.continuous, world.StepStats(),
                                until="layout", joint_types=st.joint_types)
        out[case] = median_ms(lambda: cs.contact_solve(*args))
    k3, (newkey, offs, rb), _ = record_particle_calls()
    for case, args in zip(CASES[3:6], k3):
        out[case] = median_ms(lambda: pk.window_pass(*args))
    out["K4"] = median_ms(lambda: pk.rank_pass(newkey, offs, rb))
    out[CASES[7]] = median_ms(lambda: library_rank(newkey))
    # Jacobi windows: pyramid-140 at spawn (two 2,560-lane windows, on the
    # cluster) and pyramid-20 with TAIL_BUCKETS buckets moved into its
    # tail (three 128-lane windows, on CTA 0), alone and in a batch
    args = _layout(scenes.pyramid(rows=140, device="cuda"), 0)
    out[CASES[8]] = median_ms(lambda: cs.contact_solve(*args))
    args = _layout(scenes.pyramid(rows=20, device="cuda"), WARM_STEPS)
    args = move_buckets_to_tail(args, range(TAIL_BUCKETS),
                                TAIL_BUCKETS * args[7])
    out[CASES[9]] = median_ms(lambda: cs.contact_solve(*args))
    if hasattr(cs, "contact_solve_batched"):
        bargs = _batch_args()
        out[CASES[10]] = median_ms(lambda: cs.contact_solve_batched(*bargs))
        tails = [move_buckets_to_tail(
            tuple(x[w] for x in bargs[:6]) + tuple(bargs[6:]) + (None,),
            range(TAIL_BUCKETS), TAIL_BUCKETS * bargs[7])
            for w in range(BATCH_WORLDS)]
        targs = tuple(torch.stack([t[i] for t in tails])
                      for i in range(6)) + bargs[6:11]
        out[CASES[11]] = median_ms(lambda: cs.contact_solve_batched(*targs))
        if "jrows" in inspect.signature(cs.contact_solve_batched).parameters:
            for case, n_w, scene, seed in BATCHED[1:]:
                jargs = _batch_args(n_w, scene, seed)
                out[case] = median_ms(
                    lambda: cs.contact_solve_batched(*jargs))
    print(json.dumps(out))


def _load_package(root, alias):
    """ROOT's box2d_tpu_torch package, imported as `alias`."""
    path = os.path.join(root, "box2d_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(alias + ".contact_solver")


def _sass_counts(lib_path):
    """SASS instructions of each kernel in a build, by mangled name."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        out[part.splitlines()[0].strip()] = sum(
            1 for line in part.splitlines()
            if line.strip().startswith("/*") and "*/" in line
            and line.strip()[2:6].isalnum()
            and len(line.split("*/", 1)[1].strip()) > 2)
    return out


def _sass_count(lib_path):
    """SASS instructions of the contact-only single-world solve_kernel in
    a build (solve_kernel<false>, or <false, false> since the batched
    instance)."""
    for name, count in _sass_counts(lib_path).items():
        if "solve_kernelILb0EE" in name or "solve_kernelILb0ELb0EE" in name:
            return count
    return None


def _k3_sass(lib_path):
    """SASS instructions of K3's single-world kernel, window_kernel<phase>,
    by phase."""
    return {name.split("window_kernel")[1][:6]: count
            for name, count in _sass_counts(lib_path).items()
            if "window_kernel" in name}


def _in_turns(names, calls):
    """Each call timed by median_ms, ROUNDS rounds in turns (in the order
    given, then backward, so that a drift of the card's clock over the
    run falls on every version alike). Returns {name: [ms, ...]}."""
    times = {name: [] for name in names}
    for k in range(ROUNDS):
        order = list(zip(names, calls))
        for name, call in order if k % 2 == 0 else order[::-1]:
            times[name].append(median_ms(call))
    return times


def one_process(roots):
    """Every ROOT's solver kernel on the same inputs, in one process."""
    import torch

    from box2d_tpu_torch import scenes, world

    solvers = [_load_package(r, f"b2t_version_{k}")
               for k, r in enumerate(roots)]
    windows = [importlib.import_module(f"b2t_version_{k}.particles_kernels")
               for k in range(len(roots))]
    with concurrent.futures.ThreadPoolExecutor(2 * len(roots)) as pool:
        libs = list(pool.map(lambda m: m.build(), solvers + windows))
    names = [os.path.relpath(r) for r in roots]
    for name, cs, lib, pk, plib in zip(names, solvers, libs, windows,
                                       libs[len(roots):]):
        regs = [line.strip() for line in lib.ptxas_log.splitlines()
                if "registers" in line][:1]
        print(f"[one_process] {name}: {cs.SOURCE}; SASS instructions of "
              f"solve_kernel<false>: {_sass_count(lib._name)}; {regs}; "
              f"{pk.SOURCE}: SASS instructions of window_kernel by phase "
              f"{_k3_sass(plib._name)}", flush=True)
    out = {}
    for case in CASES[:3]:
        kind, size = case.split("-")
        w = (scenes.pyramid(rows=int(size), device="cuda") if kind == "pyramid"
             else scenes.joint_farm(int(size), device="cuda"))
        w.compile()
        w.run(WARM_STEPS)
        st = w._step
        args = world._step_work(w.state, 1 / 60, w.capacity, st.classes,
                                st.substeps, st.continuous,
                                world.StepStats(), until="layout",
                                joint_types=st.joint_types)
        idx, l0 = args[1], args[8]
        tail = int((idx[0, l0:] >= 0).sum())
        assert tail == 0, f"{case}: {tail} live tail lanes"
        calls, results = [], []
        for cs in solvers:
            a = list(args[:10])
            if "tail_w" in inspect.signature(cs.contact_solve).parameters:
                a.append(args[10])
            a.append(args[11])
            calls.append(lambda cs=cs, a=a: cs.contact_solve(*a))
            results.append(calls[-1]())
        for r in results[1:]:
            # equal up to the rounding of the Jacobi windows' sums
            assert all(torch.allclose(x, y, rtol=0, atol=1e-5)
                       for x, y in zip(r, results[0]))
        out[case] = times = _in_turns(names, calls)
        for name in names:
            print(f"[one_process] {case} {name}: " + " ".join(
                f"{t:.4f}" for t in times[name]) + " ms", flush=True)
    for case, n_w, scene, seed in BATCHED:
        args = _batch_args(n_w, scene, seed)
        calls, results, which = [], [], []
        for name, cs in zip(names, solvers):
            if not hasattr(cs, "contact_solve_batched") or (
                    len(args) > 11 and "jrows" not in inspect.signature(
                        cs.contact_solve_batched).parameters):
                continue
            calls.append(lambda cs=cs: cs.contact_solve_batched(*args))
            results.append(calls[-1]())
            which.append(name)
        for r in results[1:]:
            # every version equals the single launches bit for bit
            assert all(torch.equal(x, y) for x, y in zip(r, results[0]))
        out[case] = times = _in_turns(which, calls)
        for name in which:
            print(f"[one_process] {case} {name}: " + " ".join(
                f"{t:.4f}" for t in times[name]) + " ms", flush=True)
    # K3: the single-world kernel at dam_break(100000), and K3 batched at
    # phase 6's batches, through each version's own wrapper
    k3, _, _ = record_particle_calls()
    cases = [(f"K3 {p}", "window_pass", a)
             for p, a in zip(("weight", "pressure", "damping"), k3)]
    for case, n_w, n in K3_BATCHED:
        cases += [(f"{case} {p}", "window_pass_batched", a)
                  for p, a in zip(("weight", "pressure", "damping"),
                                  batched_k3_calls(n, n_w))]
    for case, fn, args in cases:
        calls = [lambda pk=pk: getattr(pk, fn)(*args) for pk in windows]
        results = [c() for c in calls]
        for r in results[1:]:
            assert torch.equal(r, results[0]), f"{case}: versions differ"
        plans = [getattr(pk, "k3_batched_plan", None) for pk in windows]
        out[case] = _in_turns(names, calls)
        for name, plan in zip(names, plans):
            path = ("" if fn == "window_pass" else " (grid kernel)"
                    if plan is None else f" ({plan(args[1].shape[1]).path} "
                    f"kernel)")
            print(f"[one_process] {case} {name}{path}: " + " ".join(
                f"{t:.4f}" for t in out[case][name]) + " ms", flush=True)
    print(json.dumps({"timed_calls": TIMED_CALLS, "rounds": ROUNDS,
                      "ms": out}))


def paths():
    """--paths: the batched launch on both kernels at PATH_CASES."""
    import torch

    from box2d_tpu_torch import contact_solver as cs

    out = {}
    for scene, size in PATH_CASES:
        case = f"{PATH_WORLDS} x {scene}-{size}"
        args = _batch_args(PATH_WORLDS, scene, 7, size)
        plan = cs.plan_for(args)
        other = other_plan(plan, cs.GROUP_MAX)
        small, cluster = ((plan, other) if plan.path == "small"
                          else (other, plan))
        full = args[:11] + ((args[11] if len(args) > 11 else None),)
        calls = {k: (lambda p=p: cs._launch_batched(full, p))
                 for k, p in (("small", small), ("cluster", cluster))}
        a, b = calls["small"](), calls["cluster"]()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case
        times = {k: [] for k in calls}
        for k in range(ROUNDS):
            for name in (("small", "cluster") if k % 2 == 0
                         else ("cluster", "small")):
                times[name].append(median_ms(calls[name]))
        shape = cs.launch_shape(len(args) > 11, batched=True, plan=small)
        out[case] = dict(nb=plan.nb, bound=plan.bound, plan=plan.path,
                         smem_per_cta=shape["smem_per_cta"], **times)
        print(f"[paths] {case}: nb {plan.nb}, capacity bound {plan.bound} "
              f"lanes, plan {plan.path}; small-world kernel at "
              f"{small.threads_per_world} threads a world ("
              f"{shape['smem_per_cta']} bytes of shared memory a CTA) "
              + " ".join(f"{t:.4f}" for t in times["small"])
              + " ms; cluster kernel "
              + " ".join(f"{t:.4f}" for t in times["cluster"])
              + " ms; equal bit for bit", flush=True)
    print(json.dumps({"timed_calls": TIMED_CALLS, "rounds": ROUNDS,
                      "worlds": PATH_WORLDS, "ms": out}))


def k3_paths():
    """--k3-paths: K3 batched on both its kernels at K3_PATH_CASES."""
    import torch

    from box2d_tpu_torch import particles_kernels as pk

    out = {}
    for n_w, particles in K3_PATH_CASES:
        calls = batched_k3_calls(particles, n_w)
        n = calls[0][1].shape[1]
        case = f"{n_w} x dam_break({particles}) ({n} lanes)"
        small = pk.k3_batched_plan(n, "small")
        plans = {"small": small, "grid": pk.k3_batched_plan(n, "grid")}
        if n > 128:
            plans["small at 128 lanes a group"] = small._replace(
                lanes=128, groups_per_cta=1)
        out[case] = dict(lanes=n, plan=pk.k3_batched_plan(n).path)
        for args, pname in zip(calls, ("weight", "pressure", "damping")):
            runs = {k: (lambda p=p: pk.window_pass_batched(*args, plan=p))
                    for k, p in plans.items()}
            results = [r() for r in runs.values()]
            assert all(torch.equal(r, results[0]) for r in results[1:]), case
            times = _in_turns(list(runs), list(runs.values()))
            out[case][pname] = times
            print(f"[k3_paths] {case}, {pname}: plan "
                  f"{out[case]['plan']}; " + "; ".join(
                      f"{k} " + " ".join(f"{t:.4f}" for t in v) + " ms"
                      for k, v in times.items()) + "; equal bit for bit",
                  flush=True)
    print(json.dumps({"timed_calls": TIMED_CALLS, "rounds": ROUNDS,
                      "ms": out}))


def main():
    if len(sys.argv) > 1 and sys.argv[1] in ("--paths", "--k3-paths"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
        (paths if sys.argv[1] == "--paths" else k3_paths)()
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(os.path.abspath(sys.argv[2]))
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--one-process":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
        one_process([os.path.abspath(r) for r in sys.argv[2:]])
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
            f"{case} {ms[case]:.4f} ms" for case in CASES if case in ms),
            flush=True)
    print(json.dumps({"timed_calls": TIMED_CALLS, "runs": runs}))


if __name__ == "__main__":
    main()
