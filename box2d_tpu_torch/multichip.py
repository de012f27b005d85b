"""Batches of worlds sharded over a list of devices.

The counterpart of the JAX package's mesh-sharded batches
(__graft_entry__.dryrun_multichip, tests/test_multichip.py). Worlds are
independent, so a batch splits on its world axis into contiguous blocks,
one a device, and no shard ever reads another (`shard_batch`, the
counterpart of NamedSharding(mesh, P("worlds"))). A sharded step
(`make_sharded_step`) steps every shard once a call, each on a host
thread of its own that lives as long as the step, whose current device
is the shard's and whose current stream is a CUDA stream of its own
(none on the CPU): in PyTorch the current device and stream are per
thread, so the shards' host dispatch and device work overlap as far as
the GIL lets them. Two
layouts, as in the JAX package:

- "vmapped": each shard a batch of worlds, stepped by
  batch.make_batched_step (jax.vmap of the step under NamedSharding);
- "flat": each shard one world, often a flat batch (scenes.replicate),
  stepped by world.make_step (shard_map of the unbatched step, whose
  block of one world is squeezed).

A device list may name one device more than once, the counterpart of the
JAX package's virtual CPU devices: several shards then share one card
(each with its own thread and stream) or the CPU. Every world's bits
equal those of the unsharded batch: a shard's step is the batched step
of its worlds, and every batched launch equals its single launches bit
for bit.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from .state import WorldState, broadcast_state, map_state

LAYOUTS = ("vmapped", "flat")


def _devices(devices) -> list[torch.device]:
    """The devices as torch.device, each checked to exist (a CUDA index
    below torch.cuda.device_count()); raises otherwise."""
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("no devices given")
    for d in out:
        if d.type == "cuda":
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if (d.index or 0) >= have:
                raise RuntimeError(f"{d} does not exist: {have} CUDA "
                                   f"devices")
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
    return [torch.device("cuda", d.index or 0) if d.type == "cuda" else d
            for d in out]


def _n_worlds(batch: WorldState) -> int:
    return batch.bodies.center.shape[0]


def shard_batch(batch: WorldState, devices) -> list[WorldState]:
    """Split a batched WorldState (a leading world axis on every tensor,
    state.stack_states) into len(devices) contiguous blocks of worlds,
    block k copied to devices[k]. Raises when the worlds do not split
    evenly, as NamedSharding does."""
    devices = _devices(devices)
    n_w, n = _n_worlds(batch), len(devices)
    if n_w % n != 0:
        raise ValueError(f"shard_batch: {n_w} worlds do not split evenly "
                         f"over {n} devices")
    k = n_w // n
    return [map_state(lambda x, i=i, d=d: x[i * k:(i + 1) * k].to(
        d, copy=True), batch) for i, d in enumerate(devices)]


def gather_batch(shards, device) -> WorldState:
    """The shards' blocks concatenated on the world axis, in order, on
    `device`."""
    device = torch.device(device)
    return map_state(lambda *xs: torch.cat([x.to(device) for x in xs]),
                     *shards)


def _enter(device: torch.device, stream) -> None:
    """A CUDA shard thread's start: its current device and stream for the
    rest of its life (PyTorch keeps both per thread)."""
    torch.cuda.set_device(device)
    torch.cuda.set_stream(stream)


class ShardedStep:
    """Steps a list of shards, shard k on devices[k] with steps[k], each
    in its own persistent thread (module docstring). A call returns the
    list of stepped shards, each on its own device, once every shard has
    stepped; when a shard raises, every other shard still finishes that
    call's step and its output is dropped, and the first error (by shard)
    is raised in the caller, naming the shard. `steps[k].stats` are
    shard k's own (BatchStats or StepStats, their `launches` the kernel
    launches of shard k's thread). close() stops the threads (also on
    leaving a with block)."""

    def __init__(self, steps, devices, layout: str):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}: {LAYOUTS}")
        self.steps = list(steps)
        self.devices = _devices(devices)
        if len(self.steps) != len(self.devices):
            raise ValueError("one step function a device")
        self.layout = layout
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        # one thread a shard: a pool of one worker, its device and stream
        # entered once by the initializer
        self._pools = [ThreadPoolExecutor(
            1, thread_name_prefix=f"shard-{k}",
            **(dict(initializer=_enter, initargs=(d, s)) if s else {}))
            for k, (d, s) in enumerate(zip(self.devices, self.streams))]

    @property
    def stats(self) -> list:
        return [s.stats for s in self.steps]

    def __call__(self, shards, dt) -> list[WorldState]:
        if len(shards) != len(self.steps):
            raise ValueError(f"{len(shards)} shards for "
                             f"{len(self.steps)} devices")
        for k, (shard, d) in enumerate(zip(shards, self.devices)):
            if shard.bodies.center.device != d:
                raise ValueError(f"shard {k} is on "
                                 f"{shard.bodies.center.device}, not {d}")
            if self.layout == "flat" and _n_worlds(shard) != 1:
                raise ValueError(f"shard {k}: the flat layout steps one "
                                 f"world a shard, got a block of "
                                 f"{_n_worlds(shard)}")
        # each shard's stream first waits for the work the caller has
        # queued on that device (its blocks were made there)
        waits = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                 for d in self.devices]
        futures = [p.submit(self._one, k, s, dt, e)
                   for k, (p, s, e) in enumerate(zip(self._pools, shards,
                                                     waits))]
        out, errors = [], []
        for k, fut in enumerate(futures):
            e = fut.exception()
            if e is None:
                out.append(fut.result())
            else:
                errors.append((k, e))
        if errors:
            k, e = errors[0]
            e.add_note(f"in shard {k} of {len(futures)} on "
                       f"{self.devices[k]} ({len(errors)} shards failed)")
            raise e
        return out

    def _one(self, k: int, shard: WorldState, dt, wait) -> WorldState:
        """Shard k's step, on its own thread."""
        if wait is not None:
            torch.cuda.current_stream().wait_stream(wait)
        step = self.steps[k]
        if self.layout == "flat":
            out = map_state(lambda x: x[None],
                            step(map_state(lambda x: x[0], shard), dt))
        else:
            out = step(shard, dt)
        if wait is not None:
            # the outputs are whole when the caller gets them, whatever
            # stream it reads them on
            torch.cuda.current_stream().synchronize()
        return out

    def close(self):
        for p in self._pools:
            p.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_sharded_step(capacity, classes_present: frozenset, devices,
                      substeps: int = 4, continuous: bool = True,
                      layout: str = "vmapped", **kw) -> ShardedStep:
    """A ShardedStep over `devices` (a list that may repeat a device). In
    the "vmapped" layout each shard is a batch of worlds of this capacity
    and has its own batch.make_batched_step(capacity, classes_present,
    substeps, continuous, **kw) (joint_types, sensor_ids, custom_filter,
    pre_solve, particle_cfg; a hook is called from every shard's thread);
    in the "flat" layout each shard is a block of one world and has its
    own world.make_step(capacity, classes_present, substeps, continuous,
    **kw)."""
    from .batch import make_batched_step
    from .world import make_step

    make = make_step if layout == "flat" else make_batched_step
    devices = _devices(devices)
    return ShardedStep([make(capacity, classes_present, substeps, continuous,
                             **kw) for _ in devices], devices, layout)


def _build_world(base):
    """(state, capacity, pair classes) of a scene's World, built on its
    device."""
    from .narrowphase import classes_for_shape_types

    state, cap = base.builder.build(device=base.device)
    classes = classes_for_shape_types(
        s["geom"].type for s in base.builder._shapes)
    return state, cap, classes


def _check(out: WorldState, n: int, tag: str):
    if tuple(out.step_count.shape) != (n,):
        raise AssertionError(f"{tag}: step_count of shape "
                             f"{tuple(out.step_count.shape)}, not ({n},)")
    if not bool(torch.isfinite(out.bodies.center).all()):
        raise AssertionError(f"{tag}: a body centre is not finite")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Shard world batches over n_devices devices and run one full step,
    the two configurations of __graft_entry__.dryrun_multichip:

    1. vmapped: pyramid(rows=3) stacked n_devices times, one world a
       shard, stepped by the batched step;
    2. flat: each device holds one flat world (scenes.replicate of 8
       pyramid-20 copies) stepped by the single-world step.

    Each ends with the step_count shape and finite-centre checks and
    prints one line. devices: by default cuda:0 .. cuda:n_devices-1, and
    it raises when fewer CUDA devices exist; an explicit list of
    n_devices entries may repeat a device. There is no fallback to fewer
    devices or to the CPU."""
    from . import scenes

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA "
                               f"devices, have {have}")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = _devices(devices)
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip: {len(devices)} devices given "
                         f"for n_devices={n_devices}")
    home = devices[0]

    # -- 1. vmapped toy batch (one world a shard) --------------------------
    state, cap, classes = _build_world(scenes.pyramid(rows=3, device=home))
    shards = shard_batch(broadcast_state(state, n_devices), devices)
    with make_sharded_step(cap, classes, devices) as step:
        out = gather_batch(step(shards, 1.0 / 60.0), home)
    _check(out, n_devices, "dryrun_multichip vmapped")
    print(f"dryrun_multichip vmapped OK on {n_devices} devices; "
          f"center[0,0]={out.bodies.center[0, 0].tolist()}")

    # -- 2. flat batch per device (no collectives) -------------------------
    fstate, fcap, fclasses = _build_world(
        scenes.replicate(scenes.pyramid(rows=20, device=home), 8))
    shards = shard_batch(broadcast_state(fstate, n_devices), devices)
    with make_sharded_step(fcap, fclasses, devices, layout="flat") as step:
        out = gather_batch(step(shards, 1.0 / 60.0), home)
    _check(out, n_devices, "dryrun_multichip flat")
    print(f"dryrun_multichip flat OK: {n_devices} devices x (flat 8x "
          f"pyramid-20, {fcap.max_bodies} bodies each); "
          f"center[0,0]={out.bodies.center[0, 0].tolist()}")
