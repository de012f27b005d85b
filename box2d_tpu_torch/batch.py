"""Batched worlds: W independent worlds of one capacity, stepped together.

The counterpart of `jax.vmap` of the JAX package's `_step` over a batch of
states (box2d_tpu/bench.py `measure_batch`; the mode-1 Pallas kernel, whose
grid gains a batch axis). A batched WorldState has a leading world axis on
every tensor (state.broadcast_state, stack_states, unstack_state).

The step lays the worlds side by side on one lane axis (`_flatten`): world
w's bodies are lanes [w * Nb, (w + 1) * Nb), its shapes [w * S, ...), its
pair lanes [w * P, ...), and every body or shape id it holds is offset by
as much, so lane-wise phases (the AABBs, the narrow phase, the contact
preparation, the packers, the finalize) run unchanged on that flat state.
What couples the lanes of one world runs on (W, N) views along the last
axis, so that each world keeps its own order, capacity and counts: the
broadphase (broadphase.find_pairs_incremental_batched), the contact
store's remap, the coloring (coloring.repair_colors_batched,
dense_remap), the color-bucket layout, the event compactions and the
sleep pass (sleep.wake_and_sleep_batched). The solver is one launch for
every world (contact_solver.contact_solve_batched).

jax.vmap turns every `lax.cond` with a batched predicate into a select
and runs every `while_loop` until no world loops. The host branches here
do the same: a branch runs when any world takes it, on every world, and
each world keeps the output of its own branch; one device read decides
it, an any or a max over worlds. So a step makes at most the reads of the
worst world's single-world step. The rare branches loop over the worlds
that take them: the TOI sweep behind an open CCD gate calls the
single-world pass on each such world (BatchStats.ccd_world_calls).

Jointed worlds prepare their joints on the flat lanes, sort each world's
joint rows into its own joint region (joints.layout_joint_rows_batched)
and hand every region to the same launch (the solver's batched instance
with the joint sweep); their colors and impulses are written back and
their joint events compacted world by world. Sensor worlds run the sensor
pass with a world axis (sensors.sensor_pass, n_worlds). The custom filter
and pre-solve hooks see one world at a time, as under jax.vmap: each is
mapped over the world axis with torch.func.vmap, on a view of the batch
with a leading world axis and local ids (`_on_worlds`).

Particle worlds take the particle gate of the JAX step under vmap
(box2d_tpu/world.py:101-135, its lax.cond a select): the particles of
every world step first, in one particles.particle_step over the worlds
laid flat (`_flatten_particles`: world w's particle lanes [w * n, ...),
its pair, triad and group ids offset; K3 batched, one launch a phase for
every world); each world's bodies take their particle impulses; then the
rigid work runs, when any world is live, for every world, and a world
that is not live takes the skip branch's output (zero events, its
particle overflow in the profile, step_count + 1, the stepped particles).
One device read decides it. The rank repair K4 is never taken: the JAX
package keeps it off under vmap.
"""

from __future__ import annotations

import dataclasses

import torch

from . import math2d as m
from .broadphase import (_scatter_rows_batched, compute_shape_aabbs,
                         find_pairs_incremental_batched)
from .coloring import dense_remap, repair_colors_batched
from .contact_solver import (NA, NF, contact_solve_batched, kernel_mode,
                             tail_window)
from .continuous import _continuous_impl, gate_batched
from .counters import counting
from .joints import (layout_joint_rows_batched, prepare_joints,
                     solvable_joint_types, unpack_joint_acc)
from .narrowphase import narrow_phase, update_cache
from .particles import particle_step
from .sensors import sensor_pass
from .sleep import wake_and_sleep_batched
from .solver import (BodySolverState, finalize_bodies, pack_bodies,
                     pack_constraints_pairs, prepare_contacts, unpack_bodies)
from .state import (DYNAMIC, JOINT_FILTER, Capacity, Profile, WorldState,
                    auto_chunk, map_state, zero_profile)
from .world import (Hooks, StepStats, _contact_hit_events, _f32_scalars,
                    _joint_events, _store_joint_impulses,
                    _zero_events_batched, color_layout, overflow_relax)

# per-world fields of Bodies (0-d in a single world)
_BODY_SCALARS = ("island_dirty", "island_split_pending")
_BP_LANES = ("fat", "alive", "shape_a", "shape_b", "valid")
# the Particles fields that hold particle lanes (pairs and triads); the
# particle step writes none of them, nor `group`
_PARTICLE_IDS = ("pair_a", "pair_b", "triad_a", "triad_b", "triad_c")


class BatchStats(StepStats):
    """StepStats of a batched step, plus: `worlds` in the batch,
    `solver_launches` (kernel launches of contact_solve_batched, one a
    work step) and `ccd_world_calls` (single-world TOI sweeps run behind
    an open CCD gate, one for each world whose gate opened)."""

    def __init__(self):
        super().__init__()
        self.worlds = 0
        self.solver_launches = 0
        self.ccd_world_calls = 0


class BatchedStep:
    """The step of a batch of worlds of one static configuration: call it
    on a batched WorldState; world w of the result is what world.Step
    returns for world w. The overflow tail's windows are those of the
    vmapped JAX step: a contact-only world's are chunk-wide where the
    mode-1 kernel takes it, else one window (the XLA path); a jointed
    world's are those of the single-world Step (kernel_mode and
    tail_window of its joint types, the JAX World's path for it). With a
    particle_cfg, worlds with particles take the particle gate (module
    docstring); its rank_repair is ignored."""

    def __init__(self, capacity: Capacity, classes_present: frozenset,
                 substeps: int = 4, continuous: bool = True,
                 joint_types: frozenset = frozenset(),
                 sensor_ids: tuple = (), custom_filter=None,
                 pre_solve=None, particle_cfg=None):
        self.capacity = capacity
        self.classes = classes_present
        self.substeps = substeps
        self.continuous = continuous
        self.joint_types = frozenset(joint_types)
        self.sensor_ids = tuple(sensor_ids)
        self.particle_cfg = particle_cfg
        self.stats = BatchStats()
        if solvable_joint_types(self.joint_types):
            mode = kernel_mode(capacity, self.joint_types)
        else:
            mode = 1 if kernel_mode(capacity) == 1 else 0
        self.tail_w = tail_window(capacity, self.joint_types, mode)
        self.hooks = Hooks(custom_filter, pre_solve, self.tail_w)

    def __call__(self, batch: WorldState, dt) -> WorldState:
        with counting(self.stats.launches):
            return _batched_step(batch, dt, self, self.stats)


def make_batched_step(capacity: Capacity, classes_present: frozenset,
                      substeps: int = 4, continuous: bool = True,
                      joint_types: frozenset = frozenset(),
                      particle_cfg=None, sensor_ids: tuple = (),
                      custom_filter=None, pre_solve=None) -> BatchedStep:
    """The batched counterpart of world.make_step (jax.vmap of the JAX
    step), with the same arguments; custom_filter and pre_solve see one
    world and its local shape ids at a time (world.Hooks). With a
    particle_cfg, particle worlds step their particles first (the
    particle gate); its rank_repair is ignored, as under jax.vmap."""
    return BatchedStep(capacity, classes_present, substeps, continuous,
                       joint_types, sensor_ids, custom_filter, pre_solve,
                       particle_cfg)


def _on_worlds(hook, name: str, view: WorldState, *args):
    """hook(state, *args) of each world, mapped over the world axis with
    torch.func.vmap (PyTorch's counterpart of jax.vmap): `view` is the
    batch with a leading world axis on every tensor and local ids, args
    are (W, ...) tensors; the hook sees one world's state and its slices
    of args. Returns its (W, ...) output as bool. The RuntimeError that
    vmap raises for a hook it cannot map (a host read, a data-dependent
    Python branch) is raised again naming the hook; any other error of
    the hook passes through as it is."""
    leaves = []
    map_state(lambda x: leaves.append(x) or x, view)

    def one(world_leaves, *a):
        it = iter(world_leaves)
        return hook(map_state(lambda _: next(it), view), *a)

    try:
        out = torch.func.vmap(one)(leaves, *args)
    except RuntimeError as e:
        raise RuntimeError(
            f"make_batched_step: the {name} hook failed under "
            f"torch.func.vmap over the world axis (a hook that reads the "
            f"host or branches on a tensor cannot be mapped): {e}") from e
    return out.to(torch.bool)


# ---------------------------------------------------------------------------
# the flat layout
# ---------------------------------------------------------------------------

def _offsets(n_w, n, dev, shape):
    """(W, n) lane offsets w * n, shaped to broadcast against `shape`."""
    off = torch.arange(n_w, device=dev) * n
    return off.reshape((n_w,) + (1,) * (len(shape) - 1))


def _shift(x, step: int, sign: int = 1, keep_negative: bool = True):
    """Add (sign) w * step to world w's ids of x (W, ...); ids below 0 stay
    as they are when keep_negative."""
    off = _offsets(x.shape[0], step, x.device, x.shape).to(x.dtype) * sign
    if keep_negative:
        return torch.where(x >= 0, x + off, x)
    return x + off


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _flatten(batch: WorldState) -> WorldState:
    """The batch as one flat state (module docstring): lane fields of
    bodies, shapes, contacts, joints and the broadphase flattened, their
    body and shape ids offset; per-world fields keep their world axis."""
    b, sh, c, j, bp = (batch.bodies, batch.shapes, batch.contacts,
                       batch.joints, batch.broadphase)
    nb = b.center.shape[1]
    S = sh.body.shape[1]
    bodies = dataclasses.replace(b, **{
        f.name: (getattr(b, f.name) if f.name in _BODY_SCALARS
                 else _flat(getattr(b, f.name)))
        for f in dataclasses.fields(b)})
    bodies = dataclasses.replace(
        bodies, island_label=_flat(_shift(b.island_label, nb)),
        island_fresh=_flat(_shift(b.island_fresh, nb)))
    shapes = map_state(_flat, sh)
    shapes = dataclasses.replace(shapes, body=_flat(_shift(sh.body, nb)))
    if sh.table is not None:
        # the packed table's last column is the body id
        tbl = sh.table.clone()
        tbl[..., -1] = _shift(sh.table[..., -1], nb)
        shapes = dataclasses.replace(shapes, table=_flat(tbl))
    contacts = map_state(_flat, c)
    contacts = dataclasses.replace(
        contacts, key_a=_flat(_shift(c.key_a, S)),
        key_b=_flat(_shift(c.key_b, S)))
    joints = map_state(_flat, j)
    joints = dataclasses.replace(joints, body_a=_flat(_shift(j.body_a, nb)),
                                 body_b=_flat(_shift(j.body_b, nb)))
    bpf = dataclasses.replace(bp, **{k: _flat(getattr(bp, k))
                                     for k in _BP_LANES})
    bpf = dataclasses.replace(
        bpf, shape_a=_flat(_shift(bp.shape_a, S, keep_negative=False)),
        shape_b=_flat(_shift(bp.shape_b, S, keep_negative=False)))
    return dataclasses.replace(batch, bodies=bodies, shapes=shapes,
                               contacts=contacts, joints=joints,
                               broadphase=bpf)


def _flatten_particles(pt):
    """A batch's Particles (every field with a leading world axis) laid
    flat, world-major: world w's particle lanes [w * n, (w + 1) * n), its
    pair, triad and group ids offset to them; ParticleParams keep their
    world axis, one value a world (particles.particle_step, n_worlds)."""
    n = pt.pos.shape[1]
    ng = pt.group_flags.shape[1]
    kw = {f.name: _flat(getattr(pt, f.name))
          for f in dataclasses.fields(pt) if f.name != "params"}
    for k in _PARTICLE_IDS:
        kw[k] = _flat(_shift(getattr(pt, k), n))
    kw["group"] = _flat(_shift(pt.group, ng))
    return dataclasses.replace(pt, **kw)


def _unflatten_particles(flat, batch_pt):
    """The particle step's flat output back on the world axis: the ids and
    parameters (which the step does not write) are the batch's own."""
    n_w = batch_pt.pos.shape[0]
    keep = set(_PARTICLE_IDS) | {"group", "params"}
    return dataclasses.replace(flat, **{
        f.name: (getattr(batch_pt, f.name) if f.name in keep
                 else _unflat(getattr(flat, f.name), n_w))
        for f in dataclasses.fields(flat)})


def _unflat(x, n_w):
    return x.reshape((n_w, -1) + tuple(x.shape[1:]))


def _unflatten(flat: WorldState, batch: WorldState) -> WorldState:
    """The flat state's bodies, contacts, joints and broadphase back on the
    world axis, ids local again; shapes (which the step does not write)
    are the batch's own."""
    n_w = batch.bodies.center.shape[0]
    nb = batch.bodies.center.shape[1]
    S = batch.shapes.body.shape[1]
    b, c, bp = flat.bodies, flat.contacts, flat.broadphase
    bodies = dataclasses.replace(b, **{
        f.name: (getattr(b, f.name) if f.name in _BODY_SCALARS
                 else _unflat(getattr(b, f.name), n_w))
        for f in dataclasses.fields(b)})
    bodies = dataclasses.replace(
        bodies, island_label=_shift(bodies.island_label, nb, -1),
        island_fresh=_shift(bodies.island_fresh, nb, -1))
    contacts = map_state(lambda x: _unflat(x, n_w), c)
    contacts = dataclasses.replace(
        contacts, key_a=_shift(contacts.key_a, S, -1),
        key_b=_shift(contacts.key_b, S, -1))
    bpu = dataclasses.replace(bp, **{k: _unflat(getattr(bp, k), n_w)
                                     for k in _BP_LANES})
    bpu = dataclasses.replace(
        bpu, shape_a=_shift(bpu.shape_a, S, -1, keep_negative=False),
        shape_b=_shift(bpu.shape_b, S, -1, keep_negative=False))
    joints = map_state(lambda x: _unflat(x, n_w), flat.joints)
    joints = dataclasses.replace(
        joints, body_a=_shift(joints.body_a, nb, -1),
        body_b=_shift(joints.body_b, nb, -1))
    return dataclasses.replace(flat, bodies=bodies, shapes=batch.shapes,
                               contacts=contacts, joints=joints,
                               broadphase=bpu)


def _world_view(flat: WorldState, w: int, n_w: int) -> WorldState:
    """World w of the flat state as a single-world state (its bodies,
    shapes and tuning, ids local), for the single-world passes that a rare
    branch runs world by world."""
    b, sh = flat.bodies, flat.shapes
    nb = b.center.shape[0] // n_w
    S = sh.body.shape[0] // n_w
    rows = lambda x, n: x[w * n:(w + 1) * n]  # noqa: E731
    bodies = dataclasses.replace(b, **{
        f.name: (getattr(b, f.name)[w] if f.name in _BODY_SCALARS
                 else rows(getattr(b, f.name), nb))
        for f in dataclasses.fields(b)})
    bodies = dataclasses.replace(bodies,
                                 island_label=bodies.island_label - w * nb,
                                 island_fresh=bodies.island_fresh - w * nb)
    shapes = map_state(lambda x: rows(x, S), sh)
    shapes = dataclasses.replace(shapes, body=shapes.body - w * nb)
    if shapes.table is not None:
        tbl = shapes.table.clone()
        tbl[:, -1] -= w * nb
        shapes = dataclasses.replace(shapes, table=tbl)
    return dataclasses.replace(
        flat, bodies=bodies, shapes=shapes,
        tuning=map_state(lambda x: x[w], flat.tuning))


def _tuning_per_lane(tuning, reps: int):
    """The worlds' tuning with each field repeated for the reps lanes of its
    world: (W * reps, ...)."""
    return map_state(lambda x: x.repeat_interleave(reps, dim=0), tuning)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _batched_step(batch: WorldState, dt, step: BatchedStep,
                  stats: BatchStats) -> WorldState:
    if (step.particle_cfg is not None and batch.particles is not None
            and batch.broadphase is not None):
        return _particle_gate(batch, dt, step, stats)
    n_w = batch.bodies.center.shape[0]
    b0 = batch.bodies
    cap = step.capacity
    # the idle gate of each world (box2d_tpu/world.py:137-159)
    work = batch.broadphase.dirty | (
        b0.awake & (b0.type != 0) & b0.enabled).any(dim=1)
    (n_work,) = stats.read(work.sum())
    stats.steps += 1
    stats.worlds = n_w
    if n_work == 0:
        stats.idle_steps += 1
        return _idle_output(batch, cap)
    out = _unflatten(_batched_work(_flatten(batch), dt, step, stats, batch),
                     batch)
    if n_work < n_w:
        # an idle world takes the idle branch's output, not the work's;
        # what neither branch wrote (the shapes) is the batch's own
        keep = lambda i, o: o if o is i else torch.where(  # noqa: E731
            work.reshape((n_w,) + (1,) * (o.dim() - 1)), o, i)
        out = map_state(keep, _idle_output(batch, cap), out)
    return out


def _particle_gate(batch: WorldState, dt, step: BatchedStep,
                   stats: BatchStats) -> WorldState:
    """world._particle_gate of every world (box2d_tpu/world.py:101-135
    under jax.vmap): the particles of all worlds step first; each world's
    bodies take their impulses (poked bodies wake); the rigid work runs
    for every world when any world is live (one read), and a world that is
    not takes the skip branch's output. There is no whole-batch idle gate:
    particles always step."""
    n_w, nb = batch.bodies.center.shape[:2]
    cap = step.capacity
    flat = _flatten(batch)
    new_pt, body_dv, body_dw, pov = particle_step(
        _flatten_particles(batch.particles), flat, dt, step.particle_cfg,
        stats, n_worlds=n_w)
    particles = _unflatten_particles(new_pt, batch.particles)
    # particle impulses wake the bodies they touch
    # (ref: particle/World.cs:47-61 ApplyLinearImpulse -> WakeBody)
    poked = ((m.dot(body_dv, body_dv) + body_dw * body_dw) > 1e-12).reshape(
        n_w, nb)
    b0 = batch.bodies
    b1 = dataclasses.replace(
        b0, v=b0.v + body_dv.reshape(n_w, nb, 2),
        w=b0.w + body_dw.reshape(n_w, nb),
        awake=b0.awake | (poked & (b0.type == DYNAMIC)),
        sleep_time=torch.where(poked, 0.0, b0.sleep_time))
    batch = dataclasses.replace(batch, bodies=b1, particles=particles)
    live = batch.broadphase.dirty | (
        b1.awake & (b1.type != 0) & b1.enabled).any(dim=1)
    (n_live,) = stats.read(live.sum())
    stats.steps += 1
    stats.worlds = n_w
    skip = _idle_output(batch, cap, pov)
    if n_live == 0:
        stats.idle_steps += 1
        return skip
    flat = dataclasses.replace(flat, particles=particles, bodies=dataclasses
                               .replace(flat.bodies, **{
                                   k: _flat(getattr(b1, k)) for k in
                                   ("v", "w", "awake", "sleep_time")}))
    out = _unflatten(_batched_work(flat, dt, step, stats, batch,
                                   particle_overflow=pov), batch)
    if n_live < n_w:
        keep = lambda i, o: o if o is i else torch.where(  # noqa: E731
            live.reshape((n_w,) + (1,) * (o.dim() - 1)), o, i)
        out = map_state(keep, skip, out)
    return out


def _idle_output(batch: WorldState, cap: Capacity,
                 particle_overflow=None) -> WorldState:
    """What the idle branch leaves (box2d_tpu/world.py:137-159): zeroed
    events and profile, step_count + 1, the rest as it was; with the
    worlds' particle_overflow (W,), the particle gate's skip branch
    (:123-127), which keeps it in the profile."""
    n_w, nb = batch.bodies.center.shape[:2]
    dev = batch.bodies.center.device
    profile = map_state(lambda x: x.expand(n_w).clone(), zero_profile(dev))
    if particle_overflow is not None:
        profile = dataclasses.replace(profile,
                                      overflow_particles=particle_overflow)
    return dataclasses.replace(
        batch, events=_zero_events_batched(cap, dev, n_w, nb),
        profile=profile, step_count=batch.step_count + 1)


def batched_kernel_args(batch: WorldState, dt, step: BatchedStep):
    """The arguments that `step` hands contact_solve_batched for this
    batch, without launching it (for checks of the kernel against single
    launches and its twin): eleven, and a twelfth, the worlds' joint
    regions, for a step with solvable joint types."""
    return _batched_work(_flatten(batch), dt, step, BatchStats(), batch,
                         until="layout")


def _batched_work(state: WorldState, dt, step: BatchedStep,
                  stats: BatchStats, batch: WorldState,
                  until: str = "", particle_overflow=None) -> WorldState:
    """world._step_work of every world, on the flat state; `batch` is the
    step's input (the hooks' view of the worlds); until="layout" returns
    the solver's arguments instead. particle_overflow: the worlds'
    particle overflow (W,), kept in the profile."""
    cap, substeps, hooks = step.capacity, step.substeps, step.hooks
    n_w = batch.bodies.center.shape[0]
    dt, inv_dt, h, inv_h = _f32_scalars(dt, substeps)
    b = state.bodies
    NB = b.center.shape[0]
    nb = NB // n_w
    S = state.shapes.body.shape[0] // n_w
    P = cap.max_contact_pairs
    dev = b.center.device
    tn = state.tuning
    tn_b = _tuning_per_lane(tn, nb)
    tn_p = _tuning_per_lane(tn, P)
    # the pre-step poses, for the sensors' swept test
    prev_pose = (b.origin, b.rot)
    soff = (torch.arange(n_w, device=dev) * S)[:, None]

    pair_filter = None
    if hooks.custom_filter is not None:
        # the hook sees each world's state at the step's start
        pair_filter = lambda a, b_: _on_worlds(  # noqa: E731
            hooks.custom_filter, "custom_filter", batch, a, b_)
    old_key_a = state.contacts.key_a
    old_key_b = state.contacts.key_b
    aabbs = compute_shape_aabbs(state, cap.max_verts)
    pairs, new_bp, cache, orphan_mask, store_drops, rebuild_kind = \
        find_pairs_incremental_batched(state, cap, aabbs, n_w, stats,
                                       pair_filter)
    state = dataclasses.replace(state, broadphase=new_bp, contacts=cache)
    data = narrow_phase(state, pairs, step.classes, cap.max_verts, stats)
    if hooks.pre_solve is not None:
        # a dropped lane's manifold is zeroed: not solved, not touching, no
        # begin event (box2d_tpu/world.py:212-219), world by world
        rw = lambda x: x.reshape((n_w, P) + tuple(x.shape[1:]))  # noqa
        keep = _on_worlds(
            hooks.pre_solve, "pre_solve", _unflatten(state, batch),
            rw(data.shape_a) - soff.to(data.shape_a.dtype),
            rw(data.shape_b) - soff.to(data.shape_b.dtype),
            type(data.manifold)(*(rw(x) for x in data.manifold)))
        data = data._replace(manifold=data.manifold._replace(
            point_count=torch.where(keep.reshape(-1),
                                    data.manifold.point_count, 0)))
    touching = data.manifold.point_count > 0

    # --- constraint graph coloring (contacts, then joint lanes) ----------
    awake_dyn = b.awake & (b.type == DYNAMIC)
    jn = state.joints
    J = jn.type.shape[0] // n_w
    joint_active = (jn.enabled & (jn.type >= 0) & (jn.type != JOINT_FILTER)
                    & (awake_dyn[torch.clamp(jn.body_a, min=0).long()]
                       | awake_dyn[torch.clamp(jn.body_b, min=0).long()]))
    ad_a = (data.dyn_a[:, 12] > 0) & (data.dyn_a[:, 11] == 2)
    ad_b = (data.dyn_b[:, 12] > 0) & (data.dyn_b[:, 11] == 2)
    contact_live = touching & (ad_a | ad_b)
    per_world = lambda c, j: torch.cat(  # noqa: E731
        [c.reshape(n_w, P), j.reshape(n_w, J)], dim=1)
    all_ba = per_world(data.body_a, jn.body_a)
    all_bb = per_world(data.body_b, jn.body_b)
    all_active = per_world(contact_live, joint_active)
    all_prev = per_world(torch.where(touching, data.prev_color, -1),
                         jn.color)
    all_reserved = per_world(touching, jn.enabled & (jn.type >= 0))
    chunk = cap.color_chunk or auto_chunk(cap.max_contact_pairs)
    n_all = P + J
    raw_colors = repair_colors_batched(
        all_ba, all_bb, all_active, all_reserved, all_prev, b.type, nb,
        stats, cap.max_colors, color_cap=chunk,
        repair_cap=min(max(512, cap.max_contact_pairs // 4), n_all, 1 << 16))
    ovf = all_active & (raw_colors < 0)
    overflow_colors = ovf.sum(dim=1).to(torch.int32)
    colors = dense_remap(
        torch.where(all_active,
                    torch.where(ovf, cap.max_colors - 1, raw_colors), -1),
        all_active, cap.max_colors)
    contact_color = torch.where(contact_live.reshape(n_w, P),
                                colors[:, :P], -1).reshape(-1)
    joint_color = torch.where(joint_active, colors[:, P:].reshape(-1), -1)
    num_colors = torch.clamp(
        torch.where(all_active, colors, -1).max(dim=1).values + 1, min=0)
    contact_color_store = raw_colors[:, :P].reshape(-1)
    state = dataclasses.replace(state, joints=dataclasses.replace(
        jn, color=torch.where(joint_active, raw_colors[:, P:].reshape(-1),
                              jn.color)))

    # the overflow color's mass splitting over the flat bodies, so a world
    # without overflow keeps 1.0
    (n_ovf,) = stats.read(overflow_colors.sum())
    relax = (overflow_relax(ovf, all_ba, all_bb, NB) if n_ovf > 0 else
             torch.ones((n_w, n_all), dtype=torch.float32, device=dev))
    contact_relax = relax[:, :P].reshape(-1)

    bs = BodySolverState(v=b.v, w=b.w, dp=torch.zeros_like(b.center),
                         dq=m.rot_identity((NB,), device=dev))
    cc = prepare_contacts(dataclasses.replace(state, tuning=tn_p), data,
                          contact_color, h, inv_h)
    # a world without solvable joints prepares none and emits no joint event
    with_joints = bool(solvable_joint_types(step.joint_types))
    jc = (prepare_joints(dataclasses.replace(
        state, tuning=_tuning_per_lane(tn, J)), joint_color, h, inv_h)
        if with_joints else None)

    # --- color-bucket layout of each world -------------------------------
    layout_idx, l0, layout_len = color_layout(
        cc.color.reshape(n_w, P), num_colors, overflow_colors,
        cap.max_colors, chunk)
    gidx = torch.clamp(layout_idx, 0, layout_len - 1)
    active_lane = (layout_idx < layout_len).reshape(-1)

    data_p, acc_p, idx_p = pack_constraints_pairs(cc, contact_relax)
    # the kernel takes each world's own body lanes
    idx_p = _shift(idx_p.reshape(n_w, P, 2), nb, -1)
    rowsL = _scatter_rows_batched(
        layout_len, 0.0, layout_idx,
        torch.cat([data_p, acc_p], dim=1).reshape(n_w, P, NF + NA))
    idxL = _scatter_rows_batched(layout_len, -1, layout_idx, idx_p)
    f32 = lambda x: torch.full((n_w,), x, dtype=torch.float32,  # noqa: E731
                               device=dev)
    zero = f32(0.0)
    scalars = torch.stack([
        f32(h), f32(inv_h), tn.contact_speed, tn.restitution_threshold,
        tn.max_linear_speed, zero, zero, zero], dim=1)[:, None, :]
    bodyp, paramsp = pack_bodies(b, bs, tn_b, h, inv_dt)
    to_w = lambda x: x.reshape(x.shape[0], n_w, nb).transpose(  # noqa: E731
        0, 1).contiguous()
    # each world's joint region: its live joints' rows sorted by (color,
    # type), one segment per color (joints.layout_joint_rows_batched)
    jrows = jpos = None
    if with_joints:
        jrows, jpos = layout_joint_rows_batched(
            state.joints, jc, cap.max_colors, n_w, nb, overflow_colors > 0)
    kernel_args = (scalars.contiguous(), idxL.transpose(1, 2).contiguous(),
                   rowsL[..., :NF].transpose(1, 2).contiguous(),
                   rowsL[..., NF:NF + NA].transpose(1, 2).contiguous(),
                   to_w(bodyp), to_w(paramsp), substeps, chunk, l0,
                   cap.max_colors, step.tail_w) + (
                       (jrows,) if with_joints else ())
    if until == "layout":
        return kernel_args
    out = contact_solve_batched(*kernel_args)
    if dev.type == "cuda":
        stats.solver_launches += 1
    out_body, out_acc = out[0], out[1]
    if with_joints:
        jacc = out[2].transpose(1, 2).reshape(n_w * J, -1)[jpos]
        jc = unpack_joint_acc(jc, jacc, joint_color >= 0)
    bs = unpack_bodies(bs, out_body.transpose(0, 1).reshape(8, NB))
    pair_acc = torch.gather(
        out_acc.transpose(1, 2), 1,
        gidx[..., None].expand(n_w, P, NA)).reshape(n_w * P, NA)
    act = active_lane[:, None]
    data = data._replace(
        normal_impulse=torch.where(act, pair_acc[:, 0:2],
                                   data.normal_impulse),
        tangent_impulse=torch.where(act, pair_acc[:, 2:4],
                                    data.tangent_impulse),
        rolling_impulse=torch.where(active_lane, pair_acc[:, 6],
                                    data.rolling_impulse))
    tni = torch.where(act, pair_acc[:, 4:6], 0.0)

    # --- the tail (world.py:706-805) -------------------------------------
    state = dataclasses.replace(
        state, contacts=update_cache(data, contact_color_store),
        joints=_store_joint_impulses(state.joints, jc))
    events, ev_drop = _contact_hit_events(
        state, data, touching, cc.relative_velocity, tni, cap,
        tn_p.hit_event_threshold[:, None], (orphan_mask, old_key_a,
                                            old_key_b), n_w, stats)
    if with_joints:
        events, d_joint = _joint_events(state, jc, inv_h, events, cap,
                                        n_w)
        ev_drop = ev_drop + d_joint

    advance = None
    overflow_ccd = torch.zeros(n_w, dtype=torch.int32, device=dev)
    if step.continuous:
        advance, overflow_ccd = _continuous_batched(
            state, bs, dt, cap, tn_b, n_w, stats)
    state = finalize_bodies(dataclasses.replace(state, tuning=tn_b), bs, dt,
                            inv_dt, advance)
    state = dataclasses.replace(state, tuning=tn)

    awake_fin = state.bodies.awake
    new_touch = touching & ~data.was_touching
    lost_touch = (data.was_touching & ~touching) | orphan_mask
    state = wake_and_sleep_batched(state, touching, new_touch, data.body_a,
                                   data.body_b, dt, data.dyn_a, data.dyn_b,
                                   lost_touch, n_w, tn_b.enable_sleep, stats)
    bnew = state.bodies
    moved = (awake_fin & (bnew.type != 0) & bnew.enabled).reshape(n_w, nb)
    fell = moved & ~bnew.awake.reshape(n_w, nb)
    events = dataclasses.replace(
        events, body_moved=moved, body_fell_asleep=fell,
        body_move_count=moved.sum(dim=1).to(torch.int32),
        body_fell_asleep_count=fell.sum(dim=1).to(torch.int32))
    # the sensors, after the solve (ref: api/World.cs:99 OverlapSensors)
    if step.sensor_ids:
        sens, store = sensor_pass(state, cap, step.sensor_ids, *prev_pose,
                                  n_w, stats=stats)
        events = dataclasses.replace(events, **sens)
        state = dataclasses.replace(state, sensor_overlap=store)
    zero_w = torch.zeros(n_w, dtype=torch.int32, device=dev)
    profile = Profile(
        pair_count=pairs.count,
        contact_point_count=data.manifold.point_count.reshape(
            n_w, P).sum(dim=1).to(torch.int32),
        color_count=num_colors.to(torch.int32),
        overflow_pairs=pairs.overflow,
        overflow_colors=overflow_colors,
        store_drops=store_drops,
        overflow_ccd=overflow_ccd,
        overflow_particles=(zero_w if particle_overflow is None
                            else particle_overflow),
        events_dropped=ev_drop,
        pair_rebuild=rebuild_kind,
    )
    return dataclasses.replace(state, events=events, profile=profile,
                               step_count=state.step_count + 1)


def _continuous_batched(state, bs, dt, cap, tn_b, n_w, stats):
    """The CCD gate of every world (one read); behind it, the single-world
    TOI sweep of each world whose gate opened (continuous._continuous_impl
    on that world's rows), its results written back."""
    NB = state.bodies.center.shape[0]
    nb = NB // n_w
    S = state.shapes.body.shape[0] // n_w
    dev = state.bodies.center.device
    mask, bullet_body, max_velocity = gate_batched(state, bs, dt, n_w,
                                                   tn_b.enable_continuous)
    stats.syncs += 1
    gates = mask.reshape(n_w, S).any(dim=1).tolist()
    advance = torch.ones(NB, dtype=torch.float32, device=dev)
    overflow = torch.zeros(n_w, dtype=torch.int32, device=dev)
    if not any(gates):
        return advance, overflow
    b = state.bodies
    c2 = b.center + bs.dp
    q2 = m.rot_normalize(m.rot_mul(bs.dq, b.rot))
    for w in [k for k, g in enumerate(gates) if g]:
        stats.ccd_gate_openings += 1
        stats.ccd_world_calls += 1
        rb = slice(w * nb, (w + 1) * nb)
        bs_w = BodySolverState(*(x[rb] for x in bs))
        adv_w, ovf_w = _continuous_impl(
            _world_view(state, w, n_w), bs_w, dt, cap.fast_cap or 32,
            cap.cand_cap, mask[w * S:(w + 1) * S], bullet_body[rb], c2[rb],
            q2[rb], max_velocity[rb], stats)
        advance[rb] = adv_w
        overflow[w] = ovf_w
    return advance, overflow
