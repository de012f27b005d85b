"""Sensor overlap pass: begin and end events from a persistent visitor-set
diff.

Torch port of box2d_tpu/sensors.py (ref: src/Sensor.cs:22-236): after the
solve, each sensor shape tests every shape for overlap (GJK distance with
radii under 10 * FLT_EPSILON; the visitor must enable sensor events, sit
on another body and pass the filter), and the sorted visitor keys are
diffed against the previous step's to give begin and end events. A
visitor that moved more than a quarter of its body's smallest extent is
also shape-cast from its pre-step pose, so a fast body that crosses a
sensor within one step still registers (ref: src/Solver.cs:1275-1292).
The sensor list is fixed when the world is built; a world without sensors
never runs the pass.
"""

from __future__ import annotations

import torch

from . import math2d as m
from .broadphase import _group_pass
from .constants import FLT_EPSILON
from .distance import shape_cast_pair, shape_distance
from .state import Capacity, WorldState

_NONE = (1 << 31) - 1   # int32 max: the empty key


def sensor_shape_ids(shapes_host) -> tuple:
    """Host side: the sensor shape indices, in shape order."""
    return tuple(i for i, s in enumerate(shapes_host) if s["is_sensor"])


def sensor_pass(state: WorldState, cap: Capacity, sensor_ids: tuple,
                prev_origin, prev_rot, n_w: int, stats=None):
    """The sensor begin / end events and the new overlap store
    (box2d_tpu/sensors.py:31-130) of each of the n_w worlds of a flat
    state (batch.py; one world: the state itself), sensor_ids being each
    world's local ids: each sensor tests only the shapes of its own world,
    the (W, n_sensors, S) lanes of the vmapped pass
    (box2d_tpu/world.py:783-785 under jax.vmap), and each world's keys,
    diff and events are its own. prev_origin / prev_rot: the bodies'
    pre-step poses, for the swept test. stats (world.StepStats) counts
    the device reads of the GJK and cast loops. Returns (the Events
    fields sensor_begin, sensor_begin_count, sensor_end and
    sensor_end_count as a dict, the new store (W, sensor_pair_capacity)),
    each with a leading world axis."""
    sh = state.shapes
    b = state.bodies
    dev = b.center.device
    S = sh.type.shape[0] // n_w
    ns = len(sensor_ids)
    sid = torch.tensor(sensor_ids, dtype=torch.int64, device=dev)
    body = sh.body.long()
    p = b.origin[body]
    q = b.rot[body]

    # (W, n_sensors, S) lanes: sensor s as proxy A, visitor v as proxy B,
    # each of its own world
    lane_s = torch.arange(S, device=dev)
    woff = (torch.arange(n_w, device=dev) * S)[:, None, None]
    s_l = (woff + sid[None, :, None]).expand(n_w, ns, S).reshape(-1)
    v_l = (woff + lane_s[None, None, :]).expand(n_w, ns, S).reshape(-1)
    eligible = (sh.enable_sensor_events[v_l]
                & (body[v_l] != body[s_l])
                & _group_pass(sh, s_l, v_l)
                & (sh.enabled & b.enabled[body])[v_l]
                & sh.enable_sensor_events[s_l])
    proxy_a = (sh.verts[s_l], sh.count[s_l], sh.radius[s_l])
    proxy_b = (sh.verts[v_l], sh.count[v_l], sh.radius[v_l])
    d = shape_distance(*proxy_a, *proxy_b, p[s_l], q[s_l], p[v_l], q[v_l],
                       use_radii=True, active=eligible, stats=stats)
    pv = prev_origin[body]
    qv = prev_rot[body]
    # the swept test counts only for visitors that moved a meaningful
    # distance this step; the distance test covers the others
    moved = (m.length(p - pv) > 0.25 * b.min_extent[body])[v_l]
    cast = shape_cast_pair(*proxy_a, *proxy_b, p[s_l], q[s_l], pv[v_l],
                           qv[v_l], p[v_l] - pv[v_l], 1.0,
                           active=eligible & moved, stats=stats)
    overlap = ((d.distance < 10.0 * FLT_EPSILON) | (cast.hit & moved)) \
        & eligible

    # keys = sensor shape * S + visitor (local ids), sorted, cut to the
    # capacity, world by world
    local = (sid[:, None] * S + lane_s[None, :]).reshape(1, ns * S)
    keys = torch.sort(torch.where(overlap.reshape(n_w, ns * S), local,
                                  _NONE), dim=1).values
    kcap = cap.sensor_pair_capacity
    if keys.shape[1] >= kcap:
        keys = keys[:, :kcap]        # an overflow drops the largest keys
    else:
        keys = torch.cat([keys, torch.full(
            (n_w, kcap - keys.shape[1]), _NONE, dtype=keys.dtype,
            device=dev)], dim=1)
    old = state.sensor_overlap.long().reshape(n_w, kcap)
    old_sorted = torch.sort(torch.where(old < 0, _NONE, old), dim=1).values

    def in_set(queries, table):
        pos = torch.clamp(torch.searchsorted(table, queries),
                          max=table.shape[1] - 1)
        return torch.gather(table, 1, pos) == queries

    begin_mask = (keys != _NONE) & ~in_set(keys, old_sorted)
    end_mask = (old_sorted != _NONE) & ~in_set(old_sorted, keys)
    e = cap.event_capacity
    rows = (torch.arange(n_w, device=dev) * (e + 1))[:, None]

    def compact(mask, keyarr):
        pairs = torch.stack([keyarr // S, keyarr % S], dim=2).to(torch.int32)
        pos = torch.cumsum(mask.to(torch.int64), 1) - 1
        out = torch.zeros((n_w * (e + 1), 2), dtype=torch.int32, device=dev)
        out[(torch.where(mask & (pos < e), pos, e) + rows).reshape(-1)] = \
            pairs.reshape(-1, 2)
        return (out.reshape(n_w, e + 1, 2)[:, :e],
                torch.clamp(mask.sum(dim=1), max=e).to(torch.int32))

    begin_arr, begin_count = compact(begin_mask, keys)
    end_arr, end_count = compact(end_mask, old_sorted)
    store = torch.where(keys == _NONE, -1, keys).to(torch.int32)
    return dict(sensor_begin=begin_arr, sensor_begin_count=begin_count,
                sensor_end=end_arr, sensor_end_count=end_count), store
