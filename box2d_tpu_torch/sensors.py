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

import dataclasses

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
                prev_origin, prev_rot, stats=None) -> WorldState:
    """The sensor begin / end events and the new overlap store
    (box2d_tpu/sensors.py:31-130). prev_origin / prev_rot: the bodies'
    pre-step poses, for the swept test. stats (world.StepStats) counts
    the device reads of the GJK and cast loops."""
    if not sensor_ids:
        return state
    sh = state.shapes
    b = state.bodies
    dev = b.center.device
    S = sh.type.shape[0]
    ns = len(sensor_ids)
    sid = torch.tensor(sensor_ids, dtype=torch.int64, device=dev)
    body = sh.body.long()
    p = b.origin[body]
    q = b.rot[body]

    # (n_sensors, S) lanes: sensor s as proxy A, visitor v as proxy B
    lane_s = torch.arange(S, device=dev)
    s_l = sid[:, None].expand(ns, S).reshape(-1)
    v_l = lane_s[None, :].expand(ns, S).reshape(-1)
    eligible = (sh.enable_sensor_events[None, :]
                & (body[None, :] != body[sid][:, None])
                & _group_pass(sh, sid[:, None], lane_s[None, :])
                & (sh.enabled & b.enabled[body])[None, :]
                & sh.enable_sensor_events[sid][:, None]).reshape(-1)
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

    # keys = sensor shape * S + visitor, sorted, cut to the capacity
    keys = torch.sort(torch.where(overlap, s_l * S + v_l, _NONE)).values
    kcap = cap.sensor_pair_capacity
    if keys.shape[0] >= kcap:
        keys = keys[:kcap]           # an overflow drops the largest keys
    else:
        keys = torch.cat([keys, torch.full((kcap - keys.shape[0],), _NONE,
                                           dtype=keys.dtype, device=dev)])
    old = state.sensor_overlap.long()
    old_sorted = torch.sort(torch.where(old < 0, _NONE, old)).values

    def in_set(queries, table):
        pos = torch.clamp(torch.searchsorted(table, queries),
                          max=table.shape[0] - 1)
        return table[pos] == queries

    begin_mask = (keys != _NONE) & ~in_set(keys, old_sorted)
    end_mask = (old_sorted != _NONE) & ~in_set(old_sorted, keys)
    e = cap.event_capacity

    def compact(mask, keyarr):
        pairs = torch.stack([keyarr // S, keyarr % S], dim=1).to(torch.int32)
        pos = torch.cumsum(mask.to(torch.int64), 0) - 1
        out = torch.zeros((e + 1, 2), dtype=torch.int32, device=dev)
        out[torch.where(mask & (pos < e), pos, e)] = pairs
        return out[:e], torch.clamp(mask.sum(), max=e).to(torch.int32)

    begin_arr, begin_count = compact(begin_mask, keys)
    end_arr, end_count = compact(end_mask, old_sorted)
    events = dataclasses.replace(
        state.events, sensor_begin=begin_arr, sensor_begin_count=begin_count,
        sensor_end=end_arr, sensor_end_count=end_count)
    store = torch.where(keys == _NONE, -1, keys).to(torch.int32)
    return dataclasses.replace(state, events=events, sensor_overlap=store)
