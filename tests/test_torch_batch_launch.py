"""Which kernel a batched solver launch takes, decided on the host.

`contact_solver.batched_plan` picks, once for each capacity and from the
capacity alone, the small-world kernel (a group of warps a world, several
worlds a CTA, body rows in shared memory) or the cluster kernel (a cluster
of eight CTAs a world) of csrc/contact_solver.cu. These tests hold the rule
at every batched capacity the repo's batches use (chip_smoke.py phase 6,
tests/test_rl_demo.py): the path, threads a world and worlds a CTA. The
kernels themselves run only on the card, where chip_smoke.py holds each
batched launch to its single launches bit for bit and prints each plan's
shared memory a CTA. Pure PyTorch: no JAX function is compiled here.
"""

import dataclasses

import pytest
import torch

from box2d_tpu_torch import api, geometry, scenes, types, world
from box2d_tpu_torch import contact_solver as cs
from box2d_tpu_torch.batch import batched_kernel_args
from box2d_tpu_torch.joints import joint_types_present, solvable_joint_types
from box2d_tpu_torch.narrowphase import classes_for_shape_types
from box2d_tpu_torch.state import auto_chunk, broadcast_state
from port_fixtures import api_scene, every_gate_tank, with_all_events

torch.set_num_threads(1)


def _joint_farm(ragdolls=1):
    w = scenes.joint_farm(ragdolls=ragdolls, device="cpu")
    state, cap = w.builder.build(device="cpu")
    jt = joint_types_present(j["_type"] for j in w.builder._joints)
    return w, state, dataclasses.replace(cap, batched=True), jt


def _pyramid(rows):
    w = scenes.pyramid(rows=rows, device="cpu")
    state, cap = w.builder.build(device="cpu")
    return w, state, dataclasses.replace(cap, bp_repair_cap=0,
                                         batched=True), frozenset()


def _api_scene():
    w = with_all_events(api_scene(api.World, types, geometry, device="cpu"),
                        0.5)
    cap = dataclasses.replace(w.builder.default_capacity(), max_verts=8,
                              batched=True)
    state, cap = w.builder.build(cap, device="cpu")
    return w, state, cap, joint_types_present(
        j["_type"] for j in w.builder._joints)


def _gate_tank():
    w = every_gate_tank(api.World, types, geometry, particles=600,
                        device="cpu")
    w.compile()
    return w, w.state, w.capacity, w._jtypes


def _plan(cap, joint_types):
    """batched_plan from the capacity, as the batched step's arrays give
    it to contact_solve_batched: nb bodies, the color chunk, the step's
    tail windows, the joint region's max_joints lanes."""
    step = world.make_batched_step(cap, frozenset(), 4, True,
                                   joint_types=joint_types)
    chunk = cap.color_chunk or auto_chunk(cap.max_contact_pairs)
    lj = cap.max_joints if solvable_joint_types(joint_types) else 0
    return cs.batched_plan(cap.max_bodies, chunk, step.tail_w, lj)


# (capacity, path, capacity bound, threads a world, worlds a CTA)
PLANS = {
    "joint_farm(1)": (_joint_farm, "small", 132, 32, 4),
    "pyramid-20": (lambda: _pyramid(20), "small", 211, 128, 1),
    "api_scene": (_api_scene, "small", 136, 64, 2),
    "every_gate_tank(600)": (_gate_tank, "small", 128, 32, 4),
    "pyramid-40": (lambda: _pyramid(40), "small", 821, 128, 1),
    # 500 bodies, but a color's bucket and 400 joint lanes take 528
    "joint_farm(100)": (lambda: _joint_farm(100), "small", 528, 128, 1),
    "pyramid-60": (lambda: _pyramid(60), "cluster", 1831, 0, 0),
    # 1,500 bodies; a color's bucket and 1,200 joint lanes take 1,584
    "joint_farm(300)": (lambda: _joint_farm(300), "cluster", 1584, 0, 0),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_batched_plan_of_each_capacity(name):
    make, path, bound, threads, per_cta = PLANS[name]
    _, _, cap, jt = make()
    plan = _plan(cap, jt)
    assert (plan.path, plan.nb, plan.bound, plan.threads_per_world,
            plan.worlds_per_cta) == (path, cap.max_bodies, bound, threads,
                                     per_cta)
    if path == "small":
        assert plan.threads_per_world % 32 == 0
        assert plan.threads_per_world * plan.worlds_per_cta == cs.CTA_THREADS
        assert plan.threads_per_world <= cs.GROUP_MAX
    assert _plan(cap, jt) is plan    # decided once for each capacity


@pytest.mark.parametrize("nb, chunk, tail_w, lj, path", [
    (1024, 512, 1024, 0, "small"),    # the widest the small kernel takes
    (1025, 512, 1024, 0, "cluster"),
    (5, 128, 128, 896, "small"),      # a color's bucket and joint segment
    (5, 128, 128, 897, "cluster"),
    (5, 128, 1025, 0, "cluster"),     # a tail window
])
def test_batched_plan_rule_at_its_edges(nb, chunk, tail_w, lj, path):
    plan = cs.batched_plan(nb, chunk, tail_w, lj)
    assert plan.path == path
    assert plan.bound == max(nb, chunk + lj, tail_w)
    if path == "small":
        assert plan.threads_per_world == min(cs.GROUP_MAX,
                                             -(-nb // 32) * 32)


@pytest.mark.parametrize("name", ["joint_farm(1)", "pyramid-20"])
def test_batched_step_args_give_the_capacity_plan(name):
    """The arrays the batched step packs for three worlds give
    contact_solve_batched the plan of their capacity."""
    make = PLANS[name][0]
    w, state, cap, jt = make()
    classes = classes_for_shape_types(
        s["geom"].type for s in w.builder._shapes)
    step = world.make_batched_step(cap, classes, 4, True, joint_types=jt)
    batch = step(broadcast_state(state, 3), 1 / 60)
    args = batched_kernel_args(batch, 1 / 60, step)
    assert len(args) == (12 if jt else 11)
    assert cs.plan_for(args) is _plan(cap, jt)
