"""The CCD solve's dispatch and tables on the CPU (the CUDA kernel itself,
`csrc/ccd.cu`, is held bit for bit against the plain loop on the card, in
tests/test_torch_cuda.py).

- On CPU tensors `pose._solve_ik_group` runs the plain loop: every IK
  group's result is, bit for bit, `solve_ik_group_plain`'s from the same
  inputs, and the CUDA solve is never reached.
- `IKSegment` packs each group's per-link lists once: `codes` holds the
  fix types, the limited flags and the Euler orders, field by field as the
  host programs give them, beside the parents, limits, targets, goals and
  angle limits; the crowd view shares the codes and offsets the rows.
- A group whose chains read each other through append parents
  (`torch_ik_rigs.cross_append_static`, the "cross" rig, held against the
  kernel on the card): the dispatcher gives the plain loop's bits, and
  solving its chains one after the other gives other bits, so the batched
  loop's lockstep, which the kernel reproduces, is what such a group
  needs.
- `_run_segments`, inside a compiled step's clock, hands each IK group a
  slice of `loop * G` flags of the pass's CCD buffer, the slices in group
  order and covering it.

The rigs: tests/torch_ik_rigs.py (the sample character with two arm IK
chains, in six variants of fix types, limits and Euler orders), on the
CPU, no JAX.
"""

import copy

import numpy as np
import pytest
import torch

from simple_mmd_renderer_tpu_torch.core import pose as pose_mod
from simple_mmd_renderer_tpu_torch.core.model import (EULER_ORDERS,
                                                      ModelTables)
from simple_mmd_renderer_tpu_torch.ops import ccd
from simple_mmd_renderer_tpu_torch.utils import profiling

from torch_ik_rigs import (N_VARIANTS, cross_append_static, frame_inputs,
                           ik_rig, ik_static, legs)

import torch_threads  # noqa: F401  (the port's tests' thread cap)

FIELDS = ("world", "skin", "total_rot", "total_trans", "pre_ik_rot",
          "ik_rot", "vertex_offsets", "leaf_rates")


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("variant", [None, 0, 3, "cross"])
@pytest.mark.parametrize("capturable", [False, True])
def test_cpu_dispatch_runs_the_plain_loop(monkeypatch, variant, capturable):
    """Each group's result through the dispatcher equals the plain loop's
    from the same inputs, bit for bit, with the CUDA solve never reached;
    and the posing pass gives the same bits twice."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA solve was called on CPU tensors")

    monkeypatch.setattr(ccd, "solve_ik_group_cuda", refuse)
    tables, motion = ik_rig(variant)
    dispatch = pose_mod._solve_ik_group
    calls = []

    def spy(static, pose, seg, *args):
        out = dispatch(static, pose, seg, *args)
        calls.append((static, pose, seg, args, out))
        return out

    monkeypatch.setattr(pose_mod, "_solve_ik_group", spy)
    for frame in (3, 41):
        del calls[:]
        inputs = frame_inputs(motion, frame)
        first = pose_mod.pre_physics_posing(tables, *inputs,
                                            capturable=capturable)
        assert len(calls) == 4
        for static, pose, seg, args, out in calls:
            want = pose_mod.solve_ik_group_plain(static, pose, seg, *args)
            for f in FIELDS:
                assert _bits_equal(getattr(out, f), getattr(want, f)), f
        again = pose_mod.pre_physics_posing(tables, *inputs,
                                            capturable=capturable)
        for f in FIELDS:
            assert _bits_equal(getattr(first, f), getattr(again, f)), f


def _check_tables(seg, iks):
    g, nl = len(iks), len(iks[0].links)
    assert seg.codes.dtype == torch.int32
    assert tuple(seg.codes.shape) == (3, nl)
    fix, limited, order = seg.codes.tolist()
    for ik in iks:
        assert fix == [int(f) for f in ik.fix_types]
        assert limited == [int(bool(x)) for x in ik.limited]
        assert [EULER_ORDERS[o] for o in order] == list(ik.orders)
    assert seg.fix_types == fix and seg.orders == list(iks[0].orders)
    assert seg.links.tolist() == [ik.links.tolist() for ik in iks]
    parents = np.stack([ik.link_parents for ik in iks])
    assert seg.link_has_parent.tolist() == (parents >= 0).tolist()
    assert seg.link_parent_safe.tolist() == np.maximum(parents, 0).tolist()
    assert seg.targets.tolist() == [ik.target for ik in iks]
    assert seg.goal_bones.tolist() == [ik.bone for ik in iks]
    np.testing.assert_array_equal(seg.angle_limit.numpy(),
                                  [np.float32(ik.angle_limit) for ik in iks])
    np.testing.assert_array_equal(seg.limits_min.numpy(),
                                  np.stack([ik.limits_min for ik in iks]))
    np.testing.assert_array_equal(seg.limits_max.numpy(),
                                  np.stack([ik.limits_max for ik in iks]))
    assert (seg.loop, seg.n_links, seg.links.shape[0]) == (
        iks[0].loop, nl, g)


@pytest.mark.parametrize("variant", [None] + list(range(N_VARIANTS)))
def test_ik_segment_packs_the_link_tables(variant):
    static = ik_static(variant)
    tables = ModelTables(static, device="cpu")
    host = [s for s in static.pre_segments + static.post_segments
            if s.kind == "ik"]
    segs = [s for s in list(tables.pre_segments) + list(tables.post_segments)
            if s.kind == "ik"]
    assert len(segs) == len(host) == 4
    for seg, h in zip(segs, host):
        _check_tables(seg, h.iks)
    # the crowd view: the same codes, the rows offset per instance
    n, b = 3, tables.n_bones
    crowd = tables.crowd(n)
    csegs = [s for s in crowd.pre_segments if s.kind == "ik"]
    for cseg, seg in zip(csegs, [s for s in tables.pre_segments
                                 if s.kind == "ik"]):
        g = seg.links.shape[0]
        assert cseg.codes is seg.codes
        assert cseg.links.shape[0] == n * g
        for i in range(n):
            rows = slice(i * g, (i + 1) * g)
            assert torch.equal(cseg.links[rows], seg.links + i * b)
            assert torch.equal(cseg.targets[rows], seg.targets + i * b)
            assert torch.equal(cseg.goal_bones[rows], seg.goal_bones + i * b)
            assert torch.equal(cseg.link_parent_safe[rows],
                               seg.link_parent_safe + i * b)
            for name in ("link_has_parent", "angle_limit", "limits_min",
                         "limits_max"):
                assert torch.equal(getattr(cseg, name)[rows],
                                   getattr(seg, name))


def test_cross_appended_chains_need_the_lockstep():
    """The legs' chains of `cross_append_static` read each other: solved
    one after the other (each a group of one) they give other bits than
    solved together (in world and total_rot), where the plain rig's legs
    give the same bits either way."""
    from simple_mmd_renderer_tpu_torch.core.model import IKSegment, Segment

    def both_ways(static):
        tables = ModelTables(static, device="cpu")
        motion = ik_rig()[1]
        host = legs(static)
        (seg,) = [s for s in tables.pre_segments if s.kind == "ik"
                  and s.iks is host.iks]
        calls = []
        dispatch = pose_mod._solve_ik_group

        def spy(st, pose, s, *args):
            if s is seg:
                calls.append((st, pose, args))
            return dispatch(st, pose, s, *args)

        pose_mod._solve_ik_group = spy
        try:
            pose_mod.pre_physics_posing(tables, *frame_inputs(motion, 31))
        finally:
            pose_mod._solve_ik_group = dispatch
        (st, pose, args), = calls
        together = pose_mod.solve_ik_group_plain(st, pose, seg, *args)
        apart = pose
        for ik in host.iks:
            one = IKSegment(Segment("ik", iks=[ik]), device="cpu")
            apart = pose_mod.solve_ik_group_plain(st, apart, one, *args)
        return [_bits_equal(getattr(together, f), getattr(apart, f))
                for f in ("world", "total_rot", "ik_rot")]

    assert all(both_ways(ik_static()))
    assert not all(both_ways(cross_append_static()))


def test_run_segments_hands_each_group_its_flags():
    """Inside a step's clock each group gets `loop * G` flags, consecutive
    slices of the pass's one buffer, in group order."""
    tables, motion = ik_rig()
    clock = profiling.StepClock(torch.device("cpu"))
    got = []
    dispatch = pose_mod._solve_ik_group

    def spy(static, pose, seg, *args):
        got.append((seg, args[5]))
        return dispatch(static, pose, seg, *args)

    pose_mod._solve_ik_group = spy
    try:
        with clock.running():
            pose_mod.pre_physics_posing(tables, *frame_inputs(motion, 9),
                                        capturable=True)
    finally:
        pose_mod._solve_ik_group = dispatch
    buf = clock.actives["pre_physics"]
    base = buf.data_ptr()
    offset = 0
    for seg, flags in got:
        n = seg.loop * seg.links.shape[0]
        assert flags.numel() == n and flags.dtype == torch.bool
        assert flags.data_ptr() == base + offset
        offset += n
    assert len(got) == 4 and offset == buf.numel()
    # the flags are the plain loop's: the first iteration of every chain
    # runs unless its target starts on the goal
    assert bool(buf.any())
