"""Animation, posing and skinning: the port vs the reference on the sample
rig (plus the math and Bezier layers under them).

Tolerances: sampled motion, math and Bezier evaluation are expected to be
exact to float rounding (atol 1e-6); poses and deformed vertices atol 1e-4.
Converged CCD IK is the exception (PARITY.md D1): it runs all 40 iterations
of an ill-conditioned update (each step's angle is acos of a dot product
near 1), which amplifies last-bit differences — the reference's own jitted
and eager runs differ by up to 4.7e-3 in the IK rotations here. So the
IK-driven bones are held at the levels stated in the two posing tests, the
FK-only bones at 1e-4.
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import sample_character, sample_motion
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import pose as ref_pose
from simple_mmd_renderer_tpu.utils import bezier as ref_bezier
from simple_mmd_renderer_tpu.utils import math3d as ref_m3
from simple_mmd_renderer_tpu_torch.core import anim, pose
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.utils import bezier
from simple_mmd_renderer_tpu_torch.utils import math3d as m3

import torch_threads  # noqa: F401  (the port's tests' thread cap)

POSE_FIELDS = ("world", "skin", "total_rot", "total_trans", "pre_ik_rot",
               "ik_rot", "vertex_offsets", "leaf_rates")


@pytest.fixture(scope="module")
def rig():
    static = ref_model.build_model(sample_character(density=0.5))
    motion = ref_anim.bind_motion(static, sample_motion(90, fps_keys=10))
    return static, motion


def _t(x):
    return torch.as_tensor(np.array(x))


def _to_port_pose(p):
    return pose.PoseArrays(**{f: _t(getattr(p, f)) for f in POSE_FIELDS})


def _ik_affected(static):
    """Bones whose transform depends on a CCD solve: IK links, targets and
    their descendants."""
    seeds = set()
    for seg in static.pre_segments + static.post_segments:
        for ik in seg.iks:
            seeds |= set(ik.links.tolist()) | {ik.target}
    out = np.zeros(static.n_bones, bool)
    for b in range(static.n_bones):
        p = b
        while p >= 0:
            if p in seeds:
                out[b] = True
                break
            p = int(static.bone_parent[p])
    return out


def test_math3d_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.normal(size=(64, 4)).astype(np.float32)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    t = rng.uniform(0, 1, 64).astype(np.float32)
    jq, jr, jv, jt = map(jnp.asarray, (q, r, v, t))
    tq, tr, tv, tt = map(torch.as_tensor, (q, r, v, t))
    pairs = [
        (m3.quat_mul(tq, tr), ref_m3.quat_mul(jq, jr)),
        (m3.quat_to_mat3(tq), ref_m3.quat_to_mat3(jq)),
        (m3.quat_rotate(tq, tv), ref_m3.quat_rotate(jq, jv)),
        (m3.quat_nlerp(tq, tr, tt), ref_m3.quat_nlerp(jq, jr, jt)),
        (m3.quat_slerp(tq, tr, tt), ref_m3.quat_slerp(jq, jr, jt)),
        (m3.axis_angle_to_quat(tv, tt * 3), ref_m3.axis_angle_to_quat(
            jv, jt * 3)),
    ]
    for order in ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx"):
        pairs.append((m3.quat_to_euler(tq, order),
                      ref_m3.quat_to_euler(jq, order)))
        pairs.append((m3.euler_to_quat(tv, order),
                      ref_m3.euler_to_quat(jv, order)))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_bezier_lut_eval_bit_equal():
    """Plain indexing gives the reference's one-hot contraction's bits,
    including x = 1 (the last-sample branch)."""
    rng = np.random.default_rng(1)
    c0 = rng.integers(0, 128, (50, 2)).astype(np.float32) / 127
    c1 = rng.integers(0, 128, (50, 2)).astype(np.float32) / 127
    lut, _ = bezier.presample(c0, c1)
    x = rng.uniform(0, 1, 50).astype(np.float32)
    x[:3] = (0.0, 1.0, 0.5)
    got = bezier.lut_eval(torch.as_tensor(lut), torch.as_tensor(x)).numpy()
    ref = np.asarray(ref_bezier.lut_eval(jnp.asarray(lut), jnp.asarray(x)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("frame", [0.0, 1.0, 7.5, 44.0, 89.0, 200.0])
def test_sample_motion_matches_reference(rig, frame):
    static, motion = rig
    from simple_mmd_renderer_tpu_torch.core.anim import MotionTables
    got = anim.sample_motion(MotionTables(motion, device="cpu"),
                             torch.tensor(frame))
    ref = ref_anim.sample_motion(motion, jnp.float32(frame))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.fixture(scope="module")
def ref_pre(rig):
    """The reference's pre_physics_posing on the rig, jitted once for the
    module (the full-IK comparison and the skinning test's pose)."""
    static, _ = rig
    return jax.jit(lambda a, b, c: ref_pose.pre_physics_posing(static, a, b,
                                                               c))


def _compare_posing(static, motion, frames, atol_ik_rot, atol_ik_pos,
                    pre=None):
    tables = ModelTables(static, device="cpu")
    mt = anim.MotionTables(motion, device="cpu")
    ik = _ik_affected(static)
    pre = pre or jax.jit(lambda a, b, c: ref_pose.pre_physics_posing(
        static, a, b, c))
    worst = {"rot": 0.0, "pos": 0.0}
    for fr in frames:
        inputs = ref_anim.sample_motion(motion, jnp.float32(fr))
        ref = pre(*inputs)
        got = pose.pre_physics_posing(tables, *anim.sample_motion(
            mt, torch.tensor(fr)))
        for f in POSE_FIELDS:
            g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
            if f in ("vertex_offsets", "leaf_rates"):
                np.testing.assert_allclose(g, r, atol=1e-4, err_msg=f)
                continue
            np.testing.assert_allclose(g[~ik], r[~ik], atol=1e-4,
                                       err_msg=f"{f} (FK bones)")
            d = np.abs(g[ik] - r[ik])
            if f in ("world", "skin"):
                worst["pos"] = max(worst["pos"], float(d.max()))
            else:
                worst["rot"] = max(worst["rot"], float(d.max()))
        post_ref = ref_pose.post_physics_posing(static, ref, *inputs)
        post = pose.post_physics_posing(tables, _to_port_pose(ref),
                                        *[_t(x) for x in inputs])
        for f in POSE_FIELDS:
            np.testing.assert_allclose(getattr(post, f).numpy(),
                                       np.asarray(getattr(post_ref, f)),
                                       atol=1e-4, err_msg=f"post {f}")
    assert worst["rot"] <= atol_ik_rot, worst
    assert worst["pos"] <= atol_ik_pos, worst


def test_posing_matches_reference_at_two_ik_iterations(rig):
    """Every CCD program cut to 2 iterations. Even one CCD step is
    ill-conditioned: its angle is acos(dot) with dot near 1, where a
    one-ulp difference of the dot product moves the angle by ~3e-4 rad.
    Measured: IK rotations differ by up to 2.5e-4 and translations by up to
    5.4e-4 MMD units; held at 1e-3 and 2e-3. FK-only bones at 1e-4."""
    static, motion = rig
    short = copy.deepcopy(static)
    for seg in short.pre_segments + short.post_segments:
        for ik in seg.iks:
            ik.loop = 2
    _compare_posing(short, motion, [1.0, 30.0, 61.0], 1e-3, 2e-3)


def test_posing_matches_reference_full_ik(rig, ref_pre):
    """The sample rig's own IK (40 iterations on the legs). FK-only bones at
    atol 1e-4; IK-driven bones at the PARITY D1 level: measured over these
    frames, rotations differ by up to 9.4e-4 and world/skin translations by
    up to 8.5e-3 MMD units (about 1 mm on the 1.6 m figure); held at 2e-3
    and 2e-2."""
    static, motion = rig
    _compare_posing(static, motion, [1.0, 2.0, 45.0], 2e-3, 2e-2, ref_pre)


def test_apply_morphs_overlapping_entries_bit_equal(rig):
    """Vertex morphs whose entries share vertices (up to 16 per vertex):
    the port sums them in entry order, one occurrence pass at a time, and
    gives the reference's scatter-add bits."""
    static, _ = rig
    rng = np.random.default_rng(7)
    e = 400
    static = dataclasses.replace(
        static, vm_vertex=rng.integers(0, 40, e).astype(np.int32),
        vm_morph=rng.integers(0, static.n_morphs, e).astype(np.int32),
        vm_offset=rng.normal(size=(e, 3)).astype(np.float32))
    tables = ModelTables(static, device="cpu")
    assert tables.n_vm_passes > 1
    for _ in range(3):
        rates = rng.uniform(0, 1, static.n_morphs).astype(np.float32)
        got = pose.apply_morphs(tables, torch.as_tensor(rates))
        ref = ref_pose.apply_morphs(static, jnp.asarray(rates))
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   atol=1e-6)


def test_deform_matches_reference(rig, ref_pre):
    """Skinning from the same pose (the reference's, jitted, given to
    both): the bone-palette matmul and the 4-wide gather path."""
    static, motion = rig
    inputs = ref_anim.sample_motion(motion, jnp.float32(12.0))
    ref_p = ref_pre(*inputs)
    tables = ModelTables(static, device="cpu")
    for use_matmul in (True, False):
        got = pose.deform(tables, _to_port_pose(ref_p), use_matmul=use_matmul)
        ref = ref_pose.deform(static, ref_p, use_matmul=use_matmul)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
