"""Rigid-body physics: the port vs the reference on the sample rig and on a
variant of it with box bodies (the box-box separating-axis manifold and the
rotation-aware contact path).

Both sides step from the same state with the same animated pose each frame,
so the comparison sees the solver alone (IK divergence, PARITY D1, stays
out). State leaves atol 1e-4: the solvers sum rows in another order (the
incidence matmuls and einsums), measured up to 5.7e-5 in velocities.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import sample_character, sample_motion
from simple_mmd_renderer_tpu.config import PhysicsConfig
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core import pose as ref_pose
from simple_mmd_renderer_tpu.formats import pmx as P
from simple_mmd_renderer_tpu_torch.core import physics, pose
from simple_mmd_renderer_tpu_torch.core.model import ModelTables

import torch_threads  # noqa: F401  (the port's tests' thread cap)

LEAVES = ("pos", "quat", "vel", "omega")
POSE_FIELDS = ("world", "skin", "total_rot", "total_trans", "pre_ik_rot",
               "ik_rot", "vertex_offsets", "leaf_rates")


@pytest.fixture(scope="module")
def rig():
    static = ref_model.build_model(sample_character(density=0.5))
    motion = ref_anim.bind_motion(static, sample_motion(90, fps_keys=10))
    return static, motion


def _t(x):
    return torch.as_tensor(np.array(x))


def _boxed(ps):
    """The sample rig's bodies with every third one turned into a box
    (half-extents from its dims), so box-box, box-sphere and box-capsule
    pairs all occur."""
    shape = np.array(ps.shape)
    shape[::3] = P.SHAPE_BOX
    dims = np.array(ps.dims)
    dims[::3] = np.maximum(dims[::3, :1], 0.3).repeat(3, 1)
    return dataclasses.replace(ps, shape=shape, dims=dims.astype(np.float32))


@pytest.fixture(scope="module")
def ref_poses(rig):
    """The reference's animated pose of frames 0-3 (pre_physics_posing,
    jitted once), which both solver comparisons step through."""
    static, motion = rig
    pre = jax.jit(lambda a, b, c: ref_pose.pre_physics_posing(static, a, b,
                                                              c))
    return {fr: pre(*ref_anim.sample_motion(motion, jnp.float32(fr)))
            for fr in (0.0, 1.0, 2.0, 3.0)}


def _react_three_frames(static, poses, ps, cfg, atol):
    react = jax.jit(lambda st, p: ref_physics.physics_react(static, ps, st,
                                                            p, cfg))
    tables = ModelTables(static, device="cpu")
    ptables = physics.PhysicsTables(ps, device="cpu")
    ref_state = ref_physics.physics_reset(ps, poses[0.0])
    state = physics.PhysicsState(**{k: _t(getattr(ref_state, k))
                                    for k in LEAVES})
    for fr in (1.0, 2.0, 3.0):
        ref_p = poses[fr]
        ref_state, ref_out = react(ref_state, ref_p)
        state, out = physics.physics_react(
            tables, ptables, state,
            pose.PoseArrays(**{f: _t(getattr(ref_p, f))
                               for f in POSE_FIELDS}), cfg)
        for k in LEAVES:
            np.testing.assert_allclose(getattr(state, k).numpy(),
                                       np.asarray(getattr(ref_state, k)),
                                       atol=atol, err_msg=f"frame {fr} {k}")
        np.testing.assert_allclose(out.skin.numpy(), np.asarray(ref_out.skin),
                                   atol=atol, err_msg=f"frame {fr} skin")


def test_physics_react_three_frames(rig, ref_poses):
    static, _ = rig
    _react_three_frames(static, ref_poses, ref_physics.build_physics(static),
                        PhysicsConfig(solver_iterations=4), 1e-4)


def test_physics_react_with_boxes(rig, ref_poses):
    """Box bodies switch on the manifold contacts (4 slots per pair, SAT for
    box-box) and the rotation-aware anchors."""
    static, _ = rig
    ps = _boxed(ref_physics.build_physics(static))
    _react_three_frames(static, ref_poses, ps,
                        PhysicsConfig(solver_iterations=2), 1e-4)


def test_contacts_match_reference(rig):
    """Pair and ground manifolds on overlapping random poses of the boxed
    rig: every candidate pair of every shape combination."""
    static, _ = rig
    ps = _boxed(ref_physics.build_physics(static))
    rng = np.random.default_rng(5)
    r = ps.n_bodies
    pos = rng.uniform(-1.0, 1.0, (r, 3)).astype(np.float32)
    pos[:, 1] += 0.3                       # some bodies dip into the floor
    quat = rng.normal(size=(r, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    tables = physics.PhysicsTables(ps, device="cpu")
    ref_pc = ref_physics.pair_contacts(ps, jnp.asarray(pos), jnp.asarray(quat))
    got_pc = physics.pair_contacts(tables, _t(pos), _t(quat))
    assert got_pc[2].shape[1] == physics.PAIR_MANIFOLD
    depth_ref = np.asarray(ref_pc[2])
    assert (depth_ref > 0).sum() > 10      # the poses really overlap
    # slots are compared where the reference's slot is a contact candidate
    live = depth_ref > -1e8
    np.testing.assert_allclose(got_pc[2].numpy(), depth_ref, atol=1e-4)
    for g, rf in zip(got_pc[:2], ref_pc[:2]):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(rf)[live],
                                   atol=1e-4)
    ref_gc = ref_physics.ground_contacts(ps, jnp.asarray(pos),
                                         jnp.asarray(quat))
    got_gc = physics.ground_contacts(tables, _t(pos), _t(quat))
    for g, rf in zip(got_gc, ref_gc):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), atol=1e-5)
