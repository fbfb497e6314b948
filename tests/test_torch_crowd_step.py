"""The crowd's batched pose + physics step: `parallel.mesh.crowd_init` and
`crowd_step_fn(scene, render=False)` of the port against the reference's
(`jax.vmap(scene.step_pose)`, jitted) and against the port's own
single-instance `Scene.step_pose`.

Configuration (tests/test_parallel.py's): the sample character at density
0.25, `sample_motion(60, fps_keys=10)`, 4 solver iterations; the port's
Scene is built from the reference's objects through `convert`, on the CPU.

Against the reference, 3 frames of 3 instances with staggered clocks.
Instance 0 runs the frames tests/test_torch_slice.py runs and is held to
its tolerances: `time` equal, physics leaves at 1e-4, except pos/quat of
kinematic bodies on IK-driven bones at 6e-3 / 1.5e-3 (they copy the bone,
so they inherit the port's CCD divergence, PARITY D1; measured 3.88e-3 /
9.8e-4, the slice test's own values). Instances 1 and 2 start 7 and 14
frames later, where the same CCD divergence is larger (a property of the
single-instance posing at those frames: the reference's vmapped step equals
its single step there to 1e-6, and the port's crowd step equals its single
step, below) and reaches the dynamic bodies that touch or hang from an
IK-driven kinematic body. Measured: kinematic IK bodies 7.2e-3 / 1.41e-3
(held at 1e-2 / 2e-3); other bodies pos 8.9e-4, quat 1.6e-4, vel 1.5e-2,
omega 6.7e-3 (held at 2e-3, 5e-4, 3e-2, 3e-2; the velocity is the position
difference over a 1/60 s substep). Deformed vertices at 2e-2, the posing
tolerance of tests/test_torch_pose.py (measured 1.4e-2), normals at 5e-3
(measured 2.8e-3).

Against the port's own single step, one instance at a time from the same
clock: the batched step differs only where a product gains a batch (the
dense skinning product, `morph_rates @ morph_expand`, the incidence sums),
which may block its sum differently. Measured over 3 frames of 4
instances: vertices 1.9e-6 MMD units, normals 4.8e-7, skinning matrices
3.6e-6 (the write-back from the bodies), body positions 4.8e-7, quaternions
2.5e-7, velocities 2.9e-5, bone matrices, morph offsets and leaf rates 0
(held at 1e-5, velocities at 1e-4).
"""

import numpy as np
import jax
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import sample_character, sample_motion
from simple_mmd_renderer_tpu.config import AppConfig, RenderConfig
from simple_mmd_renderer_tpu.core import anim as A
from simple_mmd_renderer_tpu.core import model as M
from simple_mmd_renderer_tpu.core import physics as PH
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core import physics as phys_mod
from simple_mmd_renderer_tpu_torch.core import pose as pose_mod
from simple_mmd_renderer_tpu_torch.core.scene import Scene, SimState
from simple_mmd_renderer_tpu_torch.parallel import mesh as par

from test_torch_slice import _ik_driven_bodies

import torch_threads  # noqa: F401  (the port's tests' thread cap)


def ref_scene(width=128, height=64, **render):
    static = M.build_model(sample_character(density=0.25))
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height, shadow_map_size=64,
                              show_skybox=False, raster_mode="tiled",
                              **render)
    cfg.physics.solver_iterations = 4
    return RefScene(static, PH.build_physics(static),
                    A.bind_motion(static, sample_motion(60, fps_keys=10)),
                    cfg)


def port_scene(ref):
    return Scene(convert.model_static(ref.static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(ref.motion),
                 convert.app_config(ref.config), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    ref = ref_scene()
    return ref, port_scene(ref)


def _leaves(ref_state):
    return {"time": np.asarray(ref_state.time),
            **{k: np.asarray(getattr(ref_state.physics, k))
               for k in convert.PHYSICS_LEAVES}}


@pytest.mark.parametrize("phase", [7.0, 0.0])
def test_crowd_init_matches_reference(scenes, phase):
    ref, port = scenes
    want = _leaves(ref_par.crowd_init(ref, 4, phase_frames=phase))
    state = par.crowd_init(port, 4, phase_frames=phase)
    got = convert.sim_state_to_numpy(state)
    assert got["time"].shape == (4,)
    np.testing.assert_array_equal(got["time"], want["time"])
    for k in convert.PHYSICS_LEAVES:
        assert got[k].shape == want[k].shape == (4, port.phys.n_bodies,
                                                 want[k].shape[-1])
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert state.physics.pos.is_contiguous()    # real copies, not views


def test_crowd_state_round_trips_through_convert(scenes):
    """sim_state_to_torch / sim_state_to_numpy on a crowd state: leaves
    with a leading [I], from the reference's state and back."""
    ref, port = scenes
    ref_state = ref_par.crowd_init(ref, 3)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    assert state.time.shape == (3,) and state.time.dtype == torch.float32
    assert state.physics.quat.shape == (3, port.phys.n_bodies, 4)
    back = convert.sim_state_to_numpy(state)
    want = _leaves(ref_state)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)
    # and the port steps the converted state
    state2, _, positions, _ = port.step_pose(state)
    assert positions.shape == (3, port.rig.n_vertices, 3)
    assert state2.physics.pos.shape == (3, port.phys.n_bodies, 3)


def test_crowd_step_matches_reference_three_frames(scenes):
    ref, port = scenes
    n = 3
    ref_state = ref_par.crowd_init(ref, n, phase_frames=7.0)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    ref_step = jax.jit(ref_par.crowd_step_fn(ref, render=False))
    step = par.crowd_step_fn(port, render=False)
    ik = _ik_driven_bodies(ref.static, ref.phys_static)
    assert 0 < ik.sum() < ref.phys_static.n_bodies
    for frame in range(3):
        ref_state, ref_pose, ref_pos, ref_nrm = ref_step(ref_state)
        state, pose, pos, nrm = step(state)
        got, want = convert.sim_state_to_numpy(state), _leaves(ref_state)
        np.testing.assert_array_equal(got["time"], want["time"])
        for k in convert.PHYSICS_LEAVES:
            # instance 0: the slice test's frames and tolerances
            np.testing.assert_allclose(got[k][0, ~ik], want[k][0, ~ik],
                                       atol=1e-4, err_msg=f"{frame} {k}")
            np.testing.assert_allclose(
                got[k][0, ik], want[k][0, ik], err_msg=f"{frame} {k} (IK)",
                atol={"pos": 6e-3, "quat": 1.5e-3}.get(k, 1e-4))
            # later clocks: the CCD divergence of those frames (docstring)
            np.testing.assert_allclose(
                got[k][1:, ~ik], want[k][1:, ~ik], err_msg=f"{frame} {k}",
                atol={"pos": 2e-3, "quat": 5e-4}.get(k, 3e-2))
            np.testing.assert_allclose(
                got[k][1:, ik], want[k][1:, ik], err_msg=f"{frame} {k} (IK)",
                atol={"pos": 1e-2, "quat": 2e-3}.get(k, 1e-4))
        assert pos.shape == ref_pos.shape == (n, port.rig.n_vertices, 3)
        np.testing.assert_allclose(pos.numpy(), np.asarray(ref_pos),
                                   atol=2e-2, err_msg=f"frame {frame}")
        np.testing.assert_allclose(nrm.numpy(), np.asarray(ref_nrm),
                                   atol=5e-3, err_msg=f"frame {frame}")
        assert pose.world.shape == (n, port.rig.n_bones, 4, 4)
        assert pose.leaf_rates.shape == np.asarray(ref_pose.leaf_rates).shape
    # staggered clocks: the instances are in different poses
    assert float((pos[0] - pos[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("phase", [0.0, 7.0], ids=["same_clock", "staggered"])
def test_crowd_step_matches_single_instance_steps(scenes, phase):
    _, port = scenes
    n = 4
    crowd = par.crowd_init(port, n, phase_frames=phase)
    singles = []
    for i in range(n):
        s = port.init_state()
        singles.append(SimState(time=crowd.time[i].clone(),
                                physics=s.physics))
    step = par.crowd_step_fn(port, render=False)
    worst = dict(pos=0.0, world=0.0, body=0.0, quat=0.0, vel=0.0)
    for _ in range(3):
        crowd, pose, pos, nrm = step(crowd)
        for i in range(n):
            singles[i], p1, pos1, nrm1 = port.step_pose(singles[i])

            def gap(a, b):
                return float((a - b).abs().max())

            worst["pos"] = max(worst["pos"], gap(pos[i], pos1),
                               gap(nrm[i], nrm1))
            worst["world"] = max(worst["world"], gap(pose.world[i], p1.world),
                                 gap(pose.skin[i], p1.skin))
            worst["body"] = max(worst["body"], gap(crowd.physics.pos[i],
                                                   singles[i].physics.pos))
            worst["quat"] = max(worst["quat"], gap(crowd.physics.quat[i],
                                                   singles[i].physics.quat))
            worst["vel"] = max(worst["vel"],
                               gap(crowd.physics.vel[i],
                                   singles[i].physics.vel),
                               gap(crowd.physics.omega[i],
                                   singles[i].physics.omega))
            assert float(crowd.time[i]) == float(singles[i].time)
    assert worst["pos"] <= 1e-5, worst
    assert worst["world"] <= 1e-5, worst
    assert worst["body"] <= 1e-5 and worst["quat"] <= 1e-5, worst
    assert worst["vel"] <= 1e-4, worst
    if phase == 0.0:
        assert float((pos[0] - pos[n - 1]).abs().max()) <= 1e-5
    else:
        assert float((pos[0] - pos[n - 1]).abs().max()) > 1e-3


def _count_calls(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)


def test_fused_step_does_not_loop_over_instances(scenes, monkeypatch):
    """One crowd step of 4 instances calls the IK group solver and the
    physics substep exactly as often as one single-instance step."""
    _, port = scenes
    counts = {}
    _count_calls(monkeypatch, pose_mod, "_solve_ik_group", counts)
    _count_calls(monkeypatch, pose_mod, "_fk_bones", counts)
    _count_calls(monkeypatch, phys_mod, "physics_substep", counts)
    _count_calls(monkeypatch, phys_mod, "_joint_pass", counts)
    port.step_pose(port.init_state())
    single = dict(counts)
    assert single["_solve_ik_group"] > 0 and single["physics_substep"] > 0
    counts.clear()
    par.crowd_step_fn(port, render=False)(par.crowd_init(port, 4))
    assert counts["_solve_ik_group"] == single["_solve_ik_group"]
    assert counts["physics_substep"] == single["physics_substep"]
    assert counts["_joint_pass"] == single["_joint_pass"]
    # the CCD loop runs until the slowest chain of any instance converges,
    # so the per-link FK calls may exceed one instance's, never I times
    assert single["_fk_bones"] <= counts["_fk_bones"] \
        < 2 * single["_fk_bones"]


def test_crowd_views_offset_the_rig_tables(scenes):
    """The instance-major views: instance i's copy of every index table
    is the rig's plus i * (bones | bodies | vertices), "none" (-1) kept."""
    _, port = scenes
    rig, ps = port.rig, port.phys
    v, pv = rig.crowd(3), ps.crowd(3, rig.n_bones)
    assert rig.crowd(3) is v and ps.crowd(3, rig.n_bones) is pv   # cached
    b, r = rig.n_bones, ps.n_bodies
    parent = v.bone_parent.reshape(3, b)
    for i in range(3):
        want = torch.where(rig.bone_parent < 0, rig.bone_parent,
                           rig.bone_parent + i * b)
        assert torch.equal(parent[i], want)
        assert torch.equal(pv.pair_i.reshape(3, -1)[i], ps.pair_i + i * r)
        assert torch.equal(pv.bone.reshape(3, -1)[i], ps.bone + i * b)
        assert torch.equal(pv.wb_bone.reshape(3, -1)[i], ps.wb_bone + i * b)
    assert (rig.bone_parent < 0).any()
    assert pv.s_pair_a is ps.s_pair_a and v.skin_weight_dense is \
        rig.skin_weight_dense
    ik = [s for s in v.pre_segments if s.kind == "ik"][0]
    ik0 = [s for s in rig.pre_segments if s.kind == "ik"][0]
    g = ik0.links.shape[0]
    assert ik.links.shape == (3 * g, ik0.n_links)
    assert torch.equal(ik.links[2 * g:], ik0.links + 2 * b)
    assert torch.equal(v.instance_rows(5), torch.tensor([5, 5 + b, 5 + 2 * b]))


def _boxed_strict(ps):
    """The rig's bodies with every third one a box (box-box, box-sphere and
    box-capsule pairs: 4 manifold slots per pair, rotation-aware anchors)
    and every second write-back body strict (the translation fix)."""
    import dataclasses

    from simple_mmd_renderer_tpu.formats import pmx as P

    shape = np.array(ps.shape)
    shape[::3] = P.SHAPE_BOX
    dims = np.array(ps.dims)
    dims[::3] = np.maximum(dims[::3, :1], 0.3).repeat(3, 1)
    strict = np.array(ps.strict)
    wb = np.flatnonzero(np.asarray(ps.writeback))
    strict[wb[::2]] = True
    return dataclasses.replace(ps, shape=shape, dims=dims.astype(np.float32),
                               strict=strict)


def test_crowd_physics_with_boxes_and_strict_bodies(scenes):
    """`physics_react` on the crowd views of a rig with box bodies and
    strict bodies (neither is in the sample rig): 3 instances from 3
    different poses, 2 frames, against one instance at a time (1e-5;
    velocities 1e-4; measured 1.2e-7 / 6.5e-7), and one instance against
    the reference's `physics_react` on the same rig (1e-4)."""
    import jax.numpy as jnp

    from simple_mmd_renderer_tpu.config import PhysicsConfig
    from simple_mmd_renderer_tpu.core import pose as ref_pose
    from simple_mmd_renderer_tpu_torch.core import anim as anim_mod
    from simple_mmd_renderer_tpu_torch.core.physics import (PhysicsState,
                                                            PhysicsTables)

    ref, port = scenes
    ps_ref = _boxed_strict(ref.phys_static)
    ps = PhysicsTables(convert.physics_static(ps_ref), device="cpu")
    assert ps.has_box and ps.box_pairs.shape[0] and len(ps.strict_ids) > 1
    cfg = PhysicsConfig(solver_iterations=2)
    rig, n = port.rig, 3
    view, pview = rig.crowd(n), ps.crowd(n, rig.n_bones)

    def inputs(frames):
        rot, trans, rates = anim_mod.sample_motion(
            port.motion, torch.as_tensor(frames, dtype=torch.float32))
        return rot, trans, rates

    def flat(rot, trans, rates):
        return rot.reshape(-1, 4), trans.reshape(-1, 3), rates.reshape(-1)

    state = phys_mod.physics_reset(pview, pose_mod.pre_physics_posing(
        view, *flat(*inputs([0.0, 9.0, 21.0]))))
    singles = [PhysicsState(**{k: getattr(state, k).reshape(n, -1, getattr(
        state, k).shape[-1])[i] for k in convert.PHYSICS_LEAVES})
        for i in range(n)]
    worst = dict(x=0.0, v=0.0)
    for step in (1.0, 2.0):
        frames = [0.0 + step, 9.0 + step, 21.0 + step]
        state, pose = phys_mod.physics_react(
            view, pview, state, pose_mod.pre_physics_posing(
                view, *flat(*inputs(frames))), cfg)
        for i in range(n):
            singles[i], p1 = phys_mod.physics_react(
                rig, ps, singles[i],
                pose_mod.pre_physics_posing(rig, *inputs(frames[i])), cfg)
            for k in convert.PHYSICS_LEAVES:
                got = getattr(state, k).reshape(n, ps.n_bodies, -1)[i]
                d = float((got - getattr(singles[i], k)).abs().max())
                key = "v" if k in ("vel", "omega") else "x"
                worst[key] = max(worst[key], d)
            for f in ("skin", "world"):
                d = float((getattr(pose, f).reshape(n, -1, 4, 4)[i]
                           - getattr(p1, f)).abs().max())
                worst["x"] = max(worst["x"], d)
    assert worst["x"] <= 1e-5 and worst["v"] <= 1e-4, worst

    # one instance of the same rig against the reference (its posing
    # jitted once for both frames)
    ref_pre = jax.jit(lambda a, b, c: ref_pose.pre_physics_posing(
        ref.static, a, b, c))
    ref_p = ref_pre(*A.sample_motion(ref.motion, jnp.float32(0.0)))
    ref_state = PH.physics_reset(ps_ref, ref_p)
    ref_p = ref_pre(*A.sample_motion(ref.motion, jnp.float32(1.0)))
    ref_state, ref_out = jax.jit(lambda st, p: PH.physics_react(
        ref.static, ps_ref, st, p, cfg))(ref_state, ref_p)
    p0 = pose_mod.pre_physics_posing(rig, *inputs(0.0))
    p1 = pose_mod.PoseArrays(**{
        f: torch.as_tensor(np.array(getattr(ref_p, f)))
        for f in ("world", "skin", "total_rot", "total_trans", "pre_ik_rot",
                  "ik_rot", "vertex_offsets", "leaf_rates")})
    st, out = phys_mod.physics_react(rig, ps, phys_mod.physics_reset(ps, p0),
                                     p1, cfg)
    for k in convert.PHYSICS_LEAVES:
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(ref_state, k)),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(out.skin.numpy(), np.asarray(ref_out.skin),
                               atol=1e-4)
    np.testing.assert_allclose(out.world.numpy(), np.asarray(ref_out.world),
                               atol=1e-4)
