"""The "wild" asset against the port: tests/wild_assets.py's PMX (120
materials, a 30-bone chain under an 8-link IK with a loop count of 255, a
second IK chain that shares 6 of its bones, 90 bones with every optional
block, 48 box, capsule and sphere bodies of every kind, ghost and strict
included, and 40 joints) and its VMD (keys out of order, junk after the
names' NUL, frames past 100,000).

- Both packages build it: the port's own reader and builders (`parse_pmx`,
  `parse_vmd`, `build_model`, `build_physics`, `bind_motion`) give the
  reference's objects, as `convert` carries them, field by field.
- The scene (96x72, shadow 64^2, no skybox, 2 solver iterations) steps 3
  frames in both packages through tests/test_torch_slice.py's
  `slice_frames` / `check_slice`, each frame rendered by the scan raster
  and by the tiled raster.
- Stage by stage: on each of frames 1-3, each stage of the port's step
  (`Scene._sample_anim`, `pre_physics_posing`, `physics_react`,
  `post_physics_posing`, `deform`) starts from the reference's input to
  that stage, converted with `convert`, and is held against the jitted
  reference's output.

The reference is stepped once for the module (`wild`): its stages jitted
one by one (`pre_physics_posing` once, also for the initial state's
neutral pose, which `init_state` would compile a second time), their
outputs kept a frame. On this scene the initial state equals
`init_state()`'s and the staged outputs equal those of
`jax.jit(Scene.step_pose)`, bit for bit (states and deformed vertices,
frames 1-3, CPU). The port's own
three-frame run records its `pre_physics_posing` calls: where a call's
inputs equal the reference's sampled animation bit for bit (frames 1 and
2), the pose stage's case reads that call's output instead of posing again
(the CCD loop's 255 iterations take ~11 s a frame on the CPU).

Tolerances (port vs the jitted reference), each beside its measured value
(this file's configuration, CPU) and the reference's own eager-vs-jit gap
at that stage, frames 1 / 2 / 3:
- anim (STAGE_ATOL["anim"]): the rotations at 1e-9, measured 0 / 0 /
  2.3e-10 (a last bit of a component near 0; the reference's eager run
  differs from its jitted one by the same 2.3e-10); translations and morph
  rates equal.
- pre_physics: `ik_rot` and `total_rot` at 1e-5, measured 3.4e-6 / 2.7e-6
  / 2.3e-6, on the CCD chain's bones (22-27) and, in `total_rot`, bone 85
  below them (eager-vs-jit 0 / 6.0e-8 / 0). `world` and `skin` per bone at
  1e-4 of the bone's distance from the origin (its world translation, at
  least 1): measured 5.7e-5 of it at most (frame 2), at most 1.7e-4
  absolute (bone 58, a misc bone hung under the chain, ~4 units out;
  eager-vs-jit 2.4e-7 absolute). The other fields equal (0), held at 1e-6.
- physics, from the reference's pose and physics state, every body
  (IK-driven or not): pos and quat at 1e-4, compare_slice's BODY_ATOL,
  measured pos 3.5e-6 / 2.4e-7 / 4.8e-7 (eager-vs-jit 3.2e-6 / 4.8e-7 /
  2.4e-7), quat 1.6e-6 / 1.3e-6 / 2.2e-7 (1.6e-6 / 1.1e-6 / 2.3e-7); vel
  and omega at 6e-4, about twice the measured vel 2.7e-4 / 1.4e-5 /
  4.9e-5 (2.7e-4 / 2.9e-5 / 4.9e-5) and omega 2.6e-4 / 1.2e-4 / 2.7e-5
  (2.6e-4 / 1.1e-4 / 2.8e-5): the port sits at the reference's own gap.
  The pose it writes back: `skin` at 5e-5, measured 1.8e-5 / 1.2e-5 /
  3.6e-6 (1.7e-5 / 1.1e-5 / 3.8e-6), the rest at 1e-6 (1.8e-7 at most).
- post_physics, from the reference's physics pose: every field at 1e-6,
  measured 4.8e-7 at most (`skin`; eager-vs-jit 2.4e-7).
- deform, from the reference's final pose: positions at 5e-6, measured
  1.9e-6 / 9.5e-7 / 1.9e-6; normals at 5e-7, measured 1.2e-7 (eager-vs-jit
  0 for both).

So the step's gap starts in the CCD chain's rotations, at ~3e-6 rad: the
port's `acos` of a dot product near 1 differs in a last bit, as the
reference's own runs do on the sample rig (PARITY D1). Physics adds no
more than the reference's own eager-vs-jit gap; it is the joints that grow
the pose's gap, over the frame's substeps, into the whole step's (below).

The whole step, port vs the jitted reference, each stepping its own
state (`test_wild_asset_slice_matches_reference_three_frames`):
- images, as compare_slice: fewer than 2e-3 of the pixels off by more
  than 0.02 and a mean absolute difference below 1/255. Measured: no
  pixel beyond 0.02, mean at most 8.7e-7 (scan and tiled).
- kinematic bodies on IK-driven bones: held at 1e-4, tighter than
  compare_slice's IK_ATOL. Measured: 1.2e-5 (quat), 6.2e-6 (pos).
- the other bodies: held at pos 2e-3, quat 5e-3, vel 6e-2 and omega 0.2,
  about twice the measured pos 8.9e-4, quat 2.7e-3, vel 3.7e-2 and omega
  0.100 (frame 3; frame 1: pos 3.2e-4, vel 3.7e-2). The largest sit on
  bodies 23 and 27, the dynamic bodies of the chain's link bones 24 and
  28: the ~3e-6 rad of the CCD rotations above, through the chain's joints,
  moves their position corrections, and each correction over the 1/60 s
  substep moves their velocity. The box bodies, strict and ghost, differ by
  at most 2.3e-5, the kinematic bodies that are not IK-driven by 2.3e-10.
  The reference's own eager run differs from its jitted run less on this
  scene (at most pos 1.0e-5, quat 3.4e-5, vel 4.0e-4, omega 2.7e-3 over
  frames 1-3): its eager CCD equals its jitted CCD, so nothing amplifies.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.config import AppConfig, RenderConfig
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core import pose as ref_pose
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.core.scene import SimState as RefSimState
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.formats import vmd as ref_vmd
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core import anim, model, physics, pose
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.formats import pmx, vmd

from test_torch_builders import _assert_same
from test_torch_slice import check_slice, slice_frames
from wild_assets import (N_BONES, N_JOINTS, N_MATS, N_RIGID, build_wild_pmx,
                         build_wild_vmd)

import torch_threads  # noqa: F401  (the port's tests' thread cap)

BODY_ATOL = {"pos": 2e-3, "quat": 5e-3, "vel": 6e-2, "omega": 0.2}
IK_ATOL = {"pos": 1e-4, "quat": 1e-4}
FRAMES = 3
RENDERS = {mode: dict(raster_mode=mode) for mode in ("scan", "tiled")}

# the stages' tolerances (see the module docstring for the measured values)
ANIM_ROT_ATOL = 1e-9
CCD_ROT_ATOL = 1e-5          # pre_physics: ik_rot, total_rot
WORLD_RTOL = 1e-4            # pre_physics: world, skin, per bone distance
STATE_ATOL = {"pos": 1e-4, "quat": 1e-4, "vel": 6e-4, "omega": 6e-4}
REACT_SKIN_ATOL = 5e-5
POSE_ATOL = 1e-6             # the pose fields not named above
POSITION_ATOL, NORMAL_ATOL = 5e-6, 5e-7
POSE_FIELDS = [f.name for f in dataclasses.fields(pose.PoseArrays)]


def _reference():
    pm = ref_pmx.parse_pmx(build_wild_pmx())
    static = ref_model.build_model(pm)
    return (pm, static, ref_physics.build_physics(static),
            ref_anim.bind_motion(static, ref_vmd.parse_vmd(build_wild_vmd())))


def _ref_scene():
    _, static, phys, motion = _reference()
    cfg = AppConfig()
    cfg.render = RenderConfig(width=96, height=72, shadow_map_size=64,
                              show_skybox=False, raster_mode="scan")
    cfg.physics.solver_iterations = 2
    return RefScene(static, phys, motion, cfg)


def _reference_stages(ref):
    """The reference stepped FRAMES frames from its initial state, each
    stage jitted alone -> (initial state, [{stage: its inputs and
    outputs}], [(state', pose, positions, normals)] a frame)."""
    static, ps, cfg = ref.static, ref.phys_static, ref.config
    sample = jax.jit(ref._sample_anim)
    pre = jax.jit(lambda r, t, m: ref_pose.pre_physics_posing(static, r, t,
                                                              m))
    react = jax.jit(lambda st, p: ref_physics.physics_react(
        static, ps, st, p, cfg.physics))

    @jax.jit
    def post_deform(p, r, t, m):
        p = ref_pose.post_physics_posing(static, p, r, t, m)
        return p, ref_pose.deform(static, p, sdef=cfg.sdef_true)

    b = static.n_bones
    neutral = (jnp.broadcast_to(jnp.asarray([0, 0, 0, 1.0], jnp.float32),
                                (b, 4)),
               jnp.zeros((b, 3), jnp.float32),
               jnp.zeros((static.n_morphs,), jnp.float32))
    state = RefSimState(time=jnp.float32(0.0), physics=jax.jit(
        lambda p: ref_physics.physics_reset(ps, p))(pre(*neutral)))
    state0, stages, steps = state, [], []
    for _ in range(FRAMES):
        t = state.time + jnp.float32(1.0 / cfg.fps)
        a = sample(t)
        p_pre = pre(*a)
        phys, p_react = react(state.physics, p_pre)
        p_post, (positions, normals) = post_deform(p_react, *a)
        stages.append(dict(time=t, anim=a, pre_physics=p_pre,
                           physics_in=state.physics, physics=phys,
                           react_pose=p_react, post_physics=p_post,
                           deform=(positions, normals)))
        state = RefSimState(time=t, physics=phys)
        steps.append((state, p_post, positions, normals))
    return state0, stages, steps


@pytest.fixture(scope="module")
def wild():
    """The reference scene stepped stage by stage (`_reference_stages`),
    the port's three-frame run against it (`slice_frames`, its
    `pre_physics_posing` calls recorded with their inputs) and a port scene
    for the stage cases."""
    ref = _ref_scene()
    state0, stages, steps = _reference_stages(ref)
    calls, real = [], pose.pre_physics_posing

    def recorded(static, *args, **kw):
        out = real(static, *args, **kw)
        calls.append((args, out))
        return out

    pose.pre_physics_posing = recorded
    try:
        frames = slice_frames(ref, FRAMES, RENDERS, ref_run=(state0, steps))
    finally:
        pose.pre_physics_posing = real
    assert len(calls) == FRAMES
    port = Scene(convert.model_static(ref.static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(ref.motion),
                 convert.app_config(ref.config), device="cpu")
    return dict(ref=ref, stages=stages, frames=frames, pre_calls=calls,
                port=port)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def _check_pose(got, want, what, atol):
    """Every pose field within its `atol` entry (POSE_ATOL otherwise)."""
    for f in POSE_FIELDS:
        _close(getattr(got, f), getattr(want, f), atol.get(f, POSE_ATOL),
               f"{what} {f}")


def _check_anim(wild, st, frame):
    rot, trans, rates = wild["port"]._sample_anim(_t(st["time"]))
    ref_rot, ref_trans, ref_rates = st["anim"]
    _close(rot, ref_rot, ANIM_ROT_ATOL, f"frame {frame} anim rot")
    np.testing.assert_array_equal(trans.numpy(), np.asarray(ref_trans))
    np.testing.assert_array_equal(rates.numpy(), np.asarray(ref_rates))


def _check_pre_physics(wild, st, frame):
    args = tuple(_t(x) for x in st["anim"])
    seen_args, got = wild["pre_calls"][frame - 1]
    if not all(torch.equal(a, b) for a, b in zip(seen_args, args)):
        got = pose.pre_physics_posing(wild["port"].rig, *args)
    want = st["pre_physics"]
    _check_pose(got, want, f"frame {frame} pre_physics",
                {"ik_rot": CCD_ROT_ATOL, "total_rot": CCD_ROT_ATOL,
                 "world": np.inf, "skin": np.inf})
    reach = np.maximum(1.0, np.linalg.norm(np.asarray(want.world)[:, :3, 3],
                                           axis=-1))
    for f in ("world", "skin"):
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f)))
        rel = d.reshape(d.shape[0], -1).max(1) / reach
        assert rel.max() <= WORLD_RTOL, (
            f"frame {frame} pre_physics {f}: bone {int(rel.argmax())} off "
            f"by {rel.max():.3g} of its distance")


def _check_physics(wild, st, frame):
    port = wild["port"]
    state, got = physics.physics_react(
        port.rig, port.phys, convert.physics_state(st["physics_in"], "cpu"),
        convert.pose_arrays(st["pre_physics"], "cpu"), port.config.physics)
    for k in convert.PHYSICS_LEAVES:
        _close(getattr(state, k), getattr(st["physics"], k), STATE_ATOL[k],
               f"frame {frame} physics {k}")
    _check_pose(got, st["react_pose"], f"frame {frame} physics pose",
                {"skin": REACT_SKIN_ATOL})


def _check_post_physics(wild, st, frame):
    got = pose.post_physics_posing(
        wild["port"].rig, convert.pose_arrays(st["react_pose"], "cpu"),
        *(_t(x) for x in st["anim"]))
    _check_pose(got, st["post_physics"], f"frame {frame} post_physics", {})


def _check_deform(wild, st, frame):
    port = wild["port"]
    positions, normals = pose.deform(
        port.rig, convert.pose_arrays(st["post_physics"], "cpu"),
        sdef=port.config.sdef_true)
    _close(positions, st["deform"][0], POSITION_ATOL,
           f"frame {frame} positions")
    _close(normals, st["deform"][1], NORMAL_ATOL, f"frame {frame} normals")


STAGES = {"anim": _check_anim, "pre_physics": _check_pre_physics,
          "physics": _check_physics, "post_physics": _check_post_physics,
          "deform": _check_deform}


def test_wild_asset_builds_the_same_in_both_packages():
    pm, static, phys, motion = _reference()
    assert (len(pm.materials), len(pm.bones), len(pm.rigid_bodies),
            len(pm.constraints)) == (N_MATS, N_BONES, N_RIGID, N_JOINTS)
    port_pm = pmx.parse_pmx(build_wild_pmx())
    _assert_same(port_pm, pm)
    port_static = model.build_model(port_pm)
    _assert_same(port_static, convert.model_static(static))
    _assert_same(physics.build_physics(port_static),
                 convert.physics_static(phys))
    _assert_same(anim.bind_motion(port_static,
                                  vmd.parse_vmd(build_wild_vmd())),
                 convert.motion_arrays(motion))


def test_wild_asset_slice_matches_reference_three_frames(wild):
    kinds = np.asarray(wild["ref"].phys_static.kinematic)
    assert 0 < kinds.sum() < wild["ref"].phys_static.n_bodies
    check_slice(wild["frames"], body_atol=BODY_ATOL, ik_atol=IK_ATOL)


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
@pytest.mark.parametrize("stage", list(STAGES))
def test_wild_asset_stage_matches_reference(wild, stage, frame):
    """One stage of the port's step on frame `frame`, from the reference's
    input to it, against the jitted reference's output (module docstring:
    the tolerances beside their measured values)."""
    STAGES[stage](wild, wild["stages"][frame - 1], frame)
