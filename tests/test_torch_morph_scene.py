"""The Scene and the crowd step with the extended morphs and true SDEF,
the port against the reference: `Scene.step_and_render` (and the compiled
entry points `jit_step`, `rollout`, `jit_rollout`) and
`parallel.mesh.crowd_step_fn` with `AppConfig.apply_extended_morphs` and
`sdef_true` on (the frames' own functions are in
tests/test_torch_morph_frames.py).

Configuration (raster_mode="tiled" on the reference side): the two-bone
arm with the UV and material morphs of tests/test_extended_morphs.py (one
part, textured `sample_textures((16,))`, its SDEF vertex), a VMD that
bends the arm and keys the three morphs up from 0 at frame 0, 64x48,
shadow 64^2, the camera framing the arm; the crowd: 3 instances, clocks 7
frames apart.

Whole frames are held at the tolerance in use: fewer than 2e-3 of the
pixels off by more than 0.02 and a mean absolute difference below 1/255,
per instance. Measured: no pixel beyond 0.02, the largest difference
1.1e-6 (mean at most 6.2e-9).
"""

import copy
import dataclasses

import numpy as np
import jax
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.app.sample import sample_textures
from simple_mmd_renderer_tpu.config import AppConfig, RenderConfig
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.formats import vmd as ref_vmd
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.formats.writers import write_vmd
from simple_mmd_renderer_tpu_torch.parallel import mesh as par

from test_extended_morphs import _model_with_extended_morphs
from test_torch_textured_slice import _assert_frames_close

SW, SH = 64, 48
MORPHS = ("UV", "暗く", "緑")


def _arm_vmd() -> bytes:
    """The arm bends about z while the three extended morphs rise from 0
    (frame 0) to 1 (frame 8) and fall back by frame 16."""
    lin = np.array([[20, 20, 107, 107]] * 4, np.int8)
    keys, morphs = [], []
    for f in range(0, 17, 2):
        ang = 0.6 * np.sin(f / 5.0)
        keys.append(("腕", f, np.zeros(3, np.float32),
                     np.array([0, 0, np.sin(ang / 2), np.cos(ang / 2)],
                              np.float32), lin))
        for k, name in enumerate(MORPHS):
            morphs.append((name, f, float(np.sin(np.pi * f / 16)
                                          ** (1 + k))))
    return write_vmd("arm", keys, morphs)


@pytest.fixture(scope="module")
def scenes():
    """(reference Scene, port Scene) of the arm with extended morphs, both
    flags on."""
    pm, _ = _model_with_extended_morphs()
    static = ref_model.build_model(pm)
    cfg = AppConfig(sdef_true=True, apply_extended_morphs=True)
    cfg.render = RenderConfig(
        width=SW, height=SH, shadow_map_size=64, show_skybox=False,
        raster_mode="tiled",
        camera_pos=np.array([0.1, 0.05, -0.5], np.float32),
        camera_target=np.array([0.1, 0.05, 0.0], np.float32))
    motion = ref_anim.bind_motion(static, ref_vmd.parse_vmd(_arm_vmd()))
    ref = RefScene(static, ref_physics.build_physics(static), motion, cfg,
                   part_textures=sample_textures((16,)))
    port = Scene(convert.model_static(static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(motion), convert.app_config(cfg),
                 part_textures=list(ref.part_textures), device="cpu")
    return ref, port


def _with_config(scene, render=None, **app):
    """A shallow copy of `scene` (the same tables and step) whose AppConfig
    differs in `app` and, where given, in its render config."""
    other = copy.copy(scene)
    other.config = dataclasses.replace(
        scene.config, **app, render=render or scene.config.render)
    return other


def test_scene_applies_extended_morphs_like_the_reference(scenes):
    """Three frames of `step_and_render` against the reference's jitted
    step; the flag off gives another frame wherever a material morph's rate
    is above 0 (the flag was ignored before the morphs were ported); the
    compiled entry points give the eager frames."""
    ref, port = scenes
    ref_state = ref.init_state()
    state0 = convert.sim_state_to_torch(ref_state, device="cpu")
    step = jax.jit(ref.step_and_render)
    off = _with_config(port, apply_extended_morphs=False)
    state, images = state0, []
    for frame in range(3):
        ref_state, want = step(ref_state)
        _, plain = off.step_and_render(state)
        state, img = port.step_and_render(state)
        _assert_frames_close(img[None].numpy(), np.asarray(want)[None],
                             f"frame {frame}")
        images.append(img)
        moved = float((img - plain).abs().max())
        assert moved > 0.05, (frame, moved)
    jit = port.jit_step(donate=False)
    state = state0
    for img in images:
        state, got = jit(state)
        assert torch.equal(got, img)
    sums = torch.stack([img.mean() for img in images])
    assert torch.equal(port.rollout(state0, 3)[1], sums)
    assert torch.equal(port.jit_rollout(3)(state0)[1], sums)


def test_crowd_step_applies_extended_morphs_like_the_reference(scenes):
    """`crowd_step_fn` (the fused frame, each instance at its own rates)
    against the reference's for 3 instances, 2 frames; the supersampled
    MSAA's instance-by-instance fallback applies them too."""
    ref, port = scenes
    ref_state = ref_par.crowd_init(ref, 3)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    ref_step = jax.jit(ref_par.crowd_step_fn(ref))
    step = par.crowd_step_fn(port)
    plain = par.crowd_step_fn(_with_config(port, apply_extended_morphs=False))
    for frame in range(2):
        ref_state, want = ref_step(ref_state)
        _, flat = plain(state)
        state, got = step(state)
        _assert_frames_close(got.numpy(), np.asarray(want),
                             f"crowd frame {frame}")
        assert float((got - flat).abs().max()) > 0.05
    cfg = dataclasses.replace(port.config.render, msaa=4,
                              msaa_supersample=True)
    on, off = (par.crowd_step_fn(_with_config(
        port, cfg, apply_extended_morphs=flag))(state)[1]
        for flag in (True, False))
    assert on.shape == (3, SH, SW, 3)
    assert float((on - off).abs().max()) > 0.05
