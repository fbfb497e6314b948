"""`Scene.seek`, `camera_override` and the crowd with VMD camera and light
tracks, the port against the reference (the tracks' own functions and the
single Scene's frames are in tests/test_torch_camera.py).

Configurations:
- seek: the sample character at density 0.25 on `sample_motion(60,
  fps_keys=10)`, physics on, 4 solver iterations; the reference's jitted
  `Scene.seek` at two times.
- the crowd and `camera_override`: the two-bone arm of
  tests/test_extended_morphs.py on the arm motion of
  tests/test_torch_morph_scene.py, 64x48, shadow 64^2, raster_mode="tiled"
  on the reference side, a 4-key camera track framing the arm (frames 0-20,
  key 2 orthographic) and a 3-key light track, the config's camera
  framing the arm too; crowds of 2 instances, clocks 7 frames apart.

Tolerances: the seek's physics leaves at 1e-4, the kinematic bodies on
IK-driven bones at the PARITY D1 level that ROADMAP §3 and
tests/test_torch_crowd_step.py state for clocks past frame 3 (1e-2
position, 2e-3 quaternion; measured at 0.5 s and 1.25 s: 7.2e-3 / 1.2e-3
and 3.7e-4 / 7.0e-5, the other bodies 1.9e-6); whole frames as everywhere (fewer than 2e-3
of the pixels off by more than 0.02, mean absolute difference below
1/255); the captured seek against the eager one, a scrub against a fresh
seek, and the fused crowd with and without a light track bit for bit.
"""

import numpy as np
import jax
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.app.sample import (sample_character,
                                                sample_motion)
from simple_mmd_renderer_tpu.config import AppConfig, RenderConfig
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.formats import vmd as ref_vmd
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu.render import camera_anim as ref_ca
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.parallel import mesh as par

from test_extended_morphs import _model_with_extended_morphs
from test_torch_camera import camera_track, light_track
from test_torch_morph_scene import _arm_vmd
from test_torch_slice import _ik_driven_bodies
from test_torch_textured_slice import _assert_frames_close

SW, SH = 64, 48


def _port(ref, camera=True, light=True):
    return Scene(convert.model_static(ref.static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(ref.motion),
                 convert.app_config(ref.config), device="cpu",
                 camera=(convert.camera_arrays(ref.camera, "cpu")
                         if camera and ref.camera is not None else None),
                 light=(convert.light_arrays(ref.light, "cpu")
                        if light and ref.light is not None else None))


@pytest.fixture(scope="module")
def seek_scenes():
    static = ref_model.build_model(sample_character(density=0.25))
    cfg = AppConfig()
    cfg.render = RenderConfig(width=SW, height=SH, shadow_map_size=64,
                              show_skybox=False, raster_mode="tiled")
    cfg.physics.solver_iterations = 4
    ref = RefScene(static, ref_physics.build_physics(static),
                   ref_anim.bind_motion(static,
                                        sample_motion(60, fps_keys=10)), cfg)
    return ref, _port(ref)


def test_seek_matches_reference(seek_scenes):
    """The seek at two times against the reference's: the clock exactly,
    the re-seeded bodies within the tolerances above, velocities zero; the
    captured form (the fixed, masked CCD count) equals the eager one bit
    for bit, and the scene keeps one captured seek."""
    ref, port = seek_scenes
    ik = _ik_driven_bodies(ref.static, ref.phys_static)
    assert 0 < ik.sum() < ref.phys_static.n_bodies
    state = port.init_state()
    graphs = set()
    for t in (0.5, 1.25):
        want = ref.seek(ref.init_state(), t)
        got = port.seek(state, t)
        graphs.add(id(port._seek))
        if t == 0.5:
            eager = port.seek(state, t, compiled=False)
            for a, b in zip((got.time, *vars(got.physics).values()),
                            (eager.time, *vars(eager.physics).values())):
                assert torch.equal(a, b)
        out = convert.sim_state_to_numpy(got)
        assert out["time"] == np.asarray(want.time)
        for k in convert.PHYSICS_LEAVES:
            g, w = out[k], np.asarray(getattr(want.physics, k))
            np.testing.assert_allclose(g[~ik], w[~ik], atol=1e-4,
                                       err_msg=f"{t} {k}")
            np.testing.assert_allclose(
                g[ik], w[ik], err_msg=f"{t} {k} (IK)",
                atol={"pos": 1e-2, "quat": 2e-3}.get(k, 1e-4))
        assert not out["vel"].any() and not out["omega"].any()
    assert len(graphs) == 1 and port._seek is not None


def test_seek_after_playback_equals_fresh_seek(seek_scenes):
    """A scrub discards in-flight dynamics: seeking after 6 compiled frames
    equals seeking from a fresh state, bit for bit, and so do 2 frames
    stepped from each; `.to()` drops the captured seek."""
    _, port = seek_scenes
    step = port.jit_step(render=False, donate=False)
    s = port.init_state()
    for _ in range(6):
        s = step(s)[0]
    scrubbed = port.seek(s, 0.1)
    fresh = port.seek(port.init_state(), 0.1)
    a, b = scrubbed, fresh
    for _ in range(3):
        for x, y in zip((a.time, *vars(a.physics).values()),
                        (b.time, *vars(b.physics).values())):
            assert torch.equal(x, y)
        a, b = step(a)[0], step(b)[0]
    # moving the scene drops its captured seek with its step graphs
    assert port._seek is not None
    port.to("cpu")
    assert port._seek is None and not port._graphs


def _arm_scene(camera=True, light=True):
    pm, static = _model_with_extended_morphs()
    motion = ref_vmd.parse_vmd(_arm_vmd())
    motion.camera = camera_track((0, 6, 12, 20), ortho_key=2, seed=5,
                                 target=(1.0, 0.5, 0.0), distance=-5.0)
    motion.light = light_track((0, 6, 12))
    cfg = AppConfig()
    cfg.render = RenderConfig(
        width=SW, height=SH, shadow_map_size=64, show_skybox=False,
        raster_mode="tiled",
        camera_pos=np.array([0.1, 0.05, -0.5], np.float32),
        camera_target=np.array([0.1, 0.05, 0.0], np.float32))
    return RefScene(static, ref_physics.build_physics(static),
                    ref_anim.bind_motion(static, motion), cfg,
                    camera=ref_ca.bind_camera(motion.camera) if camera
                    else None,
                    light=ref_ca.bind_light(motion.light) if light else None)


@pytest.fixture(scope="module")
def arm_scenes():
    return _arm_scene(), _arm_scene(camera=False)


def test_camera_override_matches_reference(arm_scenes):
    """`camera_override` (eye, target, fov in metres) takes the camera
    track's place, the light track still applies: against the reference's
    frame; equal between step_and_render and jit_step."""
    ref, _ = arm_scenes
    port = _port(ref)
    override = (np.array([0.15, 0.12, -0.45], np.float32),
                np.array([0.1, 0.05, 0.0], np.float32), np.float32(40.0))
    ref_state = ref.init_state()
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    _, want = jax.jit(lambda s, e, t, f: ref.step_and_render(
        s, camera_override=(e, t, f)))(ref_state, *override)
    _, got = port.step_and_render(state, camera_override=override)
    _assert_frames_close(got[None].numpy(), np.asarray(want)[None],
                         "camera_override")
    _, track = port.step_and_render(state)
    assert float((got - track).abs().max()) > 0.1
    _, jit = port.jit_step(donate=False)(state, camera_override=override)
    assert torch.equal(got, jit)


def test_crowd_with_camera_track_falls_back_like_the_reference(arm_scenes,
                                                                capsys):
    """With a camera track the crowd renders instance by instance, each
    with its own clock's camera and light samples: 2 frames of a crowd of
    2 against the reference's vmap(step_and_render); the notice names
    vmd_camera; instance i equals the single Scene stepped on its clock."""
    ref, _ = arm_scenes
    port = _port(ref)
    step = par.crowd_step_fn(port)
    assert "vmd_camera" in capsys.readouterr().err
    ref_state = ref_par.crowd_init(ref, 2)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    ref_step = jax.jit(ref_par.crowd_step_fn(ref))
    for frame in range(2):
        ref_state, want = ref_step(ref_state)
        state, got = step(state)
        _assert_frames_close(got.numpy(), np.asarray(want), f"frame {frame}")
    assert float((got[0] - got[1]).abs().max()) > 0.1
    single = convert.sim_state_to_torch(
        jax.tree.map(lambda x: x[1], ref_par.crowd_init(ref, 2)), "cpu")
    for _ in range(2):
        single, img = port.step_and_render(single)
    assert torch.equal(img, got[1])


def test_fused_crowd_ignores_the_light_track_like_the_reference(arm_scenes):
    """Without a camera track the crowd stays on the fused frame, which
    (as the reference's) passes the scene's render config as it is: a
    light track changes the single frame but not the fused crowd's, which
    equals the crowd's without the track bit for bit, and the reference's
    within the whole-frame tolerance."""
    _, ref = arm_scenes
    lit, unlit = _port(ref), _port(ref, light=False)
    ref_state = ref_par.crowd_init(ref, 2)
    _, want = jax.jit(ref_par.crowd_step_fn(ref))(ref_state)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    _, got = par.crowd_step_fn(lit)(state)
    _, plain = par.crowd_step_fn(unlit)(state)
    assert torch.equal(got, plain)
    _assert_frames_close(got.numpy(), np.asarray(want), "fused, light")
    single = convert.sim_state_to_torch(ref.init_state(), device="cpu")
    _, a = lit.step_and_render(single)
    _, b = unlit.step_and_render(single)
    assert float((a - b).abs().max()) > 0.02
