"""VMD camera and light tracks, the orthographic camera, `model_mat` and
`proj_transform`, the port against the reference: `render.camera_anim`
(bind and sample), `render.pipeline.build_matrices` and `render_frame`,
and the Scene's entry points with the tracks (`step_and_render`,
`jit_step`, `rollout`). `camera_override`, `Scene.seek` and the crowd
with tracks are in tests/test_torch_camera_crowd.py.

Configuration: a 4-key camera track (the MMD default curve on the first
and last keys, random Bezier bytes between, an orthographic key) and a
3-key light track (one key's direction zero: the (0, -1, 0) fall-back),
sampled before, on, between and after the keys; frames of the sample
character at density 0.25 (1,352 vertices, 1,912 triangles), 64x48,
shadow 64^2, raster_mode="tiled" on the reference side; the Scene on
`sample_motion(30, fps_keys=10)` with physics off and both tracks keyed
over its first 8 frames (frame 4 on the orthographic key).

Tolerances: track samples and matrices within 1e-6 (measured: at most
4.8e-7 relative on the eye, 0 on the LUTs); whole frames as everywhere
(fewer than 2e-3 of the pixels off by more than 0.02, mean absolute
difference below 1/255; measured: no pixel beyond 0.02); the compiled
entry points equal the eager frames bit for bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
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
from simple_mmd_renderer_tpu.formats.vmd import CameraTrack, LightTrack
from simple_mmd_renderer_tpu.parallel.mesh import band_transform
from simple_mmd_renderer_tpu.render import camera_anim as ref_ca
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import config, convert
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.formats import vmd as port_vmd
from simple_mmd_renderer_tpu_torch.render import camera_anim as ca
from simple_mmd_renderer_tpu_torch.render import pipeline

from test_torch_textured_slice import _assert_frames_close

W, H = 64, 48
DEFAULT_CURVE = np.tile(np.array([20, 107, 20, 107], np.int8), 6)
FRAMES = np.array([-3, 0, 4, 4.5, 10, 17.3, 25, 30, 39.9, 40, 55],
                  np.float32)


def camera_track(frames=(0, 10, 25, 40), ortho_key=2, seed=0,
                 target=(0.0, 10.0, 0.0), distance=-40.0) -> CameraTrack:
    """A camera track: the default curve on the first and last keys,
    random Bezier bytes between, key `ortho_key` orthographic."""
    rng = np.random.default_rng(seed)
    k = len(frames)
    interp = np.tile(DEFAULT_CURVE, (k, 1))
    interp[1:-1] = rng.integers(0, 128, (max(k - 2, 0), 24))
    ortho = np.zeros(k, bool)
    ortho[ortho_key] = True
    return CameraTrack(
        frames=np.array(frames, np.int64),
        focal_lengths=(distance + rng.uniform(-8, 8, k)).astype(np.float32),
        positions=(np.array(target) + rng.uniform(-2, 2, (k, 3))).astype(
            np.float32),
        rotations=np.stack([rng.uniform(-0.3, 0.3, k),
                            rng.uniform(-1.2, 1.2, k),
                            rng.uniform(-0.1, 0.1, k)], -1).astype(np.float32),
        fovs=rng.uniform(25, 45, k).astype(np.float32),
        orthographic=ortho, interp=interp)


def light_track(frames=(0, 12, 30)) -> LightTrack:
    """Three keys, the second with a zero direction (the fall-back)."""
    colors = np.array([[1.0, 0.4, 0.3], [0.3, 0.6, 1.0], [0.9, 0.9, 0.2]],
                      np.float32)[:len(frames)]
    directions = np.array([[-0.5, -1.0, 0.3], [0.0, 0.0, 0.0],
                           [0.6, -0.8, -0.4]], np.float32)[:len(frames)]
    return LightTrack(frames=np.array(frames, np.int64), colors=colors,
                      directions=directions)


def _port_track(track):
    """The reference's track as the port's dataclass of the same name."""
    cls = getattr(port_vmd, type(track).__name__)
    return cls(**{f.name: getattr(track, f.name)
                  for f in dataclasses.fields(track)})


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("frames", [(0, 10, 25, 40), (7,)],
                         ids=["four-keys", "one-key"])
def test_sample_camera_matches_reference(frames):
    track = camera_track(frames, ortho_key=min(2, len(frames) - 1))
    ref = ref_ca.bind_camera(track)
    port = ca.bind_camera(_port_track(track), device="cpu")
    # the LUTs are the same host presample, bit for bit
    np.testing.assert_array_equal(port.luts.numpy(), np.asarray(ref.luts))
    conv = convert.camera_arrays(ref, device="cpu")
    for name, buf in port.named_buffers():
        assert torch.equal(buf, getattr(conv, name)), name
    got = ca.sample_camera(port, torch.as_tensor(FRAMES))
    ref_sample = jax.jit(ref_ca.sample_camera)
    for i, f in enumerate(FRAMES):
        want = ref_sample(ref, f)
        for key in ("eye", "target", "fov_deg"):
            _close(got[key][i], want[key], f"{key} at frame {f}")
        assert bool(got["ortho"][i]) == bool(want["ortho"]), f
    one = ca.sample_camera(port, torch.tensor(17.3))
    assert one["eye"].shape == (3,) and one["ortho"].shape == ()
    assert torch.equal(one["eye"], got["eye"][5])
    if len(frames) > 1:
        assert got["ortho"].any() and not got["ortho"].all()


def test_default_camera_curve_is_the_identity_ramp():
    """MMD's default camera bytes (20, 107, 20, 107) per channel are
    (c0.x, c1.x, c0.y, c1.y): they presample to the linear ramp."""
    track = camera_track()
    track.interp = np.tile(DEFAULT_CURVE, (4, 1))
    cam = ca.bind_camera(_port_track(track), device="cpu")
    ramp = torch.arange(32, dtype=torch.float32) / 31.0
    assert torch.equal(cam.luts, ramp.expand(4, 6, 32))


def test_sample_light_matches_reference():
    track = light_track()
    ref = ref_ca.bind_light(track)
    port = ca.bind_light(_port_track(track), device="cpu")
    conv = convert.light_arrays(ref, device="cpu")
    for name, buf in port.named_buffers():
        assert torch.equal(buf, getattr(conv, name)), name
    frames = np.array([-2, 0, 5, 12, 12.5, 20, 30, 44], np.float32)
    got = ca.sample_light(port, torch.as_tensor(frames))
    ref_sample = jax.jit(ref_ca.sample_light)
    for i, f in enumerate(frames):
        want = ref_sample(ref, f)
        _close(got["color"][i], want["color"], f"color at {f}")
        _close(got["direction"][i], want["direction"], f"direction at {f}")
    # on the zero-direction key the direction falls back to straight down
    assert got["direction"][3].tolist() == [0.0, -1.0, 0.0]


def _cfgs(**kw):
    ref = RenderConfig(width=W, height=H, **kw)
    return ref, convert.app_config(AppConfig(render=ref)).render


@pytest.mark.parametrize("case", ["perspective", "ortho-bool",
                                  "ortho-numpy-false", "ortho-tensor",
                                  "model_mat", "band"])
def test_build_matrices_matches_reference(case):
    ref_cfg, cfg = _cfgs(camera_fov_deg=35.0)
    model_mat = aspect = transform = None
    if case == "ortho-bool":
        ref_cfg.camera_orthographic = cfg.camera_orthographic = True
    elif case == "ortho-numpy-false":
        ref_cfg.camera_orthographic = cfg.camera_orthographic = np.False_
    elif case == "ortho-tensor":
        ref_cfg.camera_orthographic = jnp.asarray(True)
        cfg = dataclasses.replace(cfg, camera_orthographic=torch.tensor(True),
                                  camera_fov_deg=torch.tensor(35.0),
                                  camera_pos=torch.as_tensor(cfg.camera_pos))
    elif case == "model_mat":
        model_mat = np.eye(4, dtype=np.float32)
        model_mat[:3, :3] = [[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1.2]]
        model_mat[:3, 3] = [0.3, 0.1, -0.2]
    elif case == "band":
        transform, aspect = np.asarray(band_transform(3, 1)), 1.5
    want = ref_pipeline.build_matrices(ref_cfg, model_mat, aspect, transform)
    got = pipeline.build_matrices(cfg, model_mat, aspect, transform,
                                  device="cpu")
    for key in ("view", "proj", "mvp", "light_mvp", "light_vp"):
        _close(got[key], want[key], key)
    if case in ("ortho-bool", "ortho-tensor"):
        assert float(got["proj"][3, 3]) == 1.0     # affine: w = 1


@pytest.fixture(scope="module")
def posed():
    """(reference ModelStatic, port tables, positions, normals) of the
    sample character at density 0.25, at rest."""
    from simple_mmd_renderer_tpu_torch.core.model import ModelTables

    static = ref_model.build_model(sample_character(density=0.25))
    rig = ModelTables(convert.model_static(static), "cpu")
    return (static, rig, np.asarray(static.positions),
            np.asarray(static.normals))


MODEL_MAT = np.array([[0.8, 0, 0.6, 0.2], [0, 1, 0, 0.05],
                      [-0.6, 0, 0.8, -0.1], [0, 0, 0, 1]], np.float32)


def test_render_frame_model_band_and_ortho_match_reference(posed):
    """render_frame with `model_mat`, the middle band of a 3-band split
    (`proj_transform` with the full frame's aspect), and orthographic (at
    msaa=1 and 4): one reference jit of the four, the whole-frame
    tolerance each; the bands stacked equal the full frame."""
    static, rig, pos, nrm = posed
    ref_cfg, cfg = _cfgs(shadow_map_size=64, show_skybox=False,
                         raster_mode="tiled")
    ortho_ref = dataclasses.replace(ref_cfg, camera_orthographic=True)
    ortho4_ref = dataclasses.replace(ortho_ref, msaa=4)
    band_h = H // 3
    bands = [np.asarray(band_transform(3, b)) for b in range(3)]

    def ref_frames(p, n):
        rf = ref_pipeline.render_frame
        return (rf(static, p, n, ref_cfg, model_mat=MODEL_MAT),
                rf(static, p, n, ref_cfg, height=band_h,
                   proj_transform=bands[1], aspect=W / H),
                rf(static, p, n, ortho_ref), rf(static, p, n, ortho4_ref))

    want = jax.jit(ref_frames)(pos, nrm)
    tp, tn = torch.as_tensor(pos), torch.as_tensor(nrm)
    ortho = dataclasses.replace(cfg, camera_orthographic=True)
    got = (pipeline.render_frame(rig, tp, tn, cfg, model_mat=MODEL_MAT),
           pipeline.render_frame(rig, tp, tn, cfg, height=band_h,
                                 proj_transform=bands[1], aspect=W / H),
           pipeline.render_frame(rig, tp, tn, ortho),
           pipeline.render_frame(rig, tp, tn,
                                 dataclasses.replace(ortho, msaa=4)))
    plain = pipeline.render_frame(rig, tp, tn, cfg)
    for what, g, w in zip(("model_mat", "band", "ortho", "ortho msaa=4"),
                          got, want):
        _assert_frames_close(g[None].numpy(), np.asarray(w)[None], what)
        if what != "band":
            assert float((g - plain).abs().max()) > 0.1, what
    full = pipeline.render_frame(rig, tp, tn, cfg, height=3 * band_h)
    stacked = torch.cat([pipeline.render_frame(
        rig, tp, tn, cfg, height=band_h, proj_transform=t, aspect=W / H)
        for t in bands])
    assert torch.equal(got[1], stacked[band_h:2 * band_h])
    # the bands' character equals the full frame's; the ground's lit
    # lookup is upsampled per band, so it may differ by a few pixels
    assert float((stacked - full).abs().max(-1).values.gt(0.02)
                 .float().mean()) < 2e-2


N_STEPS = 4


@pytest.fixture(scope="module")
def track_scenes():
    """The sample character with both tracks, physics off: (reference
    Scene, port Scene, the port Scene without tracks, the port's initial
    state, the reference's frames and times [N_STEPS], the port's eager
    frames [N_STEPS])."""
    static = ref_model.build_model(sample_character(density=0.25))
    motion = sample_motion(30, fps_keys=10)
    motion.camera = camera_track((0, 2, 4, 8), ortho_key=2, seed=3,
                                 target=(0.0, 11.0, 0.0), distance=-35.0)
    motion.light = light_track((0, 3, 6))
    cfg = AppConfig()
    cfg.render = RenderConfig(width=W, height=H, shadow_map_size=64,
                              show_skybox=False, raster_mode="tiled")
    cfg.physics.enabled = False
    ref = RefScene(static, ref_physics.build_physics(static),
                   ref_anim.bind_motion(static, motion), cfg,
                   camera=ref_ca.bind_camera(motion.camera),
                   light=ref_ca.bind_light(motion.light))
    tables = (convert.model_static(static),
              convert.physics_static(ref.phys_static),
              convert.motion_arrays(ref.motion), convert.app_config(cfg))
    port = Scene(*tables, device="cpu",
                 camera=convert.camera_arrays(ref.camera, "cpu"),
                 light=convert.light_arrays(ref.light, "cpu"))
    bare = Scene(*tables, device="cpu")
    ref_state = ref.init_state()
    state0 = convert.sim_state_to_torch(ref_state, device="cpu")
    step = jax.jit(ref.step_and_render)
    want, times, eager, state = [], [], [], state0
    for _ in range(N_STEPS):
        ref_state, image = step(ref_state)
        want.append(np.asarray(image))
        times.append(float(ref_state.time))
        state, image = port.step_and_render(state)
        eager.append(image)
    return ref, port, bare, state0, want, times, eager


def test_scene_tracks_match_reference(track_scenes):
    """step_and_render with both tracks against the reference's, frame by
    frame (frame 4 orthographic); without the tracks the frames differ."""
    _, port, bare, state0, want, times, eager = track_scenes
    state = state0
    for i in range(N_STEPS):
        _assert_frames_close(eager[i][None].numpy(), want[i][None],
                             f"frame {i}")
        state, bare_img = bare.step_and_render(state)
        assert float(state.time) == times[i]
        assert float((eager[i] - bare_img).abs().max()) > 0.1, i
    cfg = port.frame_config(state.time)
    assert isinstance(cfg.camera_orthographic, torch.Tensor)
    assert bool(cfg.camera_orthographic)     # frame 4: the ortho key


def test_scene_compiled_entry_points_carry_the_tracks(track_scenes):
    """jit_step, rollout and jit_rollout sample the tracks at the replay's
    time: their frames equal step_and_render's bit for bit."""
    _, port, _, state0, _, _, eager = track_scenes
    step = port.jit_step(donate=False)
    state = state0
    for i in range(N_STEPS):
        state, img = step(state)
        assert torch.equal(img, eager[i]), i
    sums = torch.stack([img.mean() for img in eager])
    _, got = port.rollout(state0, N_STEPS)
    assert torch.equal(got, sums)
    _, got = port.jit_rollout(2)(state0)
    assert torch.equal(got, sums[:2])
