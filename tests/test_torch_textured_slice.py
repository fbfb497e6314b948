"""Textured frames of the port against the reference's, on the same
vertices: `render_frame` with per-part textures (deferred UVs from the
visibility buffer, UVs riding the raster as attributes 3-4, native msaa=4,
the mip chain and the resident mini-atlas at magnification), and the
Scene's textured entry points (`step_and_render`, `jit_step`, `rollout`,
`jit_rollout`, the atlas cache). The crowd's textured frame is in
tests/test_torch_textured_crowd.py.

Configuration: the sample character at density 0.5 (1,912 triangles, 2
parts) in its rest pose, 192x144, shadow map 256^2, the procedural
textures `sample_textures((64, 16))` unless a case says otherwise;
raster_mode="tiled" on the reference side (its Pallas kernels in interpret
mode). Whole frames are held at the tolerance in use (tests/
test_torch_slice.py): fewer than 2e-3 of the pixels off by more than 0.02,
and a mean absolute difference below 1/255. Measured here: no pixel
beyond 0.02 at msaa=1 and with mips (mean at most 7.4e-8); at msaa=4 one
pixel of 27,648, off by 0.043 (mean 1.2e-6): an edge pixel whose centre
lies outside its triangle (K4 takes a pixel any of whose samples its
triangle covers, with extrapolated barycentrics). The albedo agrees there;
the shading does not, and in the untextured frame both sides clamp that
pixel to white.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import (sample_character,
                                                sample_textures)
from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import config, convert
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import pipeline

import torch_threads  # noqa: F401  (the port's tests' thread cap)

TEXTURES = (64, 16)


def _assert_frames_close(got, want, what):
    """The whole-frame tolerance, per instance of a leading axis."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    for i in range(got.shape[0]):
        d = np.abs(got[i] - want[i])
        assert (d > 0.02).mean() < 2e-3, f"{what}, instance {i}"
        assert d.mean() < 1 / 255, f"{what}, instance {i}"


def _port_cfg(cfg):
    return config.RenderConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})


def _model(density):
    static = ref_model.build_model(sample_character(density=density))
    rig = ModelTables(convert.model_static(static), "cpu")
    return static, rig


@pytest.fixture(scope="module")
def model():
    return _model(0.5)


def _cfg(**cfg_kw):
    return RenderConfig(width=192, height=144, shadow_map_size=256,
                        show_skybox=False, raster_mode="tiled", **cfg_kw)


# the rest-pose frames compared with the reference: {id: (texture sizes,
# render config)}
FRAMES = {
    "msaa1-deferred": (TEXTURES, dict(msaa=1, albedo_window=True)),
    "msaa1-kernel-uv": (TEXTURES, dict(msaa=1, albedo_window=False)),
    "msaa4-deferred": (TEXTURES, dict(msaa=4, albedo_window=True)),
    "msaa4-kernel-uv": (TEXTURES, dict(msaa=4, albedo_window=False)),
    "mips": ((8, 4), dict(texture_mips=4, texture_resident=0)),
    "resident": ((16, 8), dict(texture_mips=3, texture_resident=1)),
    "resident-capped": ((16, 8), dict(texture_mips=3, texture_resident=8)),
}


@pytest.fixture(scope="module")
def ref_frames(model):
    """The reference's rest-pose frame of every FRAMES entry, all traced
    into one jax.jit."""
    static, _ = model
    pos, nrm = np.asarray(static.positions), np.asarray(static.normals)
    looks = {name: (sample_textures(sizes), _cfg(**cfg_kw))
             for name, (sizes, cfg_kw) in FRAMES.items()}

    def frames(p, n):
        return {name: ref_pipeline.render_frame(static, p, n, cfg,
                                                part_textures=texs)
                for name, (texs, cfg) in looks.items()}

    return {k: np.asarray(v) for k, v in jax.jit(frames)(pos, nrm).items()}


def _port_frame(model, sizes, **cfg_kw):
    """The port's frame of the rest pose."""
    static, rig = model
    pos, nrm = np.asarray(static.positions), np.asarray(static.normals)
    got = pipeline.render_frame(rig, torch.as_tensor(pos),
                                torch.as_tensor(nrm),
                                _port_cfg(_cfg(**cfg_kw)),
                                part_textures=sample_textures(sizes))
    return got.numpy()


def _spy_raster(monkeypatch):
    """Record the attribute count each raster wrapper is called with."""
    seen = []
    for name in ("raster_tiles", "raster_tiles_ms"):
        fn = getattr(tr, name)

        def call(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, a[5]))
            return _fn(*a, **kw)
        monkeypatch.setattr(tr, name, call)
    return seen


@pytest.mark.parametrize("msaa,window", [(1, True), (1, False), (4, True),
                                         (4, False)],
                         ids=["msaa1-deferred", "msaa1-kernel-uv",
                              "msaa4-deferred", "msaa4-kernel-uv"])
def test_textured_frame_matches_reference(model, ref_frames, monkeypatch,
                                          msaa, window):
    """Deferred UVs ride no attribute (A = 3: normals); without the window
    the UVs ride the raster as attributes 3-4 (A = 5)."""
    seen = _spy_raster(monkeypatch)
    got = _port_frame(model, TEXTURES, msaa=msaa, albedo_window=window)
    want = ref_frames[f"msaa{msaa}-{'deferred' if window else 'kernel-uv'}"]
    assert seen == [("raster_tiles" if msaa == 1 else "raster_tiles_ms",
                     3 if window else 5)]
    _assert_frames_close(got[None], want[None], f"msaa={msaa}")
    assert got.std() > 0.05


@pytest.mark.parametrize("name,same_as", [
    ("mips", None), ("resident", {}),
    ("resident-capped", dict(texture_mips=3, texture_resident=0)),
], ids=["mips", "resident", "resident-capped"])
def test_mip_frames_at_magnification_match_reference(model, ref_frames, name,
                                                     same_as):
    """Tiny textures, magnified wherever a triangle covers pixels: the
    per-triangle mip rows (76 % of the triangles at level 0, the rest
    slivers and edge-on triangles), and the resident mini-atlas, whose one
    level a part is the least its triangles need, level 0 for both parts:
    it fits the slot (the frame equals the port's level-0 frame bit for
    bit), or with an 8-texel slot part 0's does not, and the frame falls
    back to the big mip atlas (bit for bit the frame without the resident
    path)."""
    sizes, cfg_kw = FRAMES[name]
    got = _port_frame(model, sizes, **cfg_kw)
    _assert_frames_close(got[None], ref_frames[name][None], str(cfg_kw))
    if same_as is not None:
        assert np.array_equal(got, _port_frame(model, sizes, **same_as))


def test_resident_choice_builds_the_mini_atlas_only_when_it_fits(
        model, monkeypatch):
    """The resident choice, read once a frame on the host: at magnification
    with the default slot every part's level-0 fits and the frame samples
    the mini-atlas (one `build_resident_atlas`); with an 8-texel slot part
    0's level 0 does not fit, no mini-atlas is built, and the frame is bit
    for bit the frame without the resident path."""
    static, rig = model
    pos = torch.as_tensor(np.asarray(static.positions))
    nrm = torch.as_tensor(np.asarray(static.normals))
    build = pipeline.build_resident_atlas
    built = []

    def spy(*args, **kw):
        built.append(args[2])
        return build(*args, **kw)

    monkeypatch.setattr(pipeline, "build_resident_atlas", spy)
    texs = sample_textures((16, 8))
    for slot, capped in ((1, False), (8, True)):
        built.clear()
        cfg = config.RenderConfig(width=192, height=144, shadow_map_size=256,
                                  show_skybox=False, texture_mips=3,
                                  texture_resident=slot)
        got = pipeline.render_frame(rig, pos, nrm, cfg, part_textures=texs)
        assert len(built) == (0 if capped else 1), (slot, built)
        no_res = pipeline.render_frame(
            rig, pos, nrm, dataclasses.replace(cfg, texture_resident=0),
            part_textures=texs)
        assert torch.equal(got, no_res) == capped


@pytest.fixture(scope="module")
def scenes():
    """The reference's sample Scene with textures (density 0.5, 192x144,
    shadow 256^2, 4 solver iterations) and the port's built from it."""
    from __graft_entry__ import _build_scene

    ref = _build_scene(density=0.5, width=192, height=144, shadow=256,
                       solver_iterations=4, raster_mode="tiled")
    ref = dataclasses.replace(ref, part_textures=sample_textures(TEXTURES))
    port = Scene(convert.model_static(ref.static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(ref.motion),
                 convert.app_config(ref.config),
                 part_textures=list(ref.part_textures), device="cpu")
    return ref, port


def test_scene_textured_entry_points_match_reference(scenes):
    """Two frames of `Scene.step_and_render` against the reference's jitted
    textured step (whole-frame tolerance; the CCD divergence of
    tests/test_torch_slice.py moves no pixel beyond 0.02 here), and the
    compiled entry points' frames equal to the eager ones: `jit_step`'s
    images, `rollout`'s and `jit_rollout`'s checksums."""
    ref, port = scenes
    ref_state = ref.init_state()
    state0 = convert.sim_state_to_torch(ref_state, device="cpu")
    step = jax.jit(ref.step_and_render)
    state, images = state0, []
    for frame in range(2):
        ref_state, want = step(ref_state)
        state, img = port.step_and_render(state)
        _assert_frames_close(img[None].numpy(), np.asarray(want)[None],
                             f"frame {frame}")
        images.append(img)
    jit = port.jit_step(donate=False)
    state = state0
    for img in images:
        state, got = jit(state)
        assert torch.equal(got, img)
    sums = torch.stack([img.mean() for img in images])
    _, got = port.rollout(state0, 2)
    assert torch.equal(got, sums)
    _, got = port.jit_rollout(2)(state0)
    assert torch.equal(got, sums)


def test_scene_packed_atlas_cache(scenes):
    """`Scene.packed_atlas` packs once and keeps the atlas; replacing the
    list, or one of its textures in place, packs anew, as does another
    texture_mips; `.to()` drops it."""
    _, port = scenes
    atlas = port.packed_atlas()
    assert atlas is port.packed_atlas()
    assert atlas.n_mips == 0 and atlas.data.device.type == "cpu"
    texs = list(port.part_textures)
    try:
        port.part_textures[1] = sample_textures((8, 8))[1]
        fresh = port.packed_atlas()
        assert fresh is not atlas and fresh.data.shape != atlas.data.shape
        port.part_textures = list(port.part_textures)
        assert port.packed_atlas() is not fresh
        port.config.render.texture_mips = 3
        assert port.packed_atlas().n_mips == 3
    finally:
        port.config.render.texture_mips = 0
        port.part_textures = texs
    kept = port.packed_atlas()
    assert kept is port.packed_atlas()
    port.to("cpu")
    assert port.packed_atlas() is not kept


@pytest.mark.parametrize("option,kw,cfg_kw", [
    ("proj_transform", dict(proj_transform=np.eye(4, dtype=np.float32)), {}),
    ('raster_mode="scan"', {}, dict(raster_mode="scan")),
    ("camera_orthographic", {}, dict(camera_orthographic=True)),
])
def test_textured_frame_options_outside_the_slice_raise(model, option, kw,
                                                         cfg_kw):
    """With textures no option raises any more. `proj_transform` and the
    orthographic camera are ported (tests/test_torch_camera.py holds them
    against the reference): with textures an identity `proj_transform`
    gives the plain frame bit for bit, and the orthographic frame is
    finite and another. The scan raster is ported too
    (tests/test_torch_scan_raster.py holds its textured frame against the
    reference's): with textures, its UVs riding the raster as attributes,
    it agrees with the tiled frame (deferred UVs) at the whole-frame
    tolerance (measured: 1.1e-4 of the values beyond 0.02, mean 3.4e-5:
    the bilinear taps of a few edge pixels)."""
    static, rig = model
    cfg = config.RenderConfig(**{"width": 64, "height": 48,
                                 "shadow_map_size": 64, "show_skybox": False,
                                 **cfg_kw})
    pos = torch.as_tensor(np.asarray(static.positions))
    nrm = torch.as_tensor(np.asarray(static.normals))
    texs = sample_textures(TEXTURES)
    if option in ("proj_transform", "camera_orthographic"):
        got = pipeline.render_frame(rig, pos, nrm, cfg, part_textures=texs,
                                    **kw)
        plain = pipeline.render_frame(
            rig, pos, nrm, dataclasses.replace(cfg, camera_orthographic=False),
            part_textures=texs)
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, plain) == (option == "proj_transform")
        return
    got = pipeline.render_frame(rig, pos, nrm, cfg, part_textures=texs)
    tiled = pipeline.render_frame(
        rig, pos, nrm, dataclasses.replace(cfg, raster_mode="auto"),
        part_textures=texs)
    assert bool(torch.isfinite(got).all())
    _assert_frames_close(got[None].numpy(), tiled[None].numpy(), option)
