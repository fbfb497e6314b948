"""The rest of the reference frame in the port, one frame at a time: the
skybox (`cubemap`, `show_skybox`), the edge outlines (`show_edges`: the
inverted hull through `rasterize_tiled`, K2 at 0 attributes, front faces
culled), double-sided materials (`double_sided`: the `nocull` exemption and
two-sided lighting) and the MMD toon ramps and SPH / SPA sphere maps
(`mmd_maps`), each alone and all four together at msaa=1 and msaa=4,
against the reference's `render_frame`; and the Scene's entry points with
`cubemap=` and `mmd_maps=`. The crowd's frames are in
tests/test_torch_mmd_crowd.py.

Configuration: the sample character at density 0.5 (1,912 triangles, 2
parts) with its material 1 ("extras") flagged MAT_DOUBLE_FACE before the
model is built, in its rest pose, 64x48, shadow map 64^2, edge_scale 20 (an
outline of about a pixel at this size); a 16^2 cubemap from a seeded
32x64 equirect (`app.sample.sample_equirect`); `sample_mmd_maps(2, 32,
16)`: 16-step default toon ramps, an SPH map on part 0 and an SPA map on
part 1; each option alone without the shadow pass, all four with it.
raster_mode="tiled" on the reference side (its Pallas kernels in
interpret mode).

Whole frames are held at the tolerance in use (tests/test_torch_slice.py):
fewer than 2e-3 of the pixels off by more than 0.02, and a mean absolute
difference below 1/255. Measured here: no pixel beyond 0.02 in any case;
mean differences at most 1.4e-8 at msaa=1 and 3.1e-7 at msaa=4 (largest
single pixel 1.6e-3, at msaa=4). Each option changes the frame: the share
of pixels it moves by more than 0.02 must exceed 5e-3 (measured: skybox
0.381, edges 0.0107, double-sided 0.0254, MMD maps 0.0267).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import sample_character
from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.render import ibl as ref_ibl
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import config, convert
from simple_mmd_renderer_tpu_torch.app.sample import (sample_equirect,
                                                      sample_mmd_maps)
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import pipeline

import torch_threads  # noqa: F401  (the port's tests' thread cap)

W, H = 64, 48
OPTIONS = ("skybox", "edges", "double_sided", "mmd_maps")
CHANGED = 5e-3      # the least share of pixels an option must move


def assert_frames_close(got, want, what):
    """The whole-frame tolerance, per instance of a leading axis."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    for i in range(got.shape[0]):
        d = np.abs(got[i] - want[i])
        assert (d > 0.02).mean() < 2e-3, f"{what}, instance {i}"
        assert d.mean() < 1 / 255, f"{what}, instance {i}"


def changed(a, b):
    """The share of pixels that differ by more than 0.02."""
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1)
                  > 0.02).mean())


def look_inputs():
    """(reference static with part 1 double-faced, reference cubemap, the
    MMD maps tuple): the inputs both packages get."""
    pm = sample_character(density=0.5)
    pm.materials[1].draw_flags |= ref_pmx.MAT_DOUBLE_FACE
    static = ref_model.build_model(pm)
    cube = np.array(ref_ibl.equirect_to_cubemap(sample_equirect(32, 64), 16))
    return static, cube, sample_mmd_maps(2, 32, 16)


def cfg_kw(options, msaa=1, shadows=True):
    """RenderConfig fields for a set of options."""
    return dict(width=W, height=H, shadow_map_size=64, msaa=msaa,
                shadows_enabled=shadows, edge_scale=20.0,
                show_skybox="skybox" in options,
                show_edges="edges" in options,
                double_sided="double_sided" in options)


@pytest.fixture(scope="module")
def look():
    static, cube, mmd = look_inputs()
    rig = ModelTables(convert.model_static(static), "cpu")
    return static, rig, cube, mmd


# the reference frames the tests compare with: (options, msaa, shadows)
REF_CASES = ([((option,), 1, False) for option in OPTIONS]
             + [(OPTIONS, 1, True), (OPTIONS, 4, True)])


def _ref_render(look, options, msaa, shadows):
    """The reference's `render_frame` of the rest pose for a case, as a
    function of (positions, normals) to trace."""
    static, _, cube, mmd = look
    cfg = RenderConfig(raster_mode="tiled", **cfg_kw(options, msaa, shadows))
    return lambda p, n: ref_pipeline.render_frame(
        static, p, n, cfg, cubemap=cube if "skybox" in options else None,
        mmd_maps=mmd if "mmd_maps" in options else None)


@pytest.fixture(scope="module")
def ref_frames(look):
    """The reference's frame of every case of REF_CASES, traced into one
    jitted program (XLA shares the work the cases have in common: half the
    compile time of one program a case)."""
    static = look[0]
    fns = [_ref_render(look, *case) for case in REF_CASES]
    out = jax.jit(lambda p, n: tuple(f(p, n) for f in fns))(
        np.asarray(static.positions), np.asarray(static.normals))
    return {case: np.asarray(frame) for case, frame in zip(REF_CASES, out)}


def _frames(look, options, msaa=1, shadows=True):
    """The port's frame of the rest pose."""
    static, rig, cube, mmd = look
    cfg = config.RenderConfig(**cfg_kw(options, msaa, shadows))
    got = pipeline.render_frame(
        rig, torch.as_tensor(np.asarray(static.positions)),
        torch.as_tensor(np.asarray(static.normals)), cfg,
        cubemap=(convert.cubemap(cube, "cpu") if "skybox" in options
                 else None),
        mmd_maps=convert.mmd_maps(mmd) if "mmd_maps" in options else None)
    return got.numpy()


@pytest.mark.parametrize("option", OPTIONS)
def test_each_option_matches_reference(look, ref_frames, option):
    """One option at a time, without the shadow pass (the options do not
    touch it; the frames with all four keep it)."""
    got = _frames(look, (option,), shadows=False)
    assert_frames_close(got[None], ref_frames[(option,), 1, False][None],
                        option)
    plain = _frames(look, (), shadows=False)
    assert changed(got, plain) > CHANGED, option


def _spy_rasters(monkeypatch):
    """Record (wrapper, attribute count) of every raster kernel call."""
    seen = []
    for name in ("raster_tiles", "raster_tiles_ms"):
        fn = getattr(tr, name)

        def call(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, a[5]))
            return _fn(*a, **kw)
        monkeypatch.setattr(tr, name, call)
    return seen


@pytest.mark.parametrize("msaa", [1, 4])
def test_all_four_match_reference(look, ref_frames, monkeypatch, msaa):
    """All four options at once; the edge hull goes through K2 at 0
    attributes beside the character's raster (K2 or K4 at 3)."""
    seen = _spy_rasters(monkeypatch)
    want = ref_frames[OPTIONS, msaa, True]
    got = _frames(look, OPTIONS, msaa)
    assert sorted(seen) == sorted([
        ("raster_tiles", 0),
        ("raster_tiles" if msaa == 1 else "raster_tiles_ms", 3)])
    assert_frames_close(got[None], want[None], f"msaa={msaa}")
    assert np.isfinite(got).all() and got.shape == (H, W, 3)


def test_double_sided_bins_both_windings(look, monkeypatch):
    """With `double_sided`, the double-faced part's back-facing triangles
    are binned beside the front-facing ones (more character entries than
    without); without a flagged part the option changes nothing."""
    static, rig, _, _ = look
    counts = []
    bin_ = tr._bin

    def spy(*a, **kw):
        out = bin_(*a, **kw)
        counts.append(int(out[2].sum()))
        return out
    monkeypatch.setattr(tr, "_bin", spy)
    pos = torch.as_tensor(np.asarray(static.positions))
    nrm = torch.as_tensor(np.asarray(static.normals))
    frames = []
    for ds in (False, True):
        cfg = config.RenderConfig(**cfg_kw(("double_sided",) if ds else ()))
        frames.append(pipeline.render_frame(rig, pos, nrm, cfg))
    assert counts[3] > counts[1], counts     # [shadow, character] a frame
    plain = ModelTables(convert.model_static(
        ref_model.build_model(sample_character(density=0.5))), "cpu")
    assert not plain.has_nocull and rig.has_nocull
    cfg = config.RenderConfig(**cfg_kw(("double_sided",)))
    assert torch.equal(pipeline.render_frame(plain, pos, nrm, cfg),
                       frames[0])


def test_options_outside_the_slice_still_raise(look, ref_frames,
                                               monkeypatch):
    """No option of the full look raises any more: the scan raster, the
    last one that did, is ported. With all four options and
    `raster_mode="scan"` the frame goes through the scan raster (the
    shadow map, the edge hull and the character; no binning) and agrees
    with the reference's full-look frame at the whole-frame tolerance
    (measured against its tiled frame: largest difference 3.4e-6; the scan
    frames themselves are held against the reference's in
    tests/test_torch_scan_raster.py)."""
    static, _, cube, mmd = look
    calls = []
    scan = tr.scan_raster

    def spy(*a, **kw):
        calls.append(a[:2])
        return scan(*a, **kw)
    monkeypatch.setattr(tr, "scan_raster", spy)
    monkeypatch.setattr(tr, "_bin", None)
    got = pipeline.render_frame(
        look[1], torch.as_tensor(np.asarray(static.positions)),
        torch.as_tensor(np.asarray(static.normals)),
        config.RenderConfig(raster_mode="scan", **cfg_kw(OPTIONS)),
        cubemap=convert.cubemap(cube, "cpu"), mmd_maps=convert.mmd_maps(mmd))
    assert calls == [(64, 64), (W, H), (W, H)]
    assert_frames_close(got[None].numpy(),
                        ref_frames[OPTIONS, 1, True][None], "scan")


@pytest.fixture(scope="module")
def look_scene():
    """A port Scene with every option (tiny sample scene, 2 solver
    iterations) and the inputs it was built from."""
    _, cube, mmd = look_inputs()
    scene = build_sample_scene(0.5, W, H, 64, "cpu", n_frames=30,
                               fps_keys=10, solver_iterations=2,
                               cubemap=cube, show_edges=True,
                               double_sided_parts=(1,), mmd_maps=mmd)
    return scene, cube, mmd


def test_scene_entry_points_render_the_look(look_scene, monkeypatch):
    """`step_and_render`, `jit_step`, `rollout` and `jit_rollout` of a
    Scene with `cubemap=` and `mmd_maps=` give `render_frame`'s frame of
    the stepped vertices with those inputs, bit for bit; the sphere maps
    are packed once for the scene, not per frame."""
    scene, cube, mmd = look_scene
    cfg = scene.config.render
    assert cfg.show_skybox and cfg.show_edges and cfg.double_sided
    assert scene.rig.has_nocull and scene.rig.n_edge_tris == 1912
    assert scene.cubemap.dtype == torch.float32
    assert np.array_equal(scene.cubemap.numpy(), cube)
    packs = []
    build = pipeline.build_packed_atlas

    def spy(*a, **kw):
        packs.append(len(a[0]))
        return build(*a, **kw)
    monkeypatch.setattr(pipeline, "build_packed_atlas", spy)

    state0 = scene.init_state()
    state, images = state0, []
    for _ in range(2):
        _, _, pos, nrm = scene.step_pose(state)
        state, img = scene.step_and_render(state)
        want = pipeline.render_frame(scene.rig, pos, nrm, cfg, cubemap=cube,
                                     mmd_maps=mmd)
        assert torch.equal(img, want)
        images.append(img)
    # one pack for the scene's maps, one for each direct render_frame call
    # given the tuple
    assert packs == [2, 2, 2], packs
    assert scene.mmd_device_maps() is scene.mmd_device_maps()
    jit = scene.jit_step(donate=False)
    state = state0
    for img in images:
        state, got = jit(state)
        assert torch.equal(got, img)
    sums = torch.stack([img.mean() for img in images])
    _, got = scene.rollout(state0, 2)
    assert torch.equal(got, sums)
    _, got = scene.jit_rollout(2)(state0)
    assert torch.equal(got, sums)
    assert len(packs) == 3
    kept = scene.mmd_device_maps()
    scene.to("cpu")
    assert scene.mmd_device_maps() is not kept
