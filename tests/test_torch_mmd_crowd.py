"""The rest of the reference frame on the crowd: `crowd_render_frame` and
`parallel.mesh.crowd_step_fn` with the skybox (one camera-shared pass),
the edge outlines (the crowd's hull through K5a at one zero attribute,
front faces culled), double-sided materials (the shared `nocull` mask on
K5a / K5b) and the MMD toon / sphere shading over the instance axis,
against the reference's fused crowd frame, against the port's own single
frame per instance, and option by option.

Configuration: tests/test_torch_mmd_look.py's inputs (the sample
character at density 0.5 with material 1 double-faced, edge_scale 20, a
16^2 cubemap, `sample_mmd_maps(2, 32, 16)`), a crowd of 2 (clocks 7 frames
apart) one compiled step in (`sample_motion(30, fps_keys=10)`, 2 solver
iterations), 64x48, shadow map 64^2; raster_mode="tiled" on the reference
side (its Pallas kernels in interpret mode).

Whole frames are held per instance at the tolerance in use (fewer than
2e-3 of the pixels off by more than 0.02, mean below 1/255), on the same
vertices (at msaa=4; at msaa=1 through the single frames, which equal
the crowd's bit for bit). Measured here: no pixel beyond 0.02; mean
differences at most 1.3e-6 (largest single pixel 6.9e-3). Each option moves more than 5e-3 of some instance's pixels by
more than 0.02 (measured, the larger instance: skybox 0.381, edges 0.0120,
double-sided 0.0234, MMD maps 0.0260).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.parallel.mesh import (crowd_init,
                                                         crowd_step_fn)
from simple_mmd_renderer_tpu_torch.render import pipeline

from test_torch_mmd_look import (CHANGED, OPTIONS, H, W, assert_frames_close,
                                 cfg_kw, changed, look_inputs)

import torch_threads  # noqa: F401  (the port's tests' thread cap)

N = 2


@pytest.fixture(scope="module")
def crowd():
    """(reference static, cubemap, MMD maps, the port's scene with every
    option, a crowd state, that state's next vertices and normals)."""
    static, cube, mmd = look_inputs()
    scene = build_sample_scene(0.5, W, H, 64, "cpu", n_frames=30,
                               fps_keys=10, solver_iterations=2,
                               cubemap=cube, show_edges=True,
                               double_sided_parts=(1,), mmd_maps=mmd)
    scene.config.render = dataclasses.replace(
        scene.config.render, **cfg_kw(OPTIONS))
    state = crowd_init(scene, N)
    _, _, pos, nrm = scene.jit_step(render=False, donate=False)(state)
    return static, cube, mmd, scene, state, pos, nrm


def _port_cfg(scene, options, msaa):
    return dataclasses.replace(scene.config.render, **cfg_kw(options, msaa))


def _spy(monkeypatch):
    """Record (wrapper, attribute count) of every crowd raster call."""
    seen = []
    for name in ("raster_tiles_multi", "raster_tiles_ms_multi",
                 "depth_tiles_multi"):
        fn = getattr(tr, name)

        def call(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, a[6] if len(a) > 6 else None))
            return _fn(*a, **kw)
        monkeypatch.setattr(tr, name, call)
    return seen


@pytest.mark.parametrize("msaa", [4])
def test_crowd_look_matches_reference(crowd, monkeypatch, msaa):
    """All four options on the fused crowd frame against the reference's;
    one shadow raster (K5c), the character's (K5b at A = 3) and the edge
    hull's (K5a at A = 1) for the whole crowd. (At msaa=1 the crowd frame
    equals the single frames bit for bit, test_crowd_step_fn_renders_the_look,
    which tests/test_torch_mmd_look.py holds against the reference.)"""
    static, cube, mmd, scene, _, pos, nrm = crowd
    cfg = RenderConfig(raster_mode="tiled", **cfg_kw(OPTIONS, msaa))
    assert ref_pipeline.crowd_render_supported(cfg, None, cube)
    want = np.asarray(jax.jit(lambda p, n: ref_pipeline.crowd_render_frame(
        static, p, n, cfg, cubemap=cube, mmd_maps=mmd))(
            pos.numpy(), nrm.numpy()))
    seen = _spy(monkeypatch)
    pcfg = _port_cfg(scene, OPTIONS, msaa)
    assert pipeline.crowd_render_supported(pcfg, None, scene.cubemap)
    got = pipeline.crowd_render_frame(
        scene.rig, pos, nrm, pcfg, cubemap=scene.cubemap,
        mmd_maps=scene.mmd_device_maps()).numpy()
    assert got.shape == (N, H, W, 3) and np.isfinite(got).all()
    assert_frames_close(got, want, f"msaa={msaa}")
    assert sorted(seen) == sorted([
        ("depth_tiles_multi", None), ("raster_tiles_multi", 1),
        ("raster_tiles_multi" if msaa == 1 else "raster_tiles_ms_multi", 3)])
    assert np.abs(got[0] - got[1]).max() > 0.1


@pytest.mark.parametrize("msaa", [1, 4])
def test_crowd_step_fn_renders_the_look(crowd, msaa):
    """`crowd_step_fn` routes the scene's cubemap and MMD maps into the
    fused frame: its images are `crowd_render_frame`'s of the stepped
    vertices, bit for bit, and each instance's the port's single frame of
    its own vertices."""
    _, _, _, scene, state, pos, nrm = crowd
    scene.config.render = _port_cfg(scene, OPTIONS, msaa)
    _, images = crowd_step_fn(scene)(state)
    cfg = scene.config.render
    want = pipeline.crowd_render_frame(
        scene.rig, pos, nrm, cfg, cubemap=scene.cubemap,
        mmd_maps=scene.mmd_device_maps())
    assert torch.equal(images, want)
    for i in range(N):
        single = pipeline.render_frame(scene.rig, pos[i], nrm[i], cfg,
                                       cubemap=scene.cubemap,
                                       mmd_maps=scene.mmd_device_maps())
        assert torch.equal(images[i], single), i


def test_each_option_changes_the_crowd_frame(crowd):
    _, _, _, scene, _, pos, nrm = crowd
    look = dict(cubemap=scene.cubemap, mmd_maps=scene.mmd_device_maps())

    def frame(options):
        kw = {k: v for k, v in look.items()
              if ("skybox" if k == "cubemap" else k) in options}
        return pipeline.crowd_render_frame(
            scene.rig, pos, nrm, _port_cfg(scene, options, 1), **kw).numpy()

    plain = frame(())
    for option in OPTIONS:
        got = frame((option,))
        moved = max(changed(got[i], plain[i]) for i in range(N))
        assert moved > CHANGED, option


def test_crowd_options_outside_the_slice_still_raise(crowd):
    _, _, _, scene, _, pos, nrm = crowd
    cfg = _port_cfg(scene, OPTIONS, 1)
    for option, kw, c in (
            ("msaa_supersample", {},
             dataclasses.replace(cfg, msaa=4, msaa_supersample=True)),):
        with pytest.raises(NotImplementedError, match=option):
            pipeline.crowd_render_frame(scene.rig, pos, nrm, c, **kw)
