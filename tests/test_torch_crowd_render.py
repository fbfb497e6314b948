"""The crowd's fused frame: `render.pipeline.crowd_render_frame` of the
port against the reference's (tests/test_torch_crowd_slice.py steps and
renders end to end).

Configuration: tests/test_torch_crowd_step.py's scene (density 0.25,
`sample_motion(60, fps_keys=10)`, 4 solver iterations), 3 instances with
staggered clocks, 128x64, shadow map 64^2, no skybox or textures,
raster_mode="tiled" on the reference side (on the CPU its "auto" picks the
scan raster, which the fused path does not cover), its Pallas kernels in
interpret mode.

Whole frames are held at the tolerance in use for single frames
(tests/test_torch_slice.py): fewer than 2e-3 of an instance's pixels off
by more than 0.02, mean absolute difference below 1/255, on the
reference's own vertices, so that only the frame is compared. Measured: no
pixel beyond 0.02 at either setting, mean 2.2e-10 at msaa=1 and 1.8e-6 at
msaa=4.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import pipeline

from test_torch_crowd_step import port_scene, ref_scene

import torch_threads  # noqa: F401  (the port's tests' thread cap)

N = 3


def _assert_frames_close(got, want, what):
    assert got.shape == want.shape
    for i in range(got.shape[0]):
        d = np.abs(got[i] - want[i])
        assert (d > 0.02).mean() < 2e-3, f"{what}, instance {i}"
        assert d.mean() < 1 / 255, f"{what}, instance {i}"


@pytest.fixture(scope="module")
def posed():
    """The reference scene, the port's, and one crowd frame's vertices
    and normals (the reference's, so that only the frame is compared)."""
    ref = ref_scene()
    crowd = ref_par.crowd_init(ref, N, phase_frames=7.0)
    _, _, pos, nrm = jax.jit(ref_par.crowd_step_fn(ref, render=False))(crowd)
    return ref, port_scene(ref), np.array(pos), np.array(nrm)


@pytest.mark.parametrize("msaa", [1, 4])
def test_crowd_render_frame_matches_reference(posed, msaa):
    ref, port, pos, nrm = posed
    cfg = dataclasses.replace(ref.config.render, msaa=msaa)
    assert ref_pipeline.crowd_render_supported(cfg)
    assert pipeline.crowd_render_supported(convert.app_config(
        dataclasses.replace(ref.config, render=cfg)).render)
    want = np.asarray(jax.jit(lambda p, n: ref_pipeline.crowd_render_frame(
        ref.static, p, n, cfg))(pos, nrm))
    calls = {}
    for name in ("raster_tiles_multi", "raster_tiles_ms_multi",
                 "depth_tiles_multi"):
        calls[name] = getattr(tr, name)
    seen = []

    def spy(name):
        def call(*a, **kw):
            seen.append(name)
            return calls[name](*a, **kw)
        return call

    try:
        for name in calls:
            setattr(tr, name, spy(name))
        got = pipeline.crowd_render_frame(
            port.rig, torch.as_tensor(pos), torch.as_tensor(nrm),
            dataclasses.replace(port.config.render, msaa=msaa)).numpy()
    finally:
        for name, fn in calls.items():
            setattr(tr, name, fn)
    assert got.shape == (N, 64, 128, 3) and np.isfinite(got).all()
    _assert_frames_close(got, want, f"msaa={msaa}")
    # one shadow raster and one character raster for the whole crowd
    assert seen == ["depth_tiles_multi", "raster_tiles_ms_multi"
                    if msaa == 4 else "raster_tiles_multi"]
    # the instances differ (staggered clocks) and hold a character
    assert np.abs(got[0] - got[1]).max() > 0.1


def test_crowd_render_frame_equals_render_frame_per_instance(posed):
    """The fused frame against the port's own single-instance frame on the
    same vertices: the same pixels (the ground's lit lookup, the rasters
    and the shading are per instance the same arithmetic)."""
    _, port, pos, nrm = posed
    for msaa in (1, 4):
        cfg = dataclasses.replace(port.config.render, msaa=msaa)
        fused = pipeline.crowd_render_frame(
            port.rig, torch.as_tensor(pos), torch.as_tensor(nrm), cfg)
        for i in range(N):
            single = pipeline.render_frame(
                port.rig, torch.as_tensor(pos[i]), torch.as_tensor(nrm[i]),
                cfg)
            assert torch.equal(fused[i], single), (msaa, i)


@pytest.mark.parametrize("option,kw,cfg_kw", [
    ("msaa_supersample", {}, dict(msaa=4, msaa_supersample=True)),
    ("camera_orthographic", {}, dict(camera_orthographic=True)),
    ('raster_mode="scan"', {}, dict(raster_mode="scan")),
])
def test_crowd_options_outside_the_slice_raise(posed, option, kw, cfg_kw):
    """The options outside the crowd frame raise, naming themselves. The
    orthographic camera is ported (it no longer raises): the fused frame
    then equals each instance's own orthographic render_frame."""
    _, port, pos, nrm = posed
    cfg = dataclasses.replace(port.config.render, **cfg_kw)
    if option == "camera_orthographic":
        fused = pipeline.crowd_render_frame(
            port.rig, torch.as_tensor(pos), torch.as_tensor(nrm), cfg, **kw)
        for i in range(N):
            assert torch.equal(fused[i], pipeline.render_frame(
                port.rig, torch.as_tensor(pos[i]), torch.as_tensor(nrm[i]),
                cfg)), i
        return
    with pytest.raises(NotImplementedError) as err:
        pipeline.crowd_render_frame(port.rig, torch.as_tensor(pos),
                                    torch.as_tensor(nrm), cfg, **kw)
    assert option in str(err.value)
