"""The textured crowd: `render.pipeline.crowd_render_frame` with the
shared atlas, and `parallel.mesh.crowd_step_fn` with textures, against the
reference's.

Configuration: the sample character at density 0.25 (2 parts), textures
`sample_textures((64, 16))`, raster_mode="tiled" on the reference side.
The frame: 3 instances of the rest pose moved apart, 128x96, shadow 64^2.
The step: tests/test_torch_crowd_step.py's scene (128x64, shadow 64^2,
`sample_motion(60, fps_keys=10)`, 4 solver iterations) with the textures,
3 instances with staggered clocks, 2 frames. Whole frames are held at the
tolerance in use, per instance: fewer than 2e-3 of the pixels off by more
than 0.02 and a mean absolute difference below 1/255. Measured: no pixel
beyond 0.02 at msaa=1 (mean at most 4.3e-8); at msaa=4 one pixel of
12,288 in instance 0, off by 0.138 without mips and 0.024 with (mean at
most 7.0e-6): the pixel the untextured msaa=4 crowd frame has off too
(0.031), an edge pixel whose centre lies outside its triangle. The
reference's four frame configurations are traced into one jax.jit
(`reference_frames`).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import sample_textures
from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.parallel import mesh as par
from simple_mmd_renderer_tpu_torch.render import pipeline

from test_torch_crowd_step import port_scene, ref_scene
from test_torch_textured_slice import (TEXTURES, _assert_frames_close,
                                       _model, _port_cfg)

import torch_threads  # noqa: F401  (the port's tests' thread cap)


@pytest.fixture(scope="module")
def crowd_model():
    static, rig = _model(0.25)
    p0, n0 = np.asarray(static.positions), np.asarray(static.normals)
    pos = np.stack([p0, p0 + [2.0, 0.0, -1.0], p0 * [1.0, 0.9, 1.0]])
    nrm = np.stack([n0, n0, n0])
    return static, rig, pos.astype(np.float32), nrm.astype(np.float32)


def _frame_cfg(msaa, mips):
    return RenderConfig(width=128, height=96, shadow_map_size=64,
                        show_skybox=False, raster_mode="tiled", msaa=msaa,
                        texture_mips=mips)


@pytest.fixture(scope="module")
def reference_frames(crowd_model):
    """The reference's fused crowd frame with the shared atlas at msaa 1 and
    4, without mips and with 4, the four configurations traced into one
    jax.jit. -> (textures, {mips: atlas}, {(msaa, mips): images})."""
    static, _, pos, nrm = crowd_model
    texs = sample_textures(TEXTURES)
    atlases = {mips: ref_pipeline.build_packed_atlas(texs, mip_levels=mips)
               for mips in (0, 4)}

    def frames(p, n, atlases):
        return {(msaa, mips): ref_pipeline.crowd_render_frame(
            static, p, n, _frame_cfg(msaa, mips), part_textures=texs,
            atlas=atlases[mips]) for msaa in (1, 4) for mips in (0, 4)}

    want = jax.jit(frames)(pos, nrm, atlases)
    return texs, atlases, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("msaa", [1, 4])
@pytest.mark.parametrize("mips", [0, 4])
def test_textured_crowd_frame_matches_reference(crowd_model, reference_frames,
                                                monkeypatch, msaa, mips):
    """The fused crowd frame with the shared atlas: the UVs ride K5a/K5b as
    attributes 3-4 (A = 5); a mip atlas selects each triangle's level per
    instance."""
    _, rig, pos, nrm = crowd_model
    texs, atlases, want = reference_frames
    cfg = _frame_cfg(msaa, mips)
    seen = []
    name = "raster_tiles_multi" if msaa == 1 else "raster_tiles_ms_multi"
    fn = getattr(tr, name)
    monkeypatch.setattr(tr, name, lambda *a: seen.append(a[6]) or fn(*a))
    got = pipeline.crowd_render_frame(
        rig, torch.as_tensor(pos), torch.as_tensor(nrm), _port_cfg(cfg),
        part_textures=texs, atlas=convert.packed_atlas(atlases[mips], "cpu"))
    assert seen == [5]
    _assert_frames_close(got.numpy(), want[msaa, mips],
                         f"msaa={msaa} mips={mips}")
    assert float((got[0] - got[1]).abs().max()) > 0.1


@pytest.fixture(scope="module")
def stepped():
    """The reference's textured crowd scene, the port's built from it, the
    start state and the reference's jitted step's first 2 crowd frames."""
    ref = dataclasses.replace(ref_scene(), part_textures=sample_textures(
        TEXTURES))
    port = port_scene(ref)
    port.part_textures = list(ref.part_textures)
    state = ref_par.crowd_init(ref, 3, phase_frames=7.0)
    step = jax.jit(ref_par.crowd_step_fn(ref, atlas_arg=True))
    frames, s = [], state
    for _ in range(2):
        s, images = step(s, ref.packed_atlas())
        frames.append(np.asarray(images))
    return port, convert.sim_state_to_torch(state, device="cpu"), frames


@pytest.mark.parametrize("atlas_arg", [False, True])
def test_textured_crowd_step_fn_end_to_end(stepped, atlas_arg):
    """Two frames of the textured crowd step: the atlas packed when the
    function is made, or passed per call (`Scene.packed_atlas`), against
    the reference's jitted step with its scene's atlas."""
    port, state, frames = stepped
    step = par.crowd_step_fn(port, atlas_arg=atlas_arg)
    for frame, want in enumerate(frames):
        state, got = (step(state, port.packed_atlas()) if atlas_arg
                      else step(state))
        assert got.shape == (3, 64, 128, 3)
        _assert_frames_close(got.numpy(), want, f"frame {frame}")
