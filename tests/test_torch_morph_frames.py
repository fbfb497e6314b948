"""Frames with the extended morphs, the port against the reference:
`render_frame` and `crowd_render_frame` with `uv_offsets` and
`part_color` (the Scene's and the crowd step's entry points with
`AppConfig.apply_extended_morphs` on are in tests/test_torch_morph_scene.py).

Configuration (raster_mode="tiled" on the reference side):
`chip_smoke.content_rig` at density 0.25 (2 parts; a UV morph on part 0,
a multiply and an add entry on part 1; through `write_pmx` and
`parse_pmx`) in its rest pose, 96x72, shadow 128^2, textures
`sample_textures((32, 16))`; the crowd: 4 instances moved apart, each with
its own morph rates.

Whole frames are held at the tolerance in use: fewer than 2e-3 of the
pixels off by more than 0.02 and a mean absolute difference below 1/255,
per instance. Measured: on the msaa=4 frame one pixel of 20,736 off by
0.026 (mean 1.4e-6; an edge pixel, as tests/test_torch_textured_slice.py's
msaa=4 frame has one); on every other frame no pixel beyond 0.02, the
largest difference 2.5e-5 (mean at most 3.9e-8).
"""


import numpy as np
import jax
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.app.sample import sample_textures
from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import pose as ref_pose
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core import pose
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx
from simple_mmd_renderer_tpu_torch.render import pipeline

from test_torch_textured_slice import _assert_frames_close, _port_cfg

import chip_smoke

W, H = 96, 72


@pytest.fixture(scope="module")
def content():
    """(reference ModelStatic, port tables, textures) of the content rig."""
    pm, _ = chip_smoke.content_rig(0.25)
    static = ref_model.build_model(ref_pmx.parse_pmx(write_pmx(pm)))
    return (static, ModelTables(convert.model_static(static), "cpu"),
            sample_textures((32, 16)))


def _rates(static, values):
    """Leaf rates [..., M] with the content rig's UV and material morphs
    (the last two) at `values` [..., 2]."""
    values = np.asarray(values, np.float32)
    out = np.zeros(values.shape[:-1] + (static.n_morphs,), np.float32)
    out[..., -2:] = values
    return out


def _morph_args(static, rig, leaf):
    """(reference uv_offsets, part_color), (the port's) at leaf rates
    [M] or [I, M] (the reference's vmapped over I)."""
    fns = (ref_pose.uv_morph_offsets, ref_pose.material_morph_factors)
    if leaf.ndim == 2:
        fns = tuple(jax.vmap(lambda lr, f=f: f(static, lr)) for f in fns)
    else:
        fns = tuple(lambda lr, f=f: f(static, lr) for f in fns)
    ref = tuple(f(leaf) for f in fns)
    lt = torch.as_tensor(leaf)
    return ref, (pose.uv_morph_offsets(rig, lt),
                 pose.material_morph_factors(rig, lt))


@pytest.mark.parametrize("msaa,cfg_kw", [
    (1, dict(texture_mips=3, texture_resident=1)),
    (4, dict(albedo_window=False))],
    ids=["msaa1-deferred-mips-resident", "msaa4-kernel-uv"])
def test_frame_with_morphs_matches_reference(content, msaa, cfg_kw):
    """UV offsets moved before either UV path (the deferred rows with their
    mip levels and the resident choice, or the raster's attributes 3-4),
    the part colour applied by the pixel's part; the morphs move the
    frame."""
    static, rig, texs = content
    cfg = RenderConfig(width=W, height=H, shadow_map_size=128, msaa=msaa,
                       show_skybox=False, raster_mode="tiled", **cfg_kw)
    pos, nrm = np.asarray(static.positions), np.asarray(static.normals)
    (r_uv, r_pc), (p_uv, p_pc) = _morph_args(static, rig,
                                             _rates(static, [0.8, 0.9]))
    want = np.asarray(jax.jit(lambda p, n, u, c: ref_pipeline.render_frame(
        static, p, n, cfg, part_textures=texs, uv_offsets=u,
        part_color=c))(pos, nrm, r_uv, r_pc))
    args = (rig, torch.as_tensor(pos), torch.as_tensor(nrm), _port_cfg(cfg))
    got = pipeline.render_frame(*args, part_textures=texs, uv_offsets=p_uv,
                                part_color=p_pc).numpy()
    _assert_frames_close(got[None], want[None], f"msaa={msaa}")
    plain = pipeline.render_frame(*args, part_textures=texs).numpy()
    assert (np.abs(got - plain) > 0.05).mean() > 0.01


@pytest.mark.parametrize("msaa,textured", [(1, True), (4, False)],
                         ids=["msaa1-textured-mips", "msaa4-untextured"])
def test_crowd_frame_with_morphs_matches_reference(content, msaa, textured):
    """Per-instance UV offsets [4, V, 2] ride the crowd's UVs (with the
    mip-chain atlas, each instance's rows) and per-instance part colours
    [4, P, 3] modulate each instance's albedo; untextured, the part colour
    alone (the reference's gate: no UV offsets without textures)."""
    static, rig, texs = content
    p0, n0 = np.asarray(static.positions), np.asarray(static.normals)
    pos = np.stack([p0, p0 + [2.0, 0.0, -1.0], p0 * [1.0, 0.9, 1.0],
                    p0 + [-2.0, 0.0, 1.0]]).astype(np.float32)
    nrm = np.stack([n0, n0, n0, n0])
    leaf = _rates(static, [[0.0, 1.0], [0.5, 0.3], [1.0, 0.0], [0.2, 0.7]])
    (r_uv, r_pc), (p_uv, p_pc) = _morph_args(static, rig, leaf)
    if not textured:
        texs = r_uv = p_uv = None
    cfg = RenderConfig(width=W, height=H, shadow_map_size=64, msaa=msaa,
                       show_skybox=False, raster_mode="tiled",
                       texture_mips=3 if textured else 0)
    atlas = (ref_pipeline.build_packed_atlas(texs, mip_levels=3) if textured
             else None)
    want = np.asarray(jax.jit(lambda p, n, u, c: ref_pipeline.
                              crowd_render_frame(
                                  static, p, n, cfg, part_textures=texs,
                                  atlas=atlas, uv_offsets=u, part_color=c))(
        pos, nrm, r_uv, r_pc))
    args = (rig, torch.as_tensor(pos), torch.as_tensor(nrm), _port_cfg(cfg))
    p_atlas = convert.packed_atlas(atlas, "cpu") if textured else None
    got = pipeline.crowd_render_frame(*args, part_textures=texs,
                                      atlas=p_atlas, uv_offsets=p_uv,
                                      part_color=p_pc).numpy()
    _assert_frames_close(got, want, f"crowd msaa={msaa}")
    plain = pipeline.crowd_render_frame(*args, part_textures=texs,
                                        atlas=p_atlas).numpy()
    moved = [float(np.abs(got[i] - plain[i]).max()) for i in range(4)]
    still = None if textured else 2     # untextured, only its UV morph
    assert min(m for i, m in enumerate(moved) if i != still) > 0.05, moved
    if not textured:
        assert moved[2] == 0.0
