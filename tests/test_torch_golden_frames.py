"""The port's frames against the golden PNGs of tests/test_golden_frames.py.

The seven configurations of that test (the sample character at density
0.5, rest pose, 192x144, shadow 128^2, the fixed camera; flat, textured,
4x MSAA, toon + sphere maps, edges, double-sided, skybox), built the same
way from the port's own modules (`app.sample`, `core.model.build_model`,
`render.ibl.equirect_to_cubemap`) and rendered by the port's
`render_frame` with the reference's raster on the CPU, the exact scan
raster (`raster_mode="scan"`, which the reference's "auto" picks off the
TPU), are held to the PNGs by that test's own criterion: mean absolute
difference below 1.0 (of 255) and fewer than 0.002 of the pixels off by
more than 8/255. Measured: every frame within 1.3e-5 of the PNGs in mean,
no pixel beyond 8/255. The PNGs are the reference: no JAX render runs
here. The drift meta-case: a 5 % drift of the port's shaded colour must
fail the same comparison.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu_torch.app.sample import (sample_character,
                                                      sample_textures)
from simple_mmd_renderer_tpu_torch.config import RenderConfig
from simple_mmd_renderer_tpu_torch.core.model import ModelTables, build_model
from simple_mmd_renderer_tpu_torch.render import ibl, shade
from simple_mmd_renderer_tpu_torch.render.pipeline import render_frame

from test_golden_frames import CONFIGS, GOLDEN_DIR, H, W, _CAM, _mmd_maps


def _cubemap():
    """The golden test's synthetic equirect, through the port's cubemap
    builder."""
    h, w = 16, 32
    eq = np.zeros((h, w, 3), np.float32)
    eq[:, :, 0] = np.linspace(0.1, 1.2, w, dtype=np.float32)[None, :]
    eq[:, :, 1] = np.linspace(1.0, 0.1, h, dtype=np.float32)[:, None]
    eq[:, :, 2] = 0.4
    return ibl.equirect_to_cubemap(torch.as_tensor(eq), 32, device="cpu")


def _render(name):
    """The golden test's `_render` of configuration `name`, on the port."""
    static = build_model(sample_character(density=0.5))
    kw = {}
    cfg_kw = dict(width=W, height=H, shadow_map_size=128, show_skybox=False,
                  raster_mode="scan", **_CAM)
    if name == "textured":
        kw["part_textures"] = sample_textures((128, 64))
    elif name == "msaa4":
        cfg_kw["msaa"] = 4
    elif name == "toon_sph":
        kw["part_textures"] = sample_textures((128, 64))
        kw["mmd_maps"] = _mmd_maps(static)
    elif name == "edges":
        cfg_kw["show_edges"] = True
    elif name == "double_sided":
        cfg_kw["double_sided"] = True
        static.nocull_tris[: len(static.nocull_tris) // 2] = True
    elif name == "skybox":
        cfg_kw["show_skybox"] = True
        kw["cubemap"] = _cubemap()
    img = render_frame(ModelTables(static, "cpu"),
                       torch.as_tensor(np.asarray(static.positions,
                                                  np.float32)),
                       torch.as_tensor(np.asarray(static.normals, np.float32)),
                       RenderConfig(**cfg_kw), **kw)
    return np.asarray(np.clip(img.numpy() * 255.0 + 0.5, 0, 255), np.uint8)


def _golden(name):
    from PIL import Image
    return np.asarray(Image.open(f"{GOLDEN_DIR}/{name}.png").convert("RGB"))


def _passes(got, want):
    """The golden test's criterion."""
    assert want.shape == got.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return diff.mean() < 1.0 and (diff.max(-1) > 8).mean() < 0.002


@pytest.mark.parametrize("name", CONFIGS)
def test_golden_frame(name):
    got, want = _render(name), _golden(name)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert _passes(got, want), (
        f"{name}: mean abs diff {diff.mean():.3f}, >8/255 fraction "
        f"{(diff.max(-1) > 8).mean():.4f}")


def test_golden_detects_shading_drift(monkeypatch):
    """A 5 % drift of the shaded character colour (applied to the output:
    the flat configuration's white character saturates) must fail the
    comparison on the textured frame."""
    orig = shade.shade_character

    def drifted(albedo, *a, **k):
        return orig(albedo, *a, **k) * 0.95

    monkeypatch.setattr(shade, "shade_character", drifted)
    assert not _passes(_render("textured"), _golden("textured")), \
        "a 5% shading drift must trip the golden comparison"
