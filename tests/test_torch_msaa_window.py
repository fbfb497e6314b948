"""Kernels K4 (4x MSAA visibility and per-sample depth) and K6 (shadow
depth over the casters' tile window) with their binning and entry points:
the port's `rasterize_attrs_tiled_msaa`, `rasterize_depth_tiled_window` and
`shadow_pass(window=True)` against the reference's.

The reference runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain PyTorch versions (what the CUDA kernels are checked
against on the card). Tolerances:

- visibility as tests/test_torch_raster.py (the reference's own
  `_assert_vis_equal`: depth 2e-5, triangle-id mismatch below 1e-3 of
  pixels, barycentrics 2e-5), attributes 1e-4 where the visibility agrees
  (XLA contracts the reference's plane arithmetic into FMAs; measured here
  up to 9.9e-5 on the compacted mesh, 4.4e-5 elsewhere);
- per-sample depth 2e-5 where both cover the sample (a sample is covered
  where its depth is below 1 - 1e-7, as the frame's resolve reads it), with
  fewer than 1e-3 of samples differing in coverage (measured: 0, and at
  most 1.2e-7 in depth);
- windowed depth atol 2e-5 (the reference's own test); bit-exact against
  the port's own `rasterize_depth_tiled` wherever no triangle falls to the
  big-triangle merge at either tile grid (at 8-row tiles a triangle taller
  than ~44 px does, and the merge's scan rounds differently).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.ops import tiled_raster as ref_tr
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import pipeline, raster

from test_torch_raster import _assert_vis_equal, _random_mesh, _with_big

import torch_threads  # noqa: F401  (the port's tests' thread cap)

CULLS = [raster.CULL_NONE, raster.CULL_BACK, raster.CULL_FRONT]


def _both_msaa(clip, tris, attrs, w, h, cull, e_max, chunk=256):
    ref_vis, ref_attr, ref_sd = ref_tr.rasterize_attrs_tiled_msaa(
        jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(attrs), w, h, cull,
        e_max, chunk)
    vis, attr, sdepth = tr.rasterize_attrs_tiled_msaa(
        torch.as_tensor(clip), torch.as_tensor(tris), torch.as_tensor(attrs),
        w, h, cull, e_max)
    assert sdepth.shape == (4, h, w)
    same = _assert_vis_equal(vis, ref_vis)
    np.testing.assert_allclose(attr.numpy()[same], np.asarray(ref_attr)[same],
                               atol=1e-4)
    sd, ref_sd = sdepth.numpy(), np.asarray(ref_sd)
    cov, ref_cov = sd < 1.0 - 1e-7, ref_sd < 1.0 - 1e-7
    assert (cov != ref_cov).mean() < 1e-3
    np.testing.assert_allclose(sd[cov & ref_cov], ref_sd[cov & ref_cov],
                               atol=2e-5)
    return vis, sdepth


@pytest.mark.parametrize("cull", CULLS, ids=["none", "back", "front"])
def test_msaa_raster_matches_reference(cull):
    """256x128, e_max 8: covers-all binning (8 tiles), no merge."""
    rng = np.random.default_rng(40 + cull)
    clip, tris = _random_mesh(rng, t=200)
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    vis, sdepth = _both_msaa(clip, tris, attrs, 256, 128, cull, 8)
    covered = vis.tri.numpy() >= 0
    assert covered.mean() > 0.1
    # any-sample coverage: some pixel wins without covering its centre
    # (an edge pixel), and every covered sample's pixel has a triangle
    assert (sdepth.numpy() < 1.0).any(0)[~covered].sum() == 0


def test_msaa_big_triangle_merge_matches_reference():
    """384x256 with e_max 6 (24 tiles): the big triangle goes through the
    big-triangle merge, whose centre depth bounds the four samples where
    it wins."""
    rng = np.random.default_rng(46)
    clip, tris = _with_big(*_random_mesh(rng, t=40))
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    assert not tr._covers_all(6, 384, 256)
    vis, sdepth = _both_msaa(clip, tris, attrs, 384, 256, raster.CULL_NONE,
                             6)
    big = vis.tri.numpy() == 40
    assert big.mean() > 0.1
    assert (sdepth.numpy()[:, big] <= vis.depth.numpy()[big]).all()


def test_msaa_compacted_binning_matches_reference():
    """T >= 4096: both sides compact the valid triangles before binning;
    back-face culling leaves about half."""
    rng = np.random.default_rng(47)
    clip, tris = _random_mesh(rng, t=4200, size=0.05)
    assert tris.shape[0] >= tr.COMPACT_MIN_T
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    _both_msaa(clip, tris, attrs, 256, 192, raster.CULL_BACK, 6)


def test_msaa_dense_tile_and_edge_ties_match_reference():
    """Hundreds of entries in one tile at one depth (every overlap a
    z-tie), and a mesh at zp = 1 whose edge entries carry the biased depth
    3.0, equal to the clear: they win it on the id rule on both sides."""
    rng = np.random.default_rng(48)
    clip, tris = _random_mesh(rng, t=500, spread=0.05, size=0.08,
                              z=(0.5, 0.5))
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    _both_msaa(clip, tris, attrs, 128, 64, raster.CULL_NONE, 6, chunk=32)
    clip, tris = _random_mesh(rng, t=150, z=(1.0, 1.0))
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    vis, _ = _both_msaa(clip, tris, attrs, 256, 128, raster.CULL_NONE, 8)
    assert (vis.tri.numpy() >= 0).mean() > 0.1


def test_msaa_bins_use_the_widened_sample_cull():
    """A sliver between pixel-centre rows is culled at msaa=1 but binned at
    msaa=4 (its samples at +-0.375 px can hit it), on both sides."""
    # triangle spanning y in [10.6, 10.9] px: no centre row, but samples
    y0, y1 = 1 - 2 * 10.6 / 64, 1 - 2 * 10.9 / 64
    clip = np.array([[-0.9, y0, 0.5, 1], [0.9, y0, 0.5, 1],
                     [0.0, y1, 0.5, 1]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    attrs = np.ones((3, 3), np.float32)
    s0 = raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), 128, 64,
                      raster.CULL_NONE)
    s1 = raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), 128, 64,
                      raster.CULL_NONE, sample_extent=0.375)
    assert not bool(s0["valid"][0]) and bool(s1["valid"][0])
    vis, sdepth = _both_msaa(clip, tris, attrs, 128, 64, raster.CULL_NONE, 8)
    assert (sdepth.numpy() < 1.0).any()


def _clustered(rng):
    clip, tris = _random_mesh(rng, t=150, spread=0.3, size=0.1)
    clip[:, 0] = clip[:, 0] * 0.4 - 0.55
    clip[:, 1] = clip[:, 1] * 0.4 + 0.55
    return clip, tris


def _window_meshes():
    rng = np.random.default_rng(23)
    clustered = _clustered(rng)
    spread = _random_mesh(rng, t=150, size=0.08)
    return {"clustered": clustered, "spread": spread,
            "big": _with_big(*spread)}


@pytest.mark.parametrize("mesh", ["clustered", "spread", "big"])
@pytest.mark.parametrize("tile_h", [8, 32])
def test_window_depth_matches_reference(mesh, tile_h):
    """512^2, e_max 6, casters clustered in one corner (a small window),
    spread (the whole grid) and with a screen-filling triangle (the merge),
    culling none and front faces."""
    clip, tris = _window_meshes()[mesh]
    for cull in (raster.CULL_NONE, raster.CULL_FRONT):
        ref = ref_tr.rasterize_depth_tiled_window(
            jnp.asarray(clip), jnp.asarray(tris), 512, 512, cull, 6, 64,
            tile_h)
        got = tr.rasterize_depth_tiled_window(
            torch.as_tensor(clip), torch.as_tensor(tris), 512, 512, cull, 6,
            64, tile_h)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
        assert (got.numpy() < 1.0).mean() > 0.002
    if mesh == "clustered":     # a window of at most 1/8 of the tiles
        _, _, rows, cols = tr._caster_window(
            raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), 512,
                         512, raster.CULL_NONE), 512, 512, tile_h).tolist()
        tiles_x, _, n_tiles = tr._grid(512, 512, tile_h)
        assert 0 < rows * cols <= n_tiles // 8 and cols < tiles_x


@pytest.mark.parametrize("mesh,tile_h", [("clustered", 8), ("clustered", 32),
                                         ("spread", 32), ("big", 32)])
def test_window_depth_equals_full_raster(mesh, tile_h):
    """Where no triangle is big at either grid, the windowed map is the
    full tiled raster's, bit for bit (window tiles get K1's bits, and no
    entry lies outside the window)."""
    clip, tris = _window_meshes()[mesh]
    c, t = torch.as_tensor(clip), torch.as_tensor(tris)
    for cull in (raster.CULL_NONE, raster.CULL_FRONT):
        got = tr.rasterize_depth_tiled_window(c, t, 512, 512, cull, 6,
                                              tile_h=tile_h)
        assert torch.equal(got, tr.rasterize_depth_tiled(c, t, 512, 512,
                                                         cull, 6))


def test_window_depth_empty_scene():
    """No valid caster: an empty window and an all-1.0 map, on both
    sides."""
    clip = np.array([[0.0, 0.0, -5.0, 1.0]] * 3, np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    ref = ref_tr.rasterize_depth_tiled_window(
        jnp.asarray(clip), jnp.asarray(tris), 256, 256, raster.CULL_NONE, 6,
        64, 8)
    got = tr.rasterize_depth_tiled_window(
        torch.as_tensor(clip), torch.as_tensor(tris), 256, 256,
        raster.CULL_NONE, 6, 64, 8)
    assert (np.asarray(ref) == 1.0).all() and bool((got == 1.0).all())


def test_shadow_pass_window_at_1024_matches_reference(monkeypatch):
    """shadow_pass(window=True) takes the windowed raster only at maps of
    at least 1024^2 (here: 8 x 32 tiles of 32 rows); a 256^2 map takes the
    full raster. Both equal the reference's shadow_pass."""
    rng = np.random.default_rng(50)
    verts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    verts[:, 1] += 1.0
    tris = rng.integers(0, 300, (100, 3)).astype(np.int32)
    light = np.array(ref_pipeline.build_matrices(RenderConfig())["light_mvp"])
    calls = {"window": 0, "full": 0}

    def spy(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(tr, "rasterize_depth_tiled_window",
                        spy("window", tr.rasterize_depth_tiled_window))
    monkeypatch.setattr(tr, "rasterize_depth_tiled",
                        spy("full", tr.rasterize_depth_tiled))
    for size, want in ((1024, {"window": 1, "full": 0}),
                       (256, {"window": 0, "full": 1})):
        calls.update(window=0, full=0)
        ref = ref_pipeline.shadow_pass(
            jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(light), size,
            ref_tr.rasterize_tiled, True)
        got = pipeline.shadow_pass(torch.as_tensor(verts),
                                   torch.as_tensor(tris),
                                   torch.as_tensor(light), size,
                                   tr.rasterize_tiled, True)
        assert calls == want, size
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
        assert (got.numpy() < 1.0).any()
