"""The crowd rasters (K5a, K5b, K5c with their binning and merges): the
port's `rasterize_*_crowd` against the reference's.

The reference runs its Pallas kernels in interpret mode on the CPU and
bins in up to four validity-compacted passes that it merges in draw order;
the port bins all valid triangles of all instances in ONE pass and runs
the kernels' plain PyTorch versions (what the CUDA kernels are held
against on the card). Tolerances are tests/test_torch_raster.py's: depth
2e-5, triangle-id / barycentric mismatch below 1e-3 of pixels, attributes
1e-4 where the visibility agrees (XLA contracts the reference's
multiply-adds into FMAs, the port rounds each product), per-sample depth
2e-5 (with the same 1e-3 allowance of pixels, for samples on a sliver's
edge).

Targets: 256x128 is 2 x 4 = 8 tiles with `_crowd_e_max` = 6, so both
big-triangle merges are live; 128x64 is 2 tiles, covers-all.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.ops import tiled_raster as ref_tr
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import raster

from test_torch_raster import BIG, _random_mesh

import torch_threads  # noqa: F401  (the port's tests' thread cap)

W, H = 256, 128


def _crowd_mesh(seed, n_inst, t=120, big=(), dead=(), z=(0.1, 0.9), **kw):
    """n_inst random meshes over one topology: [I, V, 4] clip coordinates,
    [T, 3] triangles, [I, V, 3] attributes. Instances in `big` get a
    screen-filling last triangle (the others a degenerate one), those in
    `dead` lie behind the camera."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(n_inst):
        clip, tris = _random_mesh(rng, t=t, z=z, **kw)
        last = BIG if i in big else np.zeros_like(BIG)
        clip = np.concatenate([clip, last])
        if i in dead:
            clip[:, 3] = -1.0
        clips.append(clip)
    n = 3 * t
    tris = np.concatenate([tris, np.array([[n, n + 1, n + 2]], np.int32)])
    clip = np.stack(clips)
    attrs = rng.normal(size=clip.shape[:2] + (3,)).astype(np.float32)
    return clip, tris, attrs


def _assert_crowd_vis(vis, ref):
    """tests/test_torch_raster.py's `_assert_vis_equal` over [I, H, W]:
    -> the mask of pixels that agree."""
    np.testing.assert_allclose(vis.depth.numpy(), np.asarray(ref.depth),
                               atol=2e-5)
    same = (vis.tri.numpy() == np.asarray(ref.tri)) & (
        np.abs(vis.bary.numpy() - np.asarray(ref.bary)) <= 2e-5).all(-1)
    assert 1.0 - same.mean() < 1e-3, f"mismatch ratio {1.0 - same.mean()}"
    return same


def _corner_tables(clip, tris, attrs):
    g = np.concatenate([clip, attrs], -1)[:, tris]
    return g[..., :4], g[..., 4:]


def _both_attrs(clip, tris, attrs, w, h, cull, msaa=False, corners=False):
    kw_ref, kw = {}, {}
    if corners:
        cv, va = _corner_tables(clip, tris, attrs)
        kw_ref = dict(cv=jnp.asarray(cv), va=jnp.asarray(va))
        kw = dict(cv=torch.as_tensor(cv), va=torch.as_tensor(va))
    ref_fn = (ref_tr.rasterize_attrs_tiled_msaa_crowd if msaa
              else ref_tr.rasterize_attrs_tiled_crowd)
    fn = (tr.rasterize_attrs_tiled_msaa_crowd if msaa
          else tr.rasterize_attrs_tiled_crowd)
    ref = ref_fn(jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(attrs),
                 w, h, cull, 256, **kw_ref)
    got = fn(torch.as_tensor(clip), torch.as_tensor(tris),
             torch.as_tensor(attrs), w, h, cull, **kw)
    same = _assert_crowd_vis(got[0], ref[0])
    assert got[1].shape == clip.shape[:1] + (h, w, attrs.shape[-1])
    np.testing.assert_allclose(got[1].numpy()[same],
                               np.asarray(ref[1])[same], atol=1e-4)
    if msaa:
        sd, ref_sd = got[2].numpy(), np.asarray(ref[2])
        assert sd.shape == ref_sd.shape == clip.shape[:1] + (4, h, w)
        assert (np.abs(sd - ref_sd) > 2e-5).mean() < 1e-3
    return got


def _both_depth(clip, tris, w, h, cull, corners=False):
    kw_ref, kw = {}, {}
    if corners:
        cv = clip[:, tris]
        kw_ref, kw = dict(cv=jnp.asarray(cv)), dict(cv=torch.as_tensor(cv))
    ref = ref_tr.rasterize_depth_tiled_crowd(
        jnp.asarray(clip), jnp.asarray(tris), w, h, cull, 256, **kw_ref)
    got = tr.rasterize_depth_tiled_crowd(
        torch.as_tensor(clip), torch.as_tensor(tris), w, h, cull, **kw)
    assert got.shape == clip.shape[:1] + (h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    return got


def _n_valid(clip, tris, w, h, cull, sample_extent=0.0):
    s = raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), w, h,
                     cull, sample_extent=sample_extent)
    tile, _ = tr._expand_tiles(s, w, h, tr._crowd_e_max(w, h))
    return int((tile[..., 0] < tr._grid(w, h)[2]).sum())


@pytest.mark.parametrize("corners", [False, True], ids=["gather", "cv_va"])
@pytest.mark.parametrize("kind", ["attrs", "msaa", "depth"])
def test_crowd_raster_matches_reference(kind, corners):
    """Three instances at 256x128; instance 1 has an oversized triangle
    (both merges live, with an instance that has none beside it),
    instance 2 no valid triangle at all. With and without the
    pre-gathered corner tables."""
    clip, tris, attrs = _crowd_mesh(40, 3, big=(1,), dead=(2,))
    assert not tr._covers_all(tr._crowd_e_max(W, H), W, H)
    if kind == "depth":
        got = _both_depth(clip, tris, W, H, raster.CULL_NONE, corners)
        assert (got[2].numpy() == 1.0).all()
        assert (got[:2].numpy() < 1.0).mean() > 0.1
        # the big triangle (z 0.95) fills what the small ones leave
        assert (got[1].numpy() <= np.float32(0.95) + 1e-6).all()
        return
    got = _both_attrs(clip, tris, attrs, W, H, raster.CULL_NONE,
                      msaa=kind == "msaa", corners=corners)
    tri = got[0].tri.numpy()
    assert (tri[2] == -1).all() and (got[1][2].numpy() == 0).all()
    assert (tri[1] == tris.shape[0] - 1).any()      # the merge placed it
    assert (tri[0] != tris.shape[0] - 1).all()
    if kind == "msaa":
        # where the big triangle won, its depth bounds all four samples
        won = tri[1] == tris.shape[0] - 1
        assert (got[2][1].numpy()[:, won]
                <= got[0].depth[1].numpy()[won]).all()
        assert (got[2][2].numpy() == 1.0).all()


@pytest.mark.parametrize("kind", ["attrs", "msaa", "depth"])
def test_single_pass_binning_equals_reference_passes(kind):
    """More valid triangles than ceil(I*T/4): the reference bins them in
    more than one compaction pass and merges the passes; the port's one
    sort over all valid triangles gives the same frame."""
    clip, tris, attrs = _crowd_mesh(41, 4, t=150, spread=0.7, size=0.2)
    total = clip.shape[0] * tris.shape[0]
    extent = 0.375 if kind == "msaa" else 0.0
    n_valid = _n_valid(clip, tris, W, H, raster.CULL_NONE, extent)
    assert n_valid > 2 * math.ceil(total / ref_tr.CROWD_COMPACT_DIV), n_valid
    if kind == "depth":
        _both_depth(clip, tris, W, H, raster.CULL_NONE)
    else:
        _both_attrs(clip, tris, attrs, W, H, raster.CULL_NONE,
                    msaa=kind == "msaa")


@pytest.mark.parametrize("kind", ["attrs", "msaa"])
def test_z_ties_across_draw_order(kind):
    """Every triangle at one depth, so every overlap is a z-tie: the
    larger triangle id wins, in the reference across its passes (later
    passes hold higher ids) and in the port inside one tile loop."""
    clip, tris, attrs = _crowd_mesh(42, 2, t=150, spread=0.7, size=0.3,
                                    z=(0.5, 0.5), big=(0,))
    got = _both_attrs(clip, tris, attrs, W, H, raster.CULL_NONE,
                      msaa=kind == "msaa")
    # instance 0's big triangle (the last id, z 0.95) loses to every
    # small one; overlaps exist: fewer pixels than the triangles' areas sum
    tri = got[0].tri.numpy()
    assert (tri >= 0).mean() > 0.3


@pytest.mark.parametrize("cull", [raster.CULL_BACK, raster.CULL_FRONT],
                         ids=["back", "front"])
def test_crowd_raster_culls_like_reference(cull):
    """Face culling at the covers-all size (128x64: two tiles, no merge)."""
    clip, tris, attrs = _crowd_mesh(43 + cull, 2)
    assert tr._covers_all(tr._crowd_e_max(128, 64), 128, 64)
    _both_attrs(clip, tris, attrs, 128, 64, cull)
    _both_depth(clip, tris, 128, 64, cull)


def _crowd_bins(clip, tris, attrs, w, h, sample_extent=0.0):
    s, rows = tr._crowd_setup(torch.as_tensor(clip), torch.as_tensor(tris),
                              None if attrs is None else
                              torch.as_tensor(attrs), w, h, raster.CULL_NONE,
                              None, None, None, sample_extent)
    return tr._bin_crowd(s, rows, w, h)[:3]


def test_crowd_plain_folds_to_the_single_instance_plain():
    """The fold: instance i's planes from the crowd's plain versions equal,
    bit for bit, the single-instance plain versions on that instance's own
    bins (its tiles' starts/counts cut out of the global ones)."""
    clip, tris, attrs = _crowd_mesh(44, 3, big=(0,), dead=(1,))
    n_inst = clip.shape[0]
    n_tiles = tr._grid(W, H)[2]
    for ms in (False, True):
        rows, starts, counts = _crowd_bins(clip, tris, attrs, W, H,
                                           0.375 if ms else 0.0)
        assert counts.shape[0] == n_inst * n_tiles
        multi_fn = (tr.raster_tiles_ms_multi_plain if ms
                    else tr.raster_tiles_multi_plain)
        single_fn = tr.raster_tiles_ms_plain if ms else tr.raster_tiles_plain
        multi = multi_fn(rows, starts, counts, n_inst, W, H, 3)
        depth = tr.depth_tiles_multi_plain(rows, starts, counts, n_inst, W, H)
        for i in range(n_inst):
            sl = slice(i * n_tiles, (i + 1) * n_tiles)
            st_i = torch.cat([starts[sl], starts[sl][-1:] + counts[sl][-1:]])
            single = single_fn(rows, st_i, counts[sl], W, H, 3)
            for a, b in zip(multi, single):
                assert torch.equal(a[i], b)
            assert torch.equal(depth[i], tr.depth_tiles_plain(
                rows, st_i, counts[sl], W, H))
    assert int(counts[n_tiles:2 * n_tiles].sum()) == 0     # the dead one


def test_crowd_bins_hold_every_valid_triangle_once_in_draw_order():
    """One pass: every (valid triangle, covered tile) pair is one entry;
    within a global tile the entries ascend in triangle id."""
    clip, tris, _ = _crowd_mesh(45, 3, big=(2,))
    rows, starts, counts = _crowd_bins(clip, tris, None, W, H)
    s = raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), W, H,
                     raster.CULL_NONE)
    tile, big = tr._expand_tiles(s, W, H, tr._crowd_e_max(W, H))
    n_tiles = tr._grid(W, H)[2]
    assert int(counts.sum()) == int((tile < n_tiles).sum())
    # the rows past the last tile's entries are the valid triangles' unused
    # slots, which no tile owns
    n_valid = int((tile[..., 0] < n_tiles).sum())
    assert rows.shape[0] == n_valid * tile.shape[-1]
    assert int(starts[-1]) == int(counts.sum())
    assert bool(big[2, -1]) and int(big.sum()) == 1
    for g in range(counts.shape[0]):
        ids = rows[starts[g]:starts[g] + counts[g], 10]
        assert bool((ids[1:] > ids[:-1]).all())
    per_inst = counts.reshape(3, n_tiles).sum(1)
    assert [int(v) for v in per_inst] == [
        int((tile[i] < n_tiles).sum()) for i in range(3)]


@pytest.mark.parametrize("msaa", [False, True], ids=["K5a", "K5b"])
def test_crowd_rasters_with_nocull_equal_the_single_instance_ones(msaa):
    """Double-sided triangles (a shared `nocull` mask over half of them):
    per instance the crowd raster equals the single-instance raster with
    the same mask bit for bit (visibility, attributes and per-sample
    depth), both windings are binned, and the crowd matches the
    reference's crowd raster with that mask (the module's tolerances)."""
    clip, tris, attrs = _crowd_mesh(46, 2, t=60, big=(1,))
    nocull = np.zeros(tris.shape[0], bool)
    nocull[::2] = True
    w, h = 128, 64
    fn = (tr.rasterize_attrs_tiled_msaa_crowd if msaa
          else tr.rasterize_attrs_tiled_crowd)
    single_fn = (tr.rasterize_attrs_tiled_msaa if msaa
                 else tr.rasterize_attrs_tiled)
    nc = torch.as_tensor(nocull)
    got = fn(torch.as_tensor(clip), torch.as_tensor(tris),
             torch.as_tensor(attrs), w, h, raster.CULL_BACK, nocull=nc)
    culled = fn(torch.as_tensor(clip), torch.as_tensor(tris),
                torch.as_tensor(attrs), w, h, raster.CULL_BACK)
    assert int((got[0].tri >= 0).sum()) > int((culled[0].tri >= 0).sum())
    for i in range(clip.shape[0]):
        one = single_fn(torch.as_tensor(clip[i]), torch.as_tensor(tris),
                        torch.as_tensor(attrs[i]), w, h, raster.CULL_BACK,
                        tr._crowd_e_max(w, h), compact=False, nocull=nc)
        for a, b in zip((got[0].depth, got[0].tri, got[0].bary, *got[1:]),
                        (one[0].depth, one[0].tri, one[0].bary, *one[1:])):
            assert torch.equal(a[i], b), i
    ref_fn = (ref_tr.rasterize_attrs_tiled_msaa_crowd if msaa
              else ref_tr.rasterize_attrs_tiled_crowd)
    ref = ref_fn(jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(attrs),
                 w, h, raster.CULL_BACK, 256, nocull=jnp.asarray(nocull))
    same = _assert_crowd_vis(got[0], ref[0])
    np.testing.assert_allclose(got[1].numpy()[same],
                               np.asarray(ref[1])[same], atol=1e-4)
