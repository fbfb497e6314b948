"""Kernels K1 (shadow depth) and K2 (visibility + attributes) with their
binning: the port's tiled raster vs the reference's.

The reference runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain PyTorch versions (what the CUDA kernels are checked
against on the card). Tolerances are the reference's own
(`tests/test_tiled_raster.py::_assert_vis_equal`): depth atol 2e-5, triangle
id mismatch below 1e-3 of pixels, barycentrics atol 2e-5 (see
`_assert_vis_equal` for the one allowance).

Attributes are compared at atol 1e-4 where the visibility agrees, not 1e-5:
XLA's jit contracts the reference's plane-slope and plane-evaluation
multiply-adds into fused multiply-adds, the port rounds each product (as
its CUDA kernels do, bit-exactly). Measured over these cases: at most 71
pixels of 49,152 beyond 1e-5, largest difference 4.5e-5, none beyond 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.ops import tiled_raster as ref_tr
from simple_mmd_renderer_tpu.render import raster as ref_raster
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import raster

import torch_threads  # noqa: F401  (the port's tests' thread cap)

CULLS = [raster.CULL_NONE, raster.CULL_BACK, raster.CULL_FRONT]
BIG = np.array([[-3, -3, 0.95, 1], [3, -3, 0.95, 1], [0, 3, 0.95, 1]],
               np.float32)


def _random_mesh(rng, t=200, spread=0.9, z=(0.1, 0.9), size=0.25):
    """As tests/test_tiled_raster.py: t independent triangles in clip
    space, one random depth each."""
    v0 = rng.uniform(-spread, spread, (t, 2))
    d1 = rng.uniform(-size, size, (t, 2))
    d2 = rng.uniform(-size, size, (t, 2))
    verts = np.stack([v0, v0 + d1, v0 + d2], 1).reshape(-1, 2)
    zs = rng.uniform(*z, (t, 1)).repeat(3, 1).reshape(-1)
    clip = np.concatenate(
        [verts, zs[:, None], np.ones((t * 3, 1))], -1).astype(np.float32)
    tris = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    return clip, tris


def _with_big(clip, tris):
    n = clip.shape[0]
    return (np.concatenate([clip, BIG]),
            np.concatenate([tris, np.array([[n, n + 1, n + 2]], np.int32)]))


def _assert_vis_equal(got, ref):
    """The reference's `_assert_vis_equal`, with one allowance: XLA's jit
    contracts the setup's 2x2 area determinant into a fused multiply-add,
    which the port (like the reference run eagerly) does not. For sliver
    triangles that moves the barycentric planes by more than 2e-5 at a
    handful of pixels (measured: at most 2 pixels of 61,440 here, by up to
    2.6e-4), so such pixels count toward the same 1e-3 allowance as
    triangle-id mismatches. Returns the mask of pixels that agree."""
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=2e-5)
    same_tri = got.tri.numpy() == np.asarray(ref.tri)
    bary_ok = (np.abs(got.bary.numpy() - np.asarray(ref.bary))
               <= 2e-5).all(-1)
    same = same_tri & bary_ok
    mism = 1.0 - same.mean()
    assert mism < 1e-3, f"tri id / barycentric mismatch ratio {mism}"
    return same


def _both_attrs(clip, tris, attrs, w, h, cull, e_max, chunk=256):
    ref_vis, ref_attr = ref_tr.rasterize_attrs_tiled(
        jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(attrs), w, h, cull,
        e_max, chunk)
    vis, attr = tr.rasterize_attrs_tiled(
        torch.as_tensor(clip), torch.as_tensor(tris), torch.as_tensor(attrs),
        w, h, cull, e_max, chunk)
    same = _assert_vis_equal(vis, ref_vis)
    np.testing.assert_allclose(attr.numpy()[same], np.asarray(ref_attr)[same],
                               atol=1e-4)
    return vis


def _both_depth(clip, tris, w, h, cull, e_max, chunk=256):
    ref = ref_tr.rasterize_depth_tiled(jnp.asarray(clip), jnp.asarray(tris),
                                       w, h, cull, e_max, chunk)
    got = tr.rasterize_depth_tiled(torch.as_tensor(clip),
                                   torch.as_tensor(tris), w, h, cull, e_max,
                                   chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    return got


def _back_facing_half(t=300, seed=41):
    """A mesh for 96x96 whose even triangles face away (wound so that
    back-face culling drops them) and are marked double-sided: (clip,
    tris, nocull [t] bool)."""
    rng = np.random.default_rng(seed)
    clip, tris = _random_mesh(rng, t=t, size=0.2)
    c = torch.as_tensor(clip)
    front = raster.setup(c, torch.as_tensor(tris), 96, 96,
                         raster.CULL_BACK)["valid"].numpy()
    seen = raster.setup(c, torch.as_tensor(tris), 96, 96,
                        raster.CULL_NONE)["valid"].numpy()
    even = np.arange(t) % 2 == 0
    flip = even == front        # even and front-facing, or odd and back
    tris[flip] = tris[flip][:, ::-1]
    nocull = even & seen
    return clip, tris, nocull


def test_depth_tiled_nocull_matches_reference():
    """`rasterize_depth_tiled(..., nocull=)` at 96x96: 300 triangles, half
    of them back-facing and double-sided, culled back. The port equals the
    reference's (Pallas K1 in interpret mode) at the depth tolerance
    (2e-5; measured 0), and the exemption shows: the double-sided
    triangles are drawn, and the map differs from the one without it."""
    clip, tris, nocull = _back_facing_half()
    assert nocull.sum() > 100
    ref = ref_tr.rasterize_depth_tiled(
        jnp.asarray(clip), jnp.asarray(tris), 96, 96, raster.CULL_BACK, 9,
        256, jnp.asarray(nocull))
    got = tr.rasterize_depth_tiled(
        torch.as_tensor(clip), torch.as_tensor(tris), 96, 96,
        raster.CULL_BACK, 9, 256, torch.as_tensor(nocull))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    culled = tr.rasterize_depth_tiled(
        torch.as_tensor(clip), torch.as_tensor(tris), 96, 96,
        raster.CULL_BACK)
    drawn = got.numpy() < 1.0
    assert drawn.mean() > 0.3
    assert (got.numpy() < culled.numpy()).mean() > 0.1


def _entry_case(name):
    """(entry point, reference-form positional args, the same call by
    keyword) for each of the eight tiled entry points, on a 160x96 mesh
    with a big triangle (the merge runs at e_max 2) and every other
    triangle double-sided where the entry takes `nocull`."""
    rng = np.random.default_rng(43)
    clip, tris = _with_big(*_random_mesh(rng, t=80, size=0.2))
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    c, t, a = map(torch.as_tensor, (clip, tris, attrs))
    nocull = torch.arange(t.shape[0]) % 2 == 0
    w, h, cull = 160, 96, raster.CULL_BACK
    g = torch.cat([c, a], -1)[t.long()]
    cv, va = g[..., :4], g[..., 4:]
    crowd = torch.stack([c, c * torch.tensor([0.5, 0.5, 1.0, 1.0])])
    crowd_a = torch.stack([a, -a])
    gc = torch.cat([crowd, crowd_a], -1)[:, t.long()]
    ccv, cva = gc[..., :4], gc[..., 4:]
    return {
        "rasterize_depth_tiled": (
            (c, t, w, h, cull, 2, 64, nocull, False, cv),
            dict(clip=c, tris=t, width=w, height=h, cull=cull, e_max=2,
                 nocull=nocull, compact=False, cv=cv)),
        "rasterize_tiled": (
            (c, t, w, h, cull, 2, 64, False),
            dict(clip=c, tris=t, width=w, height=h, cull=cull, e_max=2,
                 compact=False)),
        "rasterize_attrs_tiled": (
            (c, t, a, w, h, cull, 2, 64, nocull, False, cv, va),
            dict(clip=c, tris=t, attrs=a, width=w, height=h, cull=cull,
                 e_max=2, nocull=nocull, compact=False, cv=cv, va=va)),
        "rasterize_attrs_tiled_msaa": (
            (c, t, a, w, h, cull, 2, 64, nocull, False, cv, va),
            dict(clip=c, tris=t, attrs=a, width=w, height=h, cull=cull,
                 e_max=2, nocull=nocull, compact=False, cv=cv, va=va)),
        "rasterize_depth_tiled_window": (
            (c, t, w, h, cull, 2, 64, 32, cv),
            dict(clip=c, tris=t, width=w, height=h, cull=cull, e_max=2,
                 tile_h=32, cv=cv)),
        "rasterize_attrs_tiled_crowd": (
            (crowd, t, crowd_a, w, h, cull, 64, ccv, cva, nocull),
            dict(clip=crowd, tris=t, attrs=crowd_a, width=w, height=h,
                 cull=cull, cv=ccv, va=cva, nocull=nocull)),
        "rasterize_attrs_tiled_msaa_crowd": (
            (crowd, t, crowd_a, w, h, cull, 64, ccv, cva, nocull),
            dict(clip=crowd, tris=t, attrs=crowd_a, width=w, height=h,
                 cull=cull, cv=ccv, va=cva, nocull=nocull)),
        "rasterize_depth_tiled_crowd": (
            (crowd, t, w, h, raster.CULL_FRONT, 64, ccv),
            dict(clip=crowd, tris=t, width=w, height=h,
                 cull=raster.CULL_FRONT, cv=ccv)),
    }[name]


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, raster.VisBuffer):
        return [out.depth, out.tri, out.bary]
    return [x for o in out for x in _leaves(o)]


ENTRY_POINTS = ["rasterize_depth_tiled", "rasterize_tiled",
                "rasterize_attrs_tiled", "rasterize_attrs_tiled_msaa",
                "rasterize_depth_tiled_window", "rasterize_attrs_tiled_crowd",
                "rasterize_attrs_tiled_msaa_crowd",
                "rasterize_depth_tiled_crowd"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_takes_the_reference_positional_form(name):
    """Each tiled entry point called positionally in the reference's
    parameter order (`chunk` at its place, here 64) gives the same bits as
    the same call by keyword (`chunk` at its default of 256) and at chunk
    8; a `chunk` the reference asserts against (not a positive multiple of
    its GROUP of 8) raises ValueError naming it."""
    fn = getattr(tr, name)
    args, kw = _entry_case(name)
    want = _leaves(fn(**kw))
    for got in (fn(*args), fn(**kw, chunk=8)):
        got = _leaves(got)
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert bool((want[0] < 1.0).any())
    for bad in (12, 0, -8, 64.0):
        with pytest.raises(ValueError, match="chunk"):
            fn(**kw, chunk=bad)


@pytest.mark.parametrize("cull", CULLS, ids=["none", "back", "front"])
def test_attrs_tiled_matches_reference(cull):
    rng = np.random.default_rng(20 + cull)
    clip, tris = _random_mesh(rng, t=300)
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    vis = _both_attrs(clip, tris, attrs, 320, 192, cull, 9)
    assert (vis.tri.numpy() >= 0).mean() > 0.1   # the scene has coverage


@pytest.mark.parametrize("cull", CULLS, ids=["none", "back", "front"])
def test_depth_tiled_matches_reference(cull):
    rng = np.random.default_rng(30 + cull)
    clip, tris = _random_mesh(rng, t=300)
    got = _both_depth(clip, tris, 320, 192, cull, 9)
    assert (got.numpy() < 1.0).mean() > 0.1


def test_dense_tile_beyond_chunk_matches_reference():
    """Hundreds of entries in one tile: more than the reference's streaming
    chunk (32 here) and than the CUDA kernel's shared-memory chunk (256)."""
    rng = np.random.default_rng(12)
    clip, tris = _random_mesh(rng, t=500, spread=0.05, size=0.08)
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    t = torch.as_tensor(tris)
    s = raster.setup(torch.as_tensor(clip), t, 128, 64, raster.CULL_NONE)
    rows = tr._setup_rows(s, torch.arange(t.shape[0]))
    _, _, counts, _ = tr._bin(s, rows, 128, 64, 6, False)
    assert int(counts.max()) > 256, "scene must overload the chunks"
    _both_attrs(clip, tris, attrs, 128, 64, raster.CULL_NONE, 6, chunk=32)
    _both_depth(clip, tris, 128, 64, raster.CULL_NONE, 6, chunk=32)


def test_big_triangle_merge_matches_reference():
    """384x256 with e_max 6: 24 tiles, so the screen-filling triangle goes
    through the big-triangle merge (not covers-all)."""
    rng = np.random.default_rng(16)
    clip, tris = _with_big(*_random_mesh(rng, t=40))
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    assert not tr._covers_all(6, 384, 256)
    vis = _both_attrs(clip, tris, attrs, 384, 256, raster.CULL_NONE, 6)
    assert (vis.tri.numpy() == 40).any()
    _both_depth(clip, tris, 384, 256, raster.CULL_NONE, 6)


def test_covers_all_renders_giant_triangle_through_bins():
    """256x128 = 8 tiles with e_max 8: the big triangle is binned into every
    tile and the merge is skipped."""
    rng = np.random.default_rng(15)
    clip, tris = _with_big(*_random_mesh(rng, t=60))
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    assert tr._covers_all(8, 256, 128)
    vis = _both_attrs(clip, tris, attrs, 256, 128, raster.CULL_NONE, 8)
    assert (vis.tri.numpy() == 60).any()


def test_compacted_binning_matches_reference():
    """T >= 4096: both sides compact the valid triangle ids before binning
    (the port with a boolean mask, the reference through its prefix
    ladder); back-face culling leaves about half valid."""
    rng = np.random.default_rng(17)
    clip, tris = _random_mesh(rng, t=4200, size=0.05)
    assert tris.shape[0] >= tr.COMPACT_MIN_T
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    _both_attrs(clip, tris, attrs, 256, 192, raster.CULL_BACK, 6)
    _both_depth(clip, tris, 256, 192, raster.CULL_FRONT, 6)


def test_bins_and_rows_match_reference():
    """The binning itself: setup rows equal to float rounding, and the
    per-tile starts/counts equal to the reference's (same 32x128 tiles)."""
    rng = np.random.default_rng(18)
    clip, tris = _random_mesh(rng, t=300)
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    w, h, e_max = 320, 192, 6
    rs = ref_raster.setup(jnp.asarray(clip), jnp.asarray(tris), w, h,
                          ref_raster.CULL_BACK)
    rs["tris_v"] = jnp.asarray(tris)
    ref_rows = ref_tr._setup_rows(rs, jnp.arange(300), jnp.asarray(attrs))
    _, ref_starts, ref_counts, ref_big = ref_tr._bin(rs, ref_rows, w, h,
                                                     e_max, 256)
    s = raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), w, h,
                     raster.CULL_BACK)
    s["tris_v"] = torch.as_tensor(tris)
    rows = tr._setup_rows(s, torch.arange(300), torch.as_tensor(attrs))
    np.testing.assert_allclose(rows.numpy(), np.asarray(ref_rows),
                               rtol=1e-5, atol=1e-5)
    for compact in (False, True):
        _, starts, counts, big = tr._bin(s, rows, w, h, e_max, compact)
        assert np.array_equal(starts.numpy(), np.asarray(ref_starts))
        assert np.array_equal(counts.numpy(), np.asarray(ref_counts))
        assert np.array_equal(big.numpy(), np.asarray(ref_big))


def test_empty_frame_matches_reference():
    """Every triangle culled (compaction leaves no entry at all): clear
    depth, no triangle, zero attributes."""
    rng = np.random.default_rng(19)
    clip, tris = _random_mesh(rng, t=4200, size=0.05)
    clip[:, 3] = -1.0                      # every vertex behind the camera
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    vis = _both_attrs(clip, tris, attrs, 256, 192, raster.CULL_NONE, 6)
    assert (vis.tri.numpy() == -1).all()
    assert (_both_depth(clip, tris, 256, 192, raster.CULL_NONE, 6).numpy()
            == 1.0).all()


def test_plain_raster_tie_goes_to_larger_triangle_id():
    """Two coplanar triangles over the same pixels: the larger id wins,
    whatever the entry order (the kernel's z-tie rule)."""
    clip = np.array([[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [-1, 1, 0.5, 1]] * 2,
                    np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    vis, _ = tr.rasterize_attrs_tiled(
        torch.as_tensor(clip), torch.as_tensor(tris),
        torch.ones((6, 1)), 128, 32, raster.CULL_NONE, 1)
    covered = vis.tri.numpy() >= 0
    assert covered.mean() > 0.3
    assert (vis.tri.numpy()[covered] == 1).all()
