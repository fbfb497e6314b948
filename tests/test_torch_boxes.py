"""The pixel boxes that let K1, K6, K2, K4 and the crowd forms K5a, K5b of
K2, K4 skip the pixels an entry cannot cover (`tiled_raster._pixel_boxes`),
checked on the CPU, where no kernel runs: the plain rasters masked to the
boxes must give the bits of the unmasked, brute-force ones. Each check runs
at both sample extents the boxes are made for: the MSAA samples' 0.375 (K4,
K5b; the test ids without a prefix) and the pixel centre's 0 (K2, K5a; ids
and names with "centre"; the depth rasters K1 and K6 take the centre's
boxes too: ids with "k1-" and "k6-").

(a) masked == unmasked, bit for bit, on adversarial triangle sets
    (tests/torch_box_meshes.py), single and crowd, entries shuffled; the
    depth rasters over 32-row bins (K1, K6) and 8-row bins (K6);
(b) a search (hypothesis, and a bulk random one) for a trusted triangle
    and a pixel outside its box that the unmasked coverage test admits;
(c) the boxes `_bin` (at tile heights 32 and 8) and `_bin_crowd` return
    line up with their rows;
(d) the entry points that now carry boxes still match the reference
    (`simple_mmd_renderer_tpu`, its Pallas kernels in interpret mode) at
    the tolerances of tests/test_torch_raster.py,
    tests/test_torch_msaa_window.py and tests/test_torch_crowd_raster.py
    (the depth entry points, K1's and K6's, are held there).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import raster

from test_torch_crowd_raster import _both_attrs as _both_crowd
from test_torch_crowd_raster import _both_depth as _both_depth_crowd
from test_torch_msaa_window import _both_msaa
from test_torch_raster import _both_attrs as _both_single
from test_torch_raster import _random_mesh
from torch_box_meshes import (KINDS, boxed_bins, screen_setup,
                              screen_triangles)

import torch_threads  # noqa: F401  (the port's tests' thread cap)

SIZES = [(256, 144), (320, 192)]
SIZE_IDS = ["256x144", "320x192"]
WHOLE = 2 ** 15 - 1     # last column / row of a box that spans the range
MSAA, CENTRE = tr.MSAA4_EXTENT, 0.0


def _at_both_extents(cases, ids, centre=None):
    """pytest params: each case (a tuple) at the MSAA extent under its own
    id, then at the centre's under "centre-" + its id (only the cases whose
    ids are in `centre`, where given)."""
    return ([pytest.param(*c, MSAA, id=i) for c, i in zip(cases, ids)]
            + [pytest.param(*c, CENTRE, id="centre-" + i)
               for c, i in zip(cases, ids) if centre is None or i in centre])


def _plain(extent, crowd=False):
    """The plain raster whose kernel culls with the boxes of `extent`: K4's
    (K5b's) at the MSAA extent, K2's (K5a's) at the centre."""
    if crowd:
        return (tr.raster_tiles_ms_multi_plain if extent
                else tr.raster_tiles_multi_plain)
    return tr.raster_tiles_ms_plain if extent else tr.raster_tiles_plain


def _some_cover(planes, extent):
    """Whether some pixel of one frame's planes is covered: a sample depth
    below 1 at the MSAA extent, a triangle at the centre."""
    return bool((planes[5] < 1.0).any() if extent else (planes[1] >= 0).any())


def _assert_same_bits(got, want):
    for name, g, w in zip(("depth", "tri", "b1", "b2", "attr", "sdepth"),
                          got, want):
        assert torch.equal(g, w), name


def _depth_plain_for(tile_h):
    """The plain depth raster over tile_h-row bins, as the kernel that takes
    them runs it: K1's at 32 rows, K6's over a window of the whole grid at
    8. -> fn(rows, starts, counts, w, h, boxes=None)."""
    if tile_h == tr.TILE_H:
        return tr.depth_tiles_plain

    def k6(rows, starts, counts, w, h, boxes=None):
        tiles_x, tiles_y, _ = tr._grid(w, h, tile_h)
        window = torch.tensor([0, 0, tiles_y, tiles_x], dtype=torch.int32)
        return tr.depth_tiles_win_plain(rows, starts, counts, window, w, h,
                                        tile_h, boxes=boxes)
    return k6


# at the centre every set at one size: the sizes differ only in how the
# tiles cut the frame, which the MSAA cases cover; the depth rasters (tile_h
# given) at the centre's extent over 32-row (K1) and 8-row (K6) bins
@pytest.mark.parametrize("kind,size,tile_h,extent", _at_both_extents(
    [(k, s, None) for k in KINDS for s in SIZES],
    [f"{k}-{i}" for k in KINDS for i in SIZE_IDS],
    centre=[f"{k}-{SIZE_IDS[0]}" for k in KINDS])
    + [pytest.param(k, SIZES[0], th, CENTRE, id=f"{name}-{k}")
       for th, name in ((32, "k1"), (8, "k6-tile8")) for k in KINDS])
def test_masked_plain_equals_unmasked(kind, size, tile_h, extent):
    w, h = size
    t = 1500 if kind == "subpixel" else 500
    rows, starts, counts, boxes = boxed_bins(kind, 11, t, w, h, n_attrs=1,
                                             sample_extent=extent,
                                             tile_h=tile_h or tr.TILE_H)
    assert int(counts.sum()) > 50
    if tile_h is None:
        plain = _plain(extent)
        want = plain(rows, starts, counts, w, h, 1)
        got = plain(rows, starts, counts, w, h, 1, boxes=boxes)
        _assert_same_bits(got, want)
        assert _some_cover(want, extent)
    else:
        plain = _depth_plain_for(tile_h)
        want = plain(rows, starts, counts, w, h)
        assert torch.equal(plain(rows, starts, counts, w, h, boxes=boxes),
                           want)
        assert bool((want < 1.0).any())
    idx, _ = tr._tile_entries(starts, counts)
    whole = int((boxes[idx, 2] == WHOLE).sum())
    if kind == "slivers":
        # both sides of the trust test are exercised
        assert 0 < whole < idx.numel()
    elif kind in ("random", "subpixel", "centres", "ties"):
        assert whole == 0


# the crowd rasters at both extents; the crowd's depth raster K5c (ids
# "k5c-...") at the centre's
@pytest.mark.parametrize("kind,depth,extent", _at_both_extents(
    [(k, False) for k in KINDS], KINDS)
    + [pytest.param(k, True, CENTRE, id=f"k5c-{k}") for k in KINDS])
def test_masked_plain_equals_unmasked_crowd(kind, depth, extent):
    w, h, n_inst = 256, 144, 3
    rows, starts, counts, boxes = boxed_bins(kind, 23, 300, w, h, n_attrs=1,
                                             n_inst=n_inst,
                                             sample_extent=extent)
    assert counts.shape[0] == n_inst * tr._grid(w, h)[2]
    if depth:
        want = tr.depth_tiles_multi_plain(rows, starts, counts, n_inst, w, h)
        assert torch.equal(tr.depth_tiles_multi_plain(
            rows, starts, counts, n_inst, w, h, boxes=boxes), want)
        assert all(bool((want[i] < 1.0).any()) for i in range(n_inst))
        idx, _ = tr._tile_entries(starts, counts)
        whole = int((boxes[idx, 2] == WHOLE).sum())
        if kind == "slivers":
            # both sides of the trust test are exercised
            assert 0 < whole < idx.numel()
        return
    plain = _plain(extent, crowd=True)
    want = plain(rows, starts, counts, n_inst, w, h, 1)
    got = plain(rows, starts, counts, n_inst, w, h, 1, boxes=boxes)
    _assert_same_bits(got, want)
    assert all(_some_cover([p[i] for p in want], extent)
               for i in range(n_inst))


def test_mask_that_is_too_small_changes_the_result():
    """The comparison can fail: boxes shrunk by two pixels lose coverage."""
    rows, starts, counts, boxes = boxed_bins("random", 11, 300, 256, 144)
    shrunk = boxes + torch.tensor([2, 2, -2, -2], dtype=torch.int16)
    want = tr.raster_tiles_ms_plain(rows, starts, counts, 256, 144, 0)
    got = tr.raster_tiles_ms_plain(rows, starts, counts, 256, 144, 0,
                                   boxes=shrunk)
    assert not torch.equal(got[5], want[5])


def _covered_outside_box(xy, z, tiles=2, extent=MSAA):
    """Per triangle, whether the unmasked coverage test (at the MSAA extent
    any sample, as K4's loop tests it; at the centre's, K2's) admits a pixel
    outside the triangle's box, over the first `tiles` tiles of a
    one-tile-high frame; only trusted triangles count. -> (offending [T]
    bool, trusted [T] bool)."""
    s = screen_setup(xy, z, extent)
    t = s["xy"].shape[0]
    rows = tr._setup_rows(s, torch.arange(t))
    boxes = tr._pixel_boxes(s, extent)
    trusted = boxes[:, 2] != WHOLE
    bad = torch.zeros(t, dtype=torch.bool)
    for tile in range(tiles):
        tile_of = torch.full((t,), tile)
        for b in range(0, t, 1024):
            sl = slice(b, b + 1024)
            if extent:
                zb, _, _ = tr._eval_entries_ms(rows[sl], tile_of[sl], tiles)
                covered = zb < 4.0
            else:
                zm, _ = tr._eval_entries(rows[sl], tile_of[sl], tiles,
                                         zmax=False)
                covered = zm < 2.0
            inside = tr._in_boxes(boxes[sl], tile_of[sl], tiles)
            bad[sl] |= (covered & ~inside).flatten(1).any(1)
    return bad & trusted & s["valid"], trusted


coord = st.floats(-40.0, 300.0, allow_nan=False, width=32)
small = st.floats(-1.0, 1.0, allow_nan=False, width=32)
exponent = st.floats(-9.0, 1.7)


def _hunt(extent, examples):
    """A hypothesis hunt at `extent`, `examples` triangles long."""

    @settings(max_examples=examples, deadline=None, derandomize=True)
    @given(ax=coord, ay=st.floats(-20.0, 60.0, width=32),
           ang=st.floats(0, 6.3), e_len=exponent, e_off=exponent,
           along=small, sign=st.booleans())
    def hunt(ax, ay, ang, e_len, e_off, along, sign):
        """Hypothesis hunts a triangle (from well shaped down to slivers: an
        edge of 1e-9 to 50 pixels and a third vertex 1e-9 to 50 pixels off
        it) and a pixel outside its box that the coverage test admits."""
        length, off = 10.0 ** e_len, 10.0 ** e_off * (1 if sign else -1)
        u = np.array([np.cos(ang), np.sin(ang)])
        n = np.array([-u[1], u[0]])
        a = np.array([ax, ay])
        xy = np.stack([a, a + u * length, a + u * (along * length) + n * off])
        bad, _ = _covered_outside_box(xy[None], np.full((1, 3), 0.5),
                                      extent=extent)
        assert not bool(bad.any()), xy

    return hunt


test_no_pixel_outside_a_trusted_box_is_covered = _hunt(MSAA, 400)
test_no_pixel_outside_a_trusted_centre_box_is_covered = _hunt(CENTRE, 200)


def _bulk_hunt(extent, per_set):
    """The same hunt in bulk: 2 x 3 `per_set` slivers and 2 x `per_set`
    sub-pixel and on-sample triangles over two tiles, at constant depth so
    that coverage alone decides."""
    sets = [screen_triangles("slivers", 5, 3 * per_set, 256, 32)[0],
            screen_triangles("slivers", 6, 3 * per_set, 256, 32)[0],
            screen_triangles("subpixel", 7, per_set, 256, 32)[0],
            screen_triangles("samples", 8, per_set, 256, 32)[0]]
    xy = np.concatenate(sets)
    bad, trusted = _covered_outside_box(xy, np.full(xy.shape[:2], 0.5),
                                        extent=extent)
    assert int(bad.sum()) == 0
    # the hunt is not vacuous: the slivers fall on both sides of the trust
    # test, nearly all the small triangles are trusted
    n = 6 * per_set
    assert 0.1 * n < int(trusted[:n].sum()) < 0.9 * n
    assert float(trusted[n:].float().mean()) > 0.9


def test_no_pixel_outside_a_trusted_box_is_covered_bulk():
    _bulk_hunt(MSAA, 4000)


def test_no_pixel_outside_a_trusted_centre_box_is_covered_bulk():
    """Half the MSAA hunt's size: the centre's hypothesis hunt searches the
    same shapes."""
    _bulk_hunt(CENTRE, 2000)


def test_hunt_finds_a_false_cover_without_the_trust_test(monkeypatch):
    """The bulk hunt has teeth: when every triangle is trusted, some sliver
    covers a pixel outside its box by rounding alone."""
    monkeypatch.setattr(tr, "BOX_TRUST", float("inf"))
    xy = screen_triangles("slivers", 5, 12000, 256, 32)[0]
    bad, trusted = _covered_outside_box(xy, np.full(xy.shape[:2], 0.5))
    assert int(bad.sum()) > 0
    assert int(trusted.sum()) > 0.9 * 12000


# 32-row bins at both extents; 8-row ones (K6's) at the centre's
@pytest.mark.parametrize("compact,tile_h,extent", _at_both_extents(
    [(False, 32), (True, 32)], ["all", "compact"])
    + [pytest.param(c, 8, CENTRE, id=f"centre-{i}-tile8")
       for c, i in ((False, "all"), (True, "compact"))])
def test_boxes_line_up_with_sorted_rows(compact, tile_h, extent):
    rng = np.random.default_rng(3)
    clip, tris = _random_mesh(rng, t=300)
    clip, tris = torch.as_tensor(clip), torch.as_tensor(tris)
    s = raster.setup(clip, tris, 320, 192, raster.CULL_BACK,
                     sample_extent=extent)
    rows = tr._setup_rows(s, torch.arange(300))
    boxes = tr._pixel_boxes(s, extent)
    assert boxes.dtype == torch.int16 and boxes.shape == (300, 4)
    plain = tr._bin(s, rows, 320, 192, 9, compact, tile_h)
    sorted_rows, starts, counts, big, sorted_boxes = tr._bin(
        s, rows, 320, 192, 9, compact, tile_h, boxes=boxes)
    for a, b in zip(plain, (sorted_rows, starts, counts, big)):
        assert torch.equal(a, b)
    assert sorted_boxes.shape == (sorted_rows.shape[0], 4)
    idx, _ = tr._tile_entries(starts, counts)
    assert idx.numel() > 100
    tid = sorted_rows[idx, 10].long()
    assert torch.equal(sorted_boxes[idx], boxes[tid])
    # a box is the sample-widened bounding box plus one pixel of margin
    xy = s["xy"][tid]
    lo = torch.ceil(xy.amin(1) - (0.5 + extent)).long() - 1
    hi = torch.floor(xy.amax(1) - (0.5 - extent)).long() + 1
    b = sorted_boxes[idx].long()
    assert torch.equal(b[:, :2], lo.clamp(min=-1))
    assert torch.equal(b[:, 2:], hi.clamp(min=-1))


def _crowd_boxes_line_up(extent):
    rng = np.random.default_rng(4)
    n_inst, t, w, h = 3, 200, 256, 144
    clip = np.stack([_random_mesh(rng, t=t)[0] for _ in range(n_inst)])
    tris = torch.as_tensor(_random_mesh(rng, t=t)[1])
    s, rows = tr._crowd_setup(torch.as_tensor(clip), tris, None, w, h,
                              raster.CULL_NONE, None, None, None, extent)
    boxes = tr._pixel_boxes(s, extent)
    assert boxes.shape == (n_inst, t, 4)
    plain = tr._bin_crowd(s, rows, w, h)
    sorted_rows, starts, counts, big, sorted_boxes = tr._bin_crowd(
        s, rows, w, h, boxes)
    for a, b in zip(plain, (sorted_rows, starts, counts, big)):
        assert torch.equal(a, b)
    idx, tile = tr._tile_entries(starts, counts)
    inst = tile // tr._grid(w, h)[2]
    tid = sorted_rows[idx, 10].long()
    assert torch.equal(sorted_boxes[idx], boxes[inst, tid])
    assert len(set(inst.tolist())) == n_inst


def test_crowd_boxes_line_up_with_sorted_rows():
    _crowd_boxes_line_up(MSAA)


def test_crowd_centre_boxes_line_up_with_sorted_rows():
    _crowd_boxes_line_up(CENTRE)


def test_untrusted_triangles_get_the_whole_range():
    """Non-finite coordinates and extreme slivers are never trusted; a
    well-shaped triangle gets its bounding box with one pixel of margin."""
    xy = np.array([[[10.2, 5.1], [14.7, 5.3], [11.0, 9.9]],
                   [[10.0, 5.0], [50.0, 5.0], [30.0, 5.0 + 1e-9]],
                   [[np.nan, 5.0], [14.0, 5.0], [11.0, 9.0]],
                   [[np.inf, 5.0], [14.0, 5.0], [11.0, 9.0]]], np.float32)
    boxes = tr._pixel_boxes(screen_setup(xy, np.full((4, 3), 0.5)),
                            tr.MSAA4_EXTENT)
    assert boxes[0].tolist() == [9, 4, 15, 10]
    for k in (1, 2, 3):
        assert boxes[k].tolist() == [-1, -1, WHOLE, WHOLE]


def test_msaa_entry_points_still_match_reference():
    """Small triangles (a few pixels) through the entry points that bin the
    boxes, against the reference: single at 256x144, crowd of 2 at
    256x128."""
    rng = np.random.default_rng(50)
    clip, tris = _random_mesh(rng, t=600, size=0.04)
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    vis, _ = _both_msaa(clip, tris, attrs, 256, 144, raster.CULL_NONE, 9)
    assert (vis.tri.numpy() >= 0).mean() > 0.02
    clips = np.stack([_random_mesh(rng, t=300, size=0.04)[0]
                      for _ in range(2)])
    tris = _random_mesh(rng, t=300)[1]
    attrs = rng.normal(size=clips.shape[:2] + (3,)).astype(np.float32)
    got = _both_crowd(clips, tris, attrs, 256, 128, raster.CULL_NONE,
                      msaa=True)
    assert (got[0].tri.numpy() >= 0).mean() > 0.02


def test_centre_entry_points_still_match_reference():
    """The same through the msaa=1 entry points, which now bin centre boxes
    (`rasterize_attrs_tiled` at 128x96, `rasterize_attrs_tiled_crowd` with
    2 instances at 128x64), at the tolerances of tests/test_torch_raster.py
    and tests/test_torch_crowd_raster.py."""
    rng = np.random.default_rng(51)
    clip, tris = _random_mesh(rng, t=300, size=0.06)
    attrs = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    vis = _both_single(clip, tris, attrs, 128, 96, raster.CULL_NONE, 9)
    assert (vis.tri.numpy() >= 0).mean() > 0.02
    clips = np.stack([_random_mesh(rng, t=150, size=0.06)[0]
                      for _ in range(2)])
    tris = _random_mesh(rng, t=150)[1]
    attrs = rng.normal(size=clips.shape[:2] + (3,)).astype(np.float32)
    got = _both_crowd(clips, tris, attrs, 128, 64, raster.CULL_NONE)
    assert (got[0].tri.numpy() >= 0).mean() > 0.02


def test_probe_variants_apply_to_the_kernel_source():
    """scripts/probe_torch_raster_ms.py times variants of the tile bodies
    and of K3 made by substituting lines of csrc/tiled_raster.cu and
    csrc/shadow_pcf.cu: every line it names must still be in its source,
    and each variant must change it (but the one of K5c's cluster sizes
    that is the source's own)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "probe_torch_raster_ms", root / "scripts" / "probe_torch_raster_ms.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert "base" in probe.VARIANTS
    assert set(probe.SOURCES) == {"tiled_raster.cu", "shadow_pcf.cu"}
    same = []
    for file, (variants, *_) in probe.SOURCES.items():
        source = (root / "simple_mmd_renderer_tpu_torch" / "csrc"
                  / file).read_text()
        for name, (edits, _) in variants.items():
            assert probe.source_of(name) == (None if name == "base"
                                             else file)
            for old, _ in edits:
                assert old in source, (name, old[:60])
            if probe.variant_source(source, name) == source:
                same.append(name)
    assert len(same) == 2 and "base" in same, same
    assert [n for n in same if n.startswith("crowd_cluster_")]


def test_crowd_depth_entry_point_bins_centre_boxes(monkeypatch):
    """`rasterize_depth_tiled_crowd` (the crowd's shadow maps, K5c) bins the
    centre boxes and hands them to `depth_tiles_multi` in entry order.
    `_kernel_boxes` gives them only for CUDA tensors, so here it is made to
    give them on the CPU: the dispatcher then receives int16 [E, 4] boxes
    that mask the brute-force plain version to its own bits, and the
    entry point's result is the one it gives without them."""
    rng = np.random.default_rng(52)
    clips = torch.as_tensor(np.stack([_random_mesh(rng, t=150, size=0.06)[0]
                                      for _ in range(2)]))
    tris = torch.as_tensor(_random_mesh(rng, t=150)[1])
    want = tr.rasterize_depth_tiled_crowd(clips, tris, 128, 64,
                                          raster.CULL_NONE)
    extents, seen = [], {}
    real_multi = tr.depth_tiles_multi

    def boxes_here(s, sample_extent):
        extents.append(sample_extent)
        return tr._pixel_boxes(s, sample_extent)

    def spy(*args):
        seen["args"] = args
        return real_multi(*args)

    monkeypatch.setattr(tr, "_kernel_boxes", boxes_here)
    monkeypatch.setattr(tr, "depth_tiles_multi", spy)
    got = tr.rasterize_depth_tiled_crowd(clips, tris, 128, 64,
                                         raster.CULL_NONE)
    assert extents == [0.0]
    rows, starts, counts, n_inst, w, h, boxes = seen["args"]
    assert boxes.dtype == torch.int16 and boxes.shape == (rows.shape[0], 4)
    plain = tr.depth_tiles_multi_plain(rows, starts, counts, n_inst, w, h)
    assert torch.equal(tr.depth_tiles_multi_plain(
        rows, starts, counts, n_inst, w, h, boxes=boxes), plain)
    assert torch.equal(got, want)
    assert bool((want < 1.0).any())


def test_depth_crowd_entry_point_still_matches_reference():
    """Small triangles (a few pixels) through `rasterize_depth_tiled_crowd`,
    which bins centre boxes for K5c, against the reference's tiled crowd
    depth raster: a crowd of 2 at 256x128, at the tolerance of
    tests/test_torch_crowd_raster.py."""
    rng = np.random.default_rng(53)
    clips = np.stack([_random_mesh(rng, t=300, size=0.04)[0]
                      for _ in range(2)])
    tris = _random_mesh(rng, t=300)[1]
    got = _both_depth_crowd(clips, tris, 256, 128, raster.CULL_NONE)
    assert (got.numpy() < 1.0).mean() > 0.02
