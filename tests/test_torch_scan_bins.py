"""The scan raster's tile bins (KSb's plain version, `scan_bins_plain`) and
the binned walk that KS runs over them, on the CPU.

- `scan_bins_plain` against a brute-force overlap of every triangle's
  pixel box with every coarse tile's pixel rectangle (clipped to the
  frame), on the adversarial sets of tests/torch_box_meshes.py and on
  random meshes with triangles whose boxes lie partly or wholly off the
  frame, at negative coordinates or at `_BOX_MAX`, invalid and zero-area
  triangles, a triangle over the whole frame, n not a multiple of 32, two
  instances and tiles that do not divide the frame.
- The binned walk in plain form: per coarse tile, `scan_raster_plain` over
  only the triangles whose bit is set in that tile's words, read inside
  the tile's pixel window, must give `scan_raster_plain`'s bits over the
  whole frame, cleared and from a start buffer. This is the argument KS
  relies on: a triangle left out of a tile cannot reach its pixels.
- `scan_tile`: the default, and the doubling that keeps the bins under
  SCAN_BINS_MAX bytes.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import raster

from torch_box_meshes import KINDS, screen_setup, screen_triangles

W, H = 150, 90          # 16 does not divide 150 or 90, nor do 32 and 64


def _random_setup(seed, t, w=W, h=H, n_inst=None):
    """`raster.setup` of a random mesh of t triangles plus six made to
    test the bins' edges: one over the whole frame, one wholly left of and
    one wholly below the frame, one across the frame's top-left corner
    (negative coordinates), one far beyond the frame (its box clamped at
    `_BOX_MAX`) and one of zero area (invalid) -> [t + 6, ...], or
    [n_inst, t + 6, ...] (instances moved apart; some triangles behind the
    camera, hence invalid, in one instance only)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1.1, 1.1, (t, 2))
    verts = np.stack([v0, v0 + rng.uniform(-0.3, 0.3, (t, 2)),
                      v0 + rng.uniform(-0.3, 0.3, (t, 2))], 1)
    extra = np.array([
        [[-3, -3], [3, -3], [0, 3]],                  # the whole frame
        [[-1.9, 0.1], [-1.5, 0.2], [-1.7, 0.5]],      # left of the frame
        [[0.1, 1.6], [0.3, 1.9], [0.5, 1.7]],         # below the frame
        [[-1.2, -1.2], [-0.8, -1.1], [-1.1, -0.7]],   # the corner
        [[500.0, 500.0], [510.0, 500.0], [500.0, 510.0]],   # beyond
        [[0.1, 0.1], [0.1, 0.1], [0.3, 0.5]],         # zero area
    ])
    verts = np.concatenate([verts, extra]).reshape(-1, 2)
    n = verts.shape[0]
    zs = rng.uniform(0.05, 0.95, n)
    clip = np.concatenate([verts, zs[:, None], np.ones((n, 1))],
                          -1).astype(np.float32)
    if n_inst:
        shift = rng.uniform(-0.2, 0.2, (n_inst, 1, 4)) * [1, 1, 0, 0]
        clip = np.broadcast_to(clip, (n_inst,) + clip.shape) + shift
        behind = rng.uniform(size=n // 3) < 0.1
        clip[0, :n // 3 * 3, 3] = np.where(np.repeat(behind, 3), -1.0, 1.0)
        clip = clip.astype(np.float32)
    tris = torch.arange(n, dtype=torch.int32).reshape(-1, 3)
    return raster.setup(torch.as_tensor(clip), tris, w, h, raster.CULL_NONE)


def _adversarial(kind, t=300, w=W, h=H):
    return screen_setup(*screen_triangles(kind, 5, t, w, h), 0.0)


def _table(s):
    n = s["xy"].shape[-3]
    return tr._scan_table(s).reshape(-1, n, 16).contiguous()


def _unpack(words, n):
    """int32 words [I, tiles, ceil(n / 32)] (the bins without their flag
    column) -> bool [I, tiles, n]."""
    w = words.numpy().view(np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (-1,))[..., :n].astype(bool)


def _brute_bins(table, w, h, tile):
    """bool [I, tiles, n]: triangle valid and its box (inclusive) overlaps
    the tile's pixel rectangle clipped to the frame."""
    tab = table.numpy().astype(np.float64)
    valid = tab[..., 10] > 0
    c0, r0, c1, r1 = (tab[..., 12 + i] for i in range(4))
    out = []
    for y in range(0, h, tile):
        for x in range(0, w, tile):
            x1, y1 = min(x + tile, w) - 1, min(y + tile, h) - 1
            out.append(valid & (c0 <= x1) & (c1 >= x) & (r0 <= y1)
                       & (r1 >= y))
    return np.stack(out, 1)


BIN_CASES = ([f"{k}-t{t}" for k in KINDS for t in (32, 64)]
             + [f"random-t{t}" for t in (16, 32, 48, 64, 128)]
             + ["crowd-t32", "crowd-t64", "ragged-t16", "corner-t16",
                "corner-t32"])


def _bin_setup(case):
    kind, t = case.split("-t")
    if kind == "random":
        return _random_setup(1, 200), int(t)
    if kind == "crowd":
        return _random_setup(2, 150, n_inst=2), int(t)
    if kind == "ragged":        # n = 33: one word and one bit
        return _random_setup(3, 27), int(t)
    if kind == "corner":        # triangles near the top-left only: most
        xy, z = screen_triangles("random", 5, 64, W, H)      # tiles empty
        return screen_setup(xy * np.float32(0.3), z, 0.0), int(t)
    return _adversarial(kind), int(t)


@pytest.mark.parametrize("case", BIN_CASES)
def test_scan_bins_plain_matches_brute_force(case):
    s, tile = _bin_setup(case)
    table = _table(s)
    n_inst, n = table.shape[:2]
    bins = tr.scan_bins_plain(table, W, H, tile)
    tiles = -(-W // tile) * -(-H // tile)
    assert bins.dtype == torch.int32
    assert bins.shape == (n_inst, tiles, -(-n // 32) + 1)
    words, flag = bins[..., :-1], bins[..., -1]
    want = _brute_bins(table, W, H, tile)
    got = _unpack(words, n)
    assert np.array_equal(got, want)
    # the flag: 1 where the tile holds a triangle; the padding bits of the
    # last word stay clear
    assert np.array_equal(flag.numpy(), want.any(-1).astype(np.int32))
    if case.startswith("corner-"):
        assert (flag == 0).any() and (flag == 1).any()
    assert not _unpack(words, 32 * words.shape[-1])[..., n:].any()
    # every case bins something and leaves something out
    assert got.any() and not got.all()
    # the CPU dispatch is the plain version
    assert torch.equal(tr.scan_bins(table, W, H, tile), bins)
    if case.startswith("random-"):
        valid = table[0, :, 10] > 0
        # the whole-frame triangle in every tile; the ones off the frame,
        # far beyond it (at _BOX_MAX) or of zero area in none; the one
        # across the corner (a negative box) in some
        assert valid[-6] and got[0, :, -6].all()
        assert valid[-5:-3].all() and not got[0, :, -5:-3].any()
        assert valid[-2] and table[0, -2, 12] == tr._BOX_MAX
        assert not got[0, :, -2].any()
        assert not valid[-1] and not got[0, :, -1].any()
        assert table[0, -3, 12:14].min() < 0 and got[0, :, -3].any()


def _binned_walk(s, w, h, tile, vis=None):
    """The binned scan in plain form: per coarse tile the plain scan over
    that tile's binned triangles (the others made invalid), its pixels
    read inside the tile's window."""
    table = _table(s)
    lead = tuple(s["xy"].shape[:-3])
    bits = torch.as_tensor(_unpack(
        tr.scan_bins_plain(table, w, h, tile)[..., :-1], table.shape[1]))
    out = raster.empty_vis(w, h, "cpu", lead)
    depth, tri_id, bary = (t.clone() for t in (out.depth, out.tri, out.bary))
    tiles_x = -(-w // tile)
    for i in range(bits.shape[1]):
        ty, tx = divmod(i, tiles_x)
        ys = slice(ty * tile, (ty + 1) * tile)
        xs = slice(tx * tile, (tx + 1) * tile)
        sub = dict(s, valid=s["valid"] & bits[:, i].reshape(
            s["valid"].shape))
        got = tr.scan_raster_plain(w, h, sub, vis)
        depth[..., ys, xs] = got.depth[..., ys, xs]
        tri_id[..., ys, xs] = got.tri[..., ys, xs]
        bary[..., ys, xs, :] = got.bary[..., ys, xs, :]
    return raster.VisBuffer(depth, tri_id, bary)


def _start(lead, w=W, h=H):
    rng = np.random.default_rng(9)
    shape = lead + (h, w)
    held = rng.uniform(size=shape) < 0.4
    return raster.VisBuffer(
        torch.as_tensor(rng.uniform(0.2, 1.0, shape).astype(np.float32)),
        torch.as_tensor(np.where(held, rng.integers(0, 90, shape),
                                 -1).astype(np.int32)),
        torch.as_tensor(np.where(held[..., None],
                                 rng.uniform(size=shape + (2,)),
                                 0.0).astype(np.float32)))


WALK_CASES = ["random-t16", "random-t48", "random-t64-start", "crowd-t32",
              "corner-t16-start",
              "crowd-t64-start", "slivers-t32", "centres-t64-start",
              "edges-t16", "ties-t32", "subpixel-t64"]


@pytest.mark.parametrize("case", WALK_CASES)
def test_binned_walk_equals_the_plain_scan(case):
    s, tile = _bin_setup(case.removesuffix("-start"))
    lead = tuple(s["xy"].shape[:-3])
    vis = _start(lead) if case.endswith("-start") else None
    want = tr.scan_raster_plain(W, H, s, vis)
    got = _binned_walk(s, W, H, tile, vis)
    assert torch.equal(got.depth, want.depth)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.bary, want.bary)
    drawn = want.tri != (-1 if vis is None else vis.tri)
    assert drawn.any()


def test_scan_tile_keeps_the_bins_bounded(monkeypatch):
    """SCAN_TILE where the bins fit in SCAN_BINS_MAX bytes, else its least
    doubling that does or reaches the frame's size."""
    assert tr.scan_tile(1, 25_608, 1920, 1080) == tr.SCAN_TILE
    monkeypatch.setattr(tr, "SCAN_TILE", 64)
    # 1M triangles at 3840 x 2160: 255 MB of bins at 64 pixels a tile,
    # 67 MB at 128
    tile = tr.scan_tile(1, 1 << 20, 3840, 2160)
    words = -(-(1 << 20) // 32) + 1
    assert tile == 128
    assert 4 * words * -(-3840 // tile) * -(-2160 // tile) <= tr.SCAN_BINS_MAX
    # a tile as large as the frame is where doubling stops
    assert tr.scan_tile(65_535, 1 << 20, 64, 64) == 64
    monkeypatch.setattr(tr, "SCAN_TILE", 16)
    assert tr.scan_tile(1, 100, 64, 48) == 16
