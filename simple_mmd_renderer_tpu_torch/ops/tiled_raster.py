"""Binned tile rasterizer: the shadow-depth and character rasters of one
character and of a crowd.

Port of `simple_mmd_renderer_tpu/ops/tiled_raster.py`, with the same
visibility semantics (pixel centres at
+0.5, covered = barycentrics >= 0 and w1 + w2 <= 1, z-less wins, a z-tie
goes to the larger triangle id):

1. Binning (torch ops): each valid triangle's screen bbox expands into
   (tile, triangle) entries, at most `e_max` tiles per triangle. With
   `compact`, the valid triangle ids are first compacted with a boolean
   mask (exact: every triangle with an entry is kept, in id order). One
   int64 key `tile << tri_bits | tri` is sorted; `searchsorted` gives every
   tile's first entry, so tile t owns sorted entries
   [starts[t], starts[t] + counts[t]). The per-triangle setup rows (plane
   coefficients anchored at vertex 0, `_setup_rows`) are gathered into that
   order.
2. Per-tile loop: K1 (`depth_tiles`, depth only, for the shadow map), K6
   (`depth_tiles_win`, K1 over the casters' tile window), K2
   (`raster_tiles`: depth, triangle id, barycentrics and perspective-correct
   attributes) and K4 (`raster_tiles_ms`: K2 with any-sample coverage and
   per-sample depth, for 4x MSAA) — hand-written CUDA kernels in
   `csrc/tiled_raster.cu` for CUDA tensors, the plain PyTorch versions
   (`*_plain`) for CPU tensors. Both give the same bits. K1, K6, K2 and K4
   (and the crowd forms K5a, K5b, K5c of K2, K4 and K1) evaluate an entry
   only inside the box of pixels its triangle can reach (`_pixel_boxes`: at
   the pixel centre for K1, K6, K2 and K5c, over the MSAA samples for K4;
   carried into entry order by the binning); the plain versions stay brute
   force over the whole tile, so the comparison also checks the boxes.
3. Triangles covering more than `e_max` tiles (at most BIG_TRI_CAP of them)
   are rasterized exactly by the scan raster (`scan_raster`: KSb's tile
   bins and KS's walk on the card) and merged by depth, a big triangle
   winning a tie. When `e_max` covers the whole tile grid the merge cannot
   trigger and is skipped.

Kept from the reference because they change output: BIG_TRI_CAP, the merge's
`<=` tie rule, the kernel's id tie rule, `_covers_all`, zeroed attributes
where tri < 0. TILE_H x TILE_W stays 32 x 128 (the windowed shadow raster
also takes 8-row tiles) so that starts/counts can be compared with the
reference.

The crowd (`rasterize_*_crowd`, at the end of the module) rasterizes I
instances of one topology at once: one binning over the valid triangles of
all instances, keyed by the global tile inst * n_tiles + tile, and one
launch of K5a (`raster_tiles_multi`), K5b (`raster_tiles_ms_multi`) or K5c
(`depth_tiles_multi`) over the instance x tile grid, each running K2's,
K4's or K1's tile body on the crowd's boxed bins. Oversized triangles merge
per instance through the same capped scan. The reference bins a crowd in
up to four validity-compacted passes of static size and merges them in
draw order; the port compacts to the exact count, so one pass does, with
the same result.

Host synchronisations (for a later CUDA-graph change): the compacted
triangle count (`nonzero`) and the big-triangle count, once per raster
whatever the number of instances; each is a recorded span
(`profiling.host_read`, sites `bin` and `big`).
"""

from __future__ import annotations

import math

import torch

from ..render import raster
from ..utils.profiling import host_read
from . import _build

TILE_H = 32
TILE_W = 128
BASE_WIDTH = 16
BIG_TRI_CAP = 64
COMPACT_MIN_T = 4096
MAX_ATTRS = 36   # attribute planes a setup row may carry (as the reference)

WIN_TILE_H = (8, 32)   # tile heights K6 is built for

# the reference's `chunk` (the entries of a tile it streams at once) must
# be a multiple of its GROUP; no kernel here streams in chunks
CHUNK_GROUP = 8

# launches of the CUDA kernels since the last reset (plain counters: a run
# shows the main path went through the kernels)
depth_launches = 0         # K1
raster_launches = 0        # K2
raster_ms_launches = 0     # K4
depth_win_launches = 0     # K6


def _setup_rows(s, tri_ids, attrs=None):
    """Pack per-triangle setup ([T, ...], or [I, T, ...] for a crowd) into
    [..., T, W] f32 rows of screen-space plane
    coefficients anchored at vertex 0: ax, ay, w1x, w1y, w2x, w2y, z0, zx,
    zy, valid, tri_id, ymin, ymax, pad (3); with attrs [V,A] the 1/w
    denominator plane (3) and per-attribute numerator planes (3A) follow,
    padded to a multiple of 8 lanes."""
    xy = s["xy"]
    z = s["z"]
    area2 = s["area2"]
    inv_area = torch.where(torch.abs(area2) > 1e-12, 1.0 / area2,
                           torch.zeros_like(area2))
    ax, ay = xy[..., 0, 0], xy[..., 0, 1]
    bx, by = xy[..., 1, 0], xy[..., 1, 1]
    cx, cy = xy[..., 2, 0], xy[..., 2, 1]
    ymin_r = torch.clamp(torch.minimum(torch.minimum(ay, by), cy),
                         0.0, 65535.0)
    ymax_r = torch.clamp(torch.maximum(torch.maximum(ay, by), cy),
                         0.0, 65535.0)
    w1x = (cy - ay) * inv_area
    w1y = (ax - cx) * inv_area
    w2x = (ay - by) * inv_area
    w2y = (bx - ax) * inv_area

    def combo(v0, v1, v2):
        d1 = v1 - v0
        d2 = v2 - v0
        return (v0, d1 * w1x + d2 * w2x, d1 * w1y + d2 * w2y)

    z0, zx, zy = combo(z[..., 0], z[..., 1], z[..., 2])
    zero = torch.zeros_like(z0)
    cols = [ax, ay, w1x, w1y, w2x, w2y, z0, zx, zy,
            s["valid"].to(torch.float32),
            tri_ids.to(torch.float32).expand_as(z0),
            ymin_r, ymax_r, zero, zero, zero]
    if attrs is not None:
        if attrs.shape[-1] > MAX_ATTRS:
            raise ValueError("attr payload exceeds the row's plane budget")
        va = s.get("va")
        if va is None:
            va = attrs[s["tris_v"].long()]           # [T,3,A]
        iw = s["inv_w"]
        cols.extend(combo(iw[..., 0], iw[..., 1], iw[..., 2]))
        for a in range(attrs.shape[-1]):
            cols.extend(combo(va[..., 0, a] * iw[..., 0],
                              va[..., 1, a] * iw[..., 1],
                              va[..., 2, a] * iw[..., 2]))
    cols.extend([zero] * ((-len(cols)) % 8))
    return torch.stack(cols, dim=-1)


# Pixel boxes (K1, K6, K2, K4 and the crowd forms of K2, K4, K1): the margin in
# pixels around a triangle's exact box, and the largest conditioning
# G * max(1, extent) a box is trusted for
BOX_MARGIN = 1
BOX_TRUST = 2.0 ** 17
_BOX_MIN, _BOX_MAX = -BOX_MARGIN, 2 ** 15 - 1
# the most pixels of a box (clamped to its tile) that one thread of K1, K6,
# K2, K4, K5a, K5b or K5c walks alone; a wider box is shared by the lanes of a
# warp or, from 1,024 pixels on, by the whole block
# (scripts/tune_torch_raster_ms.py: K4's and K5b's times are flat from 128
# to 1,024 and worse on either side; K1's and K6's from 64 to 256)
WIDE_BOX = 128


def _pixel_boxes(s, sample_extent=0.0):
    """Per triangle, the box of pixels it can cover -> int16 [..., T, 4]
    (first column, first row, last column, last row; inclusive, in pixel
    indices of the frame).

    The exact box holds every pixel with a sample point inside the
    triangle's bounding box: columns ceil(xmin - 0.5 - e) ..
    floor(xmax - 0.5 + e) for samples up to e = `sample_extent` pixels from
    the centre (0.375 for the 4x MSAA pattern), rows likewise. It is widened
    by BOX_MARGIN pixels and clamped only to the int16 range
    [-BOX_MARGIN, 32767]: the kernels clamp it to their own tile, padding
    included (the plain versions evaluate a tile's padding pixels too), and
    the exact box is still the stored one less the margin.

    Why one pixel of margin is enough, and for which triangles. The tile
    loops test coverage on planes evaluated in rounded float32, so a pixel
    outside the exact box passes the test only if rounding moves a
    barycentric across zero. Let X, Y be the extents of the triangle's
    bounding box, A its doubled area and u = 2^-24. For a sample point whose
    x lies r * X beyond the box (or whose y lies r * Y beyond it), x being
    the barycentric mean of the vertices' x gives some exact barycentric
    <= -r / 2. Against that stand (a) the relative error of the computed
    area, at most 8 u X Y / |A|, which scales w1 and w2 alike (their signs
    keep) and shifts the w1 + w2 <= 1 edge by that share; and (b) the
    rounding of the plane evaluation (vertex-0 anchor, dx, two products, a
    sum, the per-sample offset and its sum): at most 8 u (|w1x| (|dx| +
    0.375) + |w1y| (|dy| + 0.375)) with |w1x| <= Y / |A|, |w1y| <= X / |A|,
    |dx| <= X + r X + 0.375, |dy| <= Y + r Y + 0.375, so at most
    8 u G (1 + r) with G = (2 X Y + X + Y) / |A|. A false cover needs
    r / 2 <= 2 (b) + u + (a) <= u G (16 (1 + r) + 4.5) up to second order.
    With u G <= min(1, M / max(X, Y)) / 128 and r >= M / max(X, Y) (a pixel
    M columns or rows outside the exact box) the right side stays below
    0.33 r: no false cover. So a triangle is trusted when
    G * max(1, max(X, Y) / M) <= 2^24 / 128 = BOX_TRUST (M = BOX_MARGIN).
    Every other triangle (slivers with |A| down to the 1e-12 cut, whose
    barycentric slopes reach 1e5 and more; non-finite coordinates) gets the
    whole int16 range as its box: every tile it is binned into then
    evaluates it over all of its pixels, as a loop without boxes does.
    At extent 0 (K2, K5a: pixel centres only) the offset and its 0.375
    terms drop out, which only tightens the bound."""
    xy = s["xy"]
    x_lo, x_hi = torch.amin(xy[..., 0], -1), torch.amax(xy[..., 0], -1)
    y_lo, y_hi = torch.amin(xy[..., 1], -1), torch.amax(xy[..., 1], -1)
    ext_x, ext_y = x_hi - x_lo, y_hi - y_lo
    g = (2.0 * ext_x * ext_y + ext_x + ext_y) / torch.abs(s["area2"])
    reach = torch.clamp(torch.maximum(ext_x, ext_y) / BOX_MARGIN, min=1.0)
    trusted = g * reach <= BOX_TRUST          # false for NaN and inf
    e = float(sample_extent)
    lo = torch.stack([torch.ceil(x_lo - 0.5 - e), torch.ceil(y_lo - 0.5 - e)],
                     -1) - BOX_MARGIN
    hi = torch.stack([torch.floor(x_hi - 0.5 + e),
                      torch.floor(y_hi - 0.5 + e)], -1) + BOX_MARGIN
    box = torch.cat([lo, hi], -1)
    # the whole range, made on the device (no host copy: capturable)
    whole = torch.where(torch.arange(4, device=xy.device) < 2,
                        float(_BOX_MIN), float(_BOX_MAX))
    box = torch.where(trusted[..., None], box, whole)
    return torch.clamp(box, _BOX_MIN, _BOX_MAX).to(torch.int16)


def _kernel_boxes(s, sample_extent):
    """`_pixel_boxes` where a kernel will cull with them (CUDA tensors);
    None on the CPU, whose plain versions evaluate every entry over its
    whole tile: the binning then gathers no boxes."""
    if s["xy"].device.type == "cpu":
        return None
    return _pixel_boxes(s, sample_extent)


def _grid(width, height, tile_h=TILE_H):
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // tile_h)
    return tiles_x, tiles_y, tiles_x * tiles_y


def _expand_tiles(s, width, height, e_max, tile_h=TILE_H):
    """Per-triangle covered-tile enumeration over tile_h x TILE_W tiles ->
    (tile [T, E] int64 with n_tiles in unused slots, big [T]
    oversized-triangle mask); a crowd's setup gives [I, T, E] and [I, T]."""
    tiles_x, _, n_tiles = _grid(width, height, tile_h)
    xy = s["xy"]
    x_lo, x_hi = torch.amin(xy[..., 0], -1), torch.amax(xy[..., 0], -1)
    y_lo, y_hi = torch.amin(xy[..., 1], -1), torch.amax(xy[..., 1], -1)
    xmin = torch.clamp(x_lo, 0.0, width - 1.0)
    xmax = torch.clamp(x_hi, 0.0, width - 1.0)
    ymin = torch.clamp(y_lo, 0.0, height - 1.0)
    ymax = torch.clamp(y_hi, 0.0, height - 1.0)
    on = (x_hi >= 0) & (x_lo < width) & (y_hi >= 0) & (y_lo < height)
    valid = s["valid"] & on

    tx0 = torch.floor_divide(xmin, TILE_W).to(torch.int64)
    tx1 = torch.floor_divide(xmax, TILE_W).to(torch.int64)
    ty0 = torch.floor_divide(ymin, tile_h).to(torch.int64)
    ty1 = torch.floor_divide(ymax, tile_h).to(torch.int64)
    bw = tx1 - tx0 + 1
    n_cover = bw * (ty1 - ty0 + 1)
    big = valid & (n_cover > e_max)
    small = valid & ~big

    e = torch.arange(e_max, device=xy.device)                     # [E]
    bwc = torch.clamp(bw, 1, e_max)[..., None]
    tile = ((ty0[..., None] + e // bwc) * tiles_x
            + (tx0[..., None] + e % bwc))
    mask = small[..., None] & (e < n_cover[..., None])
    tile = torch.where(mask, tile, torch.full_like(tile, n_tiles))
    return tile, big


def _bin(s, rows, width, height, e_max, compact, tile_h=TILE_H, boxes=None):
    """-> (sorted_rows [N, W], starts i32 [n_tiles + 1], counts i32
    [n_tiles], big [T]) over tile_h x TILE_W tiles. Entries past
    starts[n_tiles] are unused slots. With per-triangle `boxes` [T, 4]
    (`_pixel_boxes`) a fifth result holds them in entry order [N, 4]."""
    _, _, n_tiles = _grid(width, height, tile_h)
    tile, big = _expand_tiles(s, width, height, e_max, tile_h)
    t = tile.shape[0]
    dev = tile.device
    if compact:
        # slot 0 is real iff the triangle produced any entry at all
        with host_read("bin"):
            ids = torch.nonzero(tile[:, 0] < n_tiles).squeeze(1)
        tile = tile[ids]
    else:
        ids = torch.arange(t, device=dev)
    tri_bits = max(int(t - 1).bit_length(), 1)
    key = (tile << tri_bits) | ids[:, None]
    packed = torch.sort(key.reshape(-1)).values
    sorted_tri = packed & ((1 << tri_bits) - 1)
    bound = torch.arange(n_tiles + 1, device=dev) << tri_bits
    starts = torch.searchsorted(packed, bound).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    if boxes is None:
        return rows[sorted_tri], starts, counts, big
    return rows[sorted_tri], starts, counts, big, boxes[sorted_tri]


def _covers_all(e_max, width, height, tile_h=TILE_H) -> bool:
    """True when e_max >= the whole tile grid: no triangle can overflow into
    the big-triangle fallback, so the merge is skipped."""
    return e_max >= _grid(width, height, tile_h)[2]


# ---------------------------------------------------------------------------
# Per-tile loops: plain versions (CPU) and kernel dispatch (CUDA)
# ---------------------------------------------------------------------------

_BLOCK_ENTRIES = 1024   # entries evaluated per vectorised step


def _tile_entries(starts, counts):
    """(entry index, tile id) of every real entry, tile-major."""
    n_tiles = counts.shape[0]
    dev = counts.device
    cnt = counts.long()
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(tile_of.shape[0], device=dev) - first[tile_of]
    return starts.long()[tile_of] + k, tile_of


def _planes(rows, tile_of, tiles_x, tile_h=TILE_H):
    """Centre planes of entries over their tiles (`tile_of`: each entry's
    tile within its own frame) -> (w1, w2, zp [B,TH,TW]), in the kernels'
    arithmetic order."""
    dev = rows.device
    ty = tile_of // tiles_x
    tx = tile_of - ty * tiles_x
    col = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    row = torch.arange(tile_h, dtype=torch.float32, device=dev)
    xs = col[None, None, :] + ((tx * TILE_W).to(torch.float32) + 0.5)[
        :, None, None]
    ys = row[None, :, None] + ((ty * tile_h).to(torch.float32) + 0.5)[
        :, None, None]

    def c(i):
        return rows[:, i][:, None, None]

    dx = xs - c(0)
    dy = ys - c(1)
    w1 = c(2) * dx + c(3) * dy
    w2 = c(4) * dx + c(5) * dy
    zp = c(6) + c(7) * dx + c(8) * dy
    return w1, w2, zp


def _eval_entries(rows, tile_of, tiles_x, zmax, tile_h=TILE_H, boxes=None):
    """Plane evaluation of entries over their tiles -> (zm [B,TH,TW] with 2
    where not covered, tid [B]). Same arithmetic order as the kernels. With
    `boxes` [B, 4] an entry covers nothing outside its box."""
    w1, w2, zp = _planes(rows, tile_of, tiles_x, tile_h)
    ok = ((w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1.0)
          & (rows[:, 9] > 0.0)[:, None, None] & (zp >= 0.0))
    if zmax:
        ok = ok & (zp <= 1.0)
    if boxes is not None:
        ok = ok & _in_boxes(boxes, tile_of, tiles_x, tile_h)
    zm = torch.where(ok, zp, torch.full_like(zp, 2.0))
    return zm, rows[:, 10].to(torch.int64)


def _reduce_into(out, tile_of, vals, how):
    """out[tile_of[k]] = how(out[tile_of[k]], vals[k]) over all k."""
    idx = tile_of.view(-1, 1, 1).expand_as(vals)
    out.scatter_reduce_(0, idx, vals, how, include_self=True)


def _untile(t, tiles_x, tiles_y, n_inst=None):
    """[n_tiles, TH, TW, ...] -> [tiles_y*TH, tiles_x*TW, ...]; with n_inst
    the tiles are instance-major and a leading [n_inst] axis is kept."""
    tile_h = t.shape[1]
    rest = t.shape[3:]
    t = t.reshape((-1, tiles_y, tiles_x, tile_h, TILE_W) + rest)
    t = t.transpose(2, 3)
    t = t.reshape((t.shape[0], tiles_y * tile_h, tiles_x * TILE_W) + rest)
    return t[0] if n_inst is None else t


def _depth_plain(sorted_rows, starts, counts, width, height, tile_h,
                 n_inst=None, boxes=None):
    """Per-tile min of zp over covering entries (zp >= 0) on the tile_h x
    TILE_W grid, cleared to 1. Returns depth [pad_h, pad_w]; with n_inst,
    starts/counts run over the global tile inst * n_tiles + tile and the
    result is [n_inst, pad_h, pad_w]. Brute force over every pixel of an
    entry's tile: `boxes` [E, 4] (in entry order, `_pixel_boxes`) masks
    each entry to its box, as the kernels cull; it is for checks of the
    boxes only, the dispatchers never pass it."""
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile_h)
    depth = torch.ones((counts.shape[0], tile_h, TILE_W),
                       dtype=torch.float32, device=sorted_rows.device)
    eidx, tile_of = _tile_entries(starts, counts)
    for b in range(0, eidx.shape[0], _BLOCK_ENTRIES):
        sl = slice(b, b + _BLOCK_ENTRIES)
        zm, _ = _eval_entries(sorted_rows[eidx[sl]], tile_of[sl] % n_tiles,
                              tiles_x, zmax=False, tile_h=tile_h,
                              boxes=None if boxes is None else boxes[eidx[sl]])
        _reduce_into(depth, tile_of[sl], zm, "amin")
    return _untile(depth, tiles_x, tiles_y, n_inst)


def depth_tiles_plain(sorted_rows, starts, counts, width, height,
                      boxes=None):
    """Plain K1: per-tile min of zp over covering entries (zp >= 0),
    cleared to 1. Returns depth [pad_h, pad_w]. `boxes` as in
    _depth_plain."""
    return _depth_plain(sorted_rows, starts, counts, width, height, TILE_H,
                        boxes=boxes)


def depth_tiles_win_plain(sorted_rows, starts, counts, window, width,
                          height, tile_h, boxes=None):
    """Plain K6: K1 over the tiles of `window` (int32 [4]: first tile row,
    first tile column, tile rows, tile columns of the full tile_h x TILE_W
    grid), pasted into a map of 1.0. starts/counts are the full grid's, so
    a window tile gets K1's bits there. Returns depth [pad_h, pad_w].
    `boxes` as in _depth_plain."""
    tiles_x, _, n_tiles = _grid(width, height, tile_h)
    oy, ox, th, tw = (int(v) for v in window.tolist())
    gid = torch.arange(n_tiles, device=counts.device)
    ty, tx = gid // tiles_x, gid % tiles_x
    inside = (ty >= oy) & (ty < oy + th) & (tx >= ox) & (tx < ox + tw)
    return _depth_plain(sorted_rows, starts, torch.where(inside, counts, 0),
                        width, height, tile_h, boxes=boxes)


def raster_tiles_plain(sorted_rows, starts, counts, width, height, n_attrs,
                       n_inst=None, boxes=None):
    """Plain K2: per pixel the covering entry with the smallest zp in
    [0, 1] wins, a tie going to the larger triangle id (a vectorised min,
    then a max of the id among the entries at that min — order-free like
    the kernel's fold); the clear (depth 1, no triangle) takes part, so an
    entry at exactly zp = 1 wins. b1, b2 and the attribute planes are
    evaluated from the winner's row with the kernel's arithmetic. Brute
    force over every pixel of an entry's tile: `boxes` [E, 4] (in entry
    order, `_pixel_boxes`) masks each entry to its box, as the kernel
    culls; it is for checks of the boxes only, the dispatchers never pass
    it.

    Returns (depth, tri, b1, b2, attr [max(A,1), pad_h, pad_w]); with
    n_inst (global tiles, see _depth_plain) each gains a leading [n_inst]."""
    tiles_x, tiles_y, n_tiles = _grid(width, height)
    dev = sorted_rows.device
    eidx, tile_of = _tile_entries(starts, counts)
    local = tile_of % n_tiles
    n = eidx.shape[0]
    blocks = [slice(b, b + _BLOCK_ENTRIES) for b in range(0, n, _BLOCK_ENTRIES)]

    def entry_boxes(sl):
        return None if boxes is None else boxes[eidx[sl]]

    depth = torch.ones((counts.shape[0], TILE_H, TILE_W),
                       dtype=torch.float32, device=dev)
    for sl in blocks:
        zm, _ = _eval_entries(sorted_rows[eidx[sl]], local[sl], tiles_x,
                              zmax=True, boxes=entry_boxes(sl))
        _reduce_into(depth, tile_of[sl], zm, "amin")
    # winner: max triangle id among the entries at the min depth; the key
    # carries the entry index too (ids are unique within a tile)
    span = max(int(sorted_rows.shape[0]), 1)
    key = torch.full((counts.shape[0], TILE_H, TILE_W), -1,
                     dtype=torch.int64, device=dev)
    for sl in blocks:
        zm, tid = _eval_entries(sorted_rows[eidx[sl]], local[sl], tiles_x,
                                zmax=True, boxes=entry_boxes(sl))
        hit = zm == depth[tile_of[sl]]
        k = (tid * span + eidx[sl])[:, None, None]
        _reduce_into(key, tile_of[sl], torch.where(hit, k, -1), "amax")
    depth = _untile(depth, tiles_x, tiles_y, n_inst)
    key = _untile(key, tiles_x, tiles_y, n_inst)
    won = key >= 0
    tri = torch.where(won, key // span, -1).to(torch.int32)
    b1, b2, attr = _winner_planes(sorted_rows, won,
                                  torch.where(won, key % span, 0), n_attrs)
    return depth, tri, b1, b2, attr


# D3D11/OpenGL standard 4x MSAA sample pattern (pixel units from centre)
MSAA4_OFFSETS = ((-0.125, -0.375), (0.375, -0.125),
                 (-0.375, 0.125), (0.125, 0.375))
MSAA4_EXTENT = 0.375    # the samples' farthest reach from the centre


def _in_boxes(boxes, tile_of, tiles_x, tile_h=TILE_H):
    """[B, TH, TW] mask of the pixels of each entry's tile (`tile_of`: the
    tile within its own frame of tile_h x TILE_W tiles) that lie inside the
    entry's box."""
    dev = boxes.device
    ty = tile_of // tiles_x
    tx = tile_of - ty * tiles_x
    xs = (torch.arange(TILE_W, device=dev)[None, None, :]
          + (tx * TILE_W)[:, None, None])
    ys = (torch.arange(tile_h, device=dev)[None, :, None]
          + (ty * tile_h)[:, None, None])
    b = boxes.long()[:, :, None, None]
    return ((xs >= b[:, 0]) & (xs <= b[:, 2])
            & (ys >= b[:, 1]) & (ys <= b[:, 3]))


def _eval_entries_ms(rows, tile_of, tiles_x, boxes=None):
    """K4's per-entry candidates over their tiles -> (zb [B,TH,TW], szm
    [4,B,TH,TW], tid [B]). zb is zp for an entry that covers the pixel
    centre, zp + 2 for one that covers only some sample (the biased
    depth), 4 for one that covers no sample or whose zp is outside [0, 1];
    szm is a sample's zs where the entry covers it and zs >= 0, else 2.
    Per-sample planes are the centre's plus a per-entry offset,
    w1s = w1 + (w1x*ox + w1y*oy), in the kernel's order. With `boxes`
    [B, 4] an entry covers nothing outside its box."""
    w1, w2, zp = _planes(rows, tile_of, tiles_x)

    def c(i):
        return rows[:, i][:, None, None]

    valid = c(9) > 0.0
    if boxes is not None:
        valid = valid & _in_boxes(boxes, tile_of, tiles_x)
    cover_any = torch.zeros_like(valid)
    szm = []
    for ox, oy in MSAA4_OFFSETS:
        w1s = w1 + (c(2) * ox + c(3) * oy)
        w2s = w2 + (c(4) * ox + c(5) * oy)
        zs = zp + (c(7) * ox + c(8) * oy)
        cover_s = (w1s >= 0) & (w2s >= 0) & (w1s + w2s <= 1.0) & valid
        cover_any = cover_any | cover_s
        szm.append(torch.where(cover_s & (zs >= 0.0), zs, 2.0))
    cover_c = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1.0)
    zb = torch.where(cover_any & (zp >= 0.0) & (zp <= 1.0),
                     zp + torch.where(cover_c, 0.0, 2.0), 4.0)
    return zb, torch.stack(szm), rows[:, 10].to(torch.int64)


def raster_tiles_ms_plain(sorted_rows, starts, counts, width, height,
                          n_attrs, n_inst=None, boxes=None):
    """Plain K4: K2 with any-sample coverage and per-sample depth, brute
    force over every pixel of an entry's tile. `boxes` [E, 4] (in entry
    order, `_pixel_boxes`) masks each entry to its box, as the kernel
    culls; it is for checks of the boxes only: the dispatchers never pass
    it, so the kernel is held against the unmasked loop.

    Depth starts at the biased clear 3.0 with triangle -1, which takes part
    in the tie rule like any entry: the smallest zb wins, a tie going to
    the larger id, so an edge entry at exactly 3.0 beats the clear. The
    winner's depth is un-biased as the reference does (`d - 2` where
    d > 1.5, 1.0 where nothing won). sdepth[s] is the min of zs over the
    entries covering sample s with zs >= 0, cleared to 1.0 (no zs <= 1
    test). b1, b2 and attributes come from the winner's row at the pixel
    centre, as in K2.

    Returns (depth, tri, b1, b2, attr [max(A,1)], sdepth [4]), each over
    [pad_h, pad_w]; with n_inst (global tiles, see _depth_plain) each gains
    a leading [n_inst]."""
    tiles_x, tiles_y, n_tiles = _grid(width, height)
    dev = sorted_rows.device
    eidx, tile_of = _tile_entries(starts, counts)
    local = tile_of % n_tiles
    all_tiles = counts.shape[0]
    n = eidx.shape[0]
    blocks = [slice(b, b + _BLOCK_ENTRIES) for b in range(0, n, _BLOCK_ENTRIES)]

    f32 = dict(dtype=torch.float32, device=dev)
    depth = torch.full((all_tiles, TILE_H, TILE_W), 3.0, **f32)
    sdepth = torch.ones((4, all_tiles, TILE_H, TILE_W), **f32)

    def entry_boxes(sl):
        return None if boxes is None else boxes[eidx[sl]]

    for sl in blocks:
        zb, szm, _ = _eval_entries_ms(sorted_rows[eidx[sl]], local[sl],
                                      tiles_x, entry_boxes(sl))
        _reduce_into(depth, tile_of[sl], zb, "amin")
        for k in range(4):
            _reduce_into(sdepth[k], tile_of[sl], szm[k], "amin")
    span = max(int(sorted_rows.shape[0]), 1)
    key = torch.full((all_tiles, TILE_H, TILE_W), -1, dtype=torch.int64,
                     device=dev)
    for sl in blocks:
        zb, _, tid = _eval_entries_ms(sorted_rows[eidx[sl]], local[sl],
                                      tiles_x, entry_boxes(sl))
        hit = zb == depth[tile_of[sl]]
        k = (tid * span + eidx[sl])[:, None, None]
        _reduce_into(key, tile_of[sl], torch.where(hit, k, -1), "amax")
    depth = _untile(depth, tiles_x, tiles_y, n_inst)
    key = _untile(key, tiles_x, tiles_y, n_inst)
    won = key >= 0
    tri = torch.where(won, key // span, -1).to(torch.int32)
    depth = torch.where(won, torch.where(depth > 1.5, depth - 2.0, depth),
                        1.0)
    b1, b2, attr = _winner_planes(sorted_rows, won,
                                  torch.where(won, key % span, 0), n_attrs)
    sdepth = torch.stack([_untile(sdepth[k], tiles_x, tiles_y, n_inst)
                          for k in range(4)], dim=-3)
    return depth, tri, b1, b2, attr, sdepth


def _winner_planes(sorted_rows, won, win, n_attrs):
    """b1, b2 and attr [max(A,1), H, W] at the pixel centres of a padded
    [H, W] target (or [I, H, W]: attr [I, max(A,1), H, W]) from each
    pixel's winning entry `win` (where `won`), as the kernels evaluate them
    after their loop; 0 where nothing won."""
    dev = sorted_rows.device
    pad_h, pad_w = won.shape[-2:]
    lanes = BASE_WIDTH + 3 + 3 * n_attrs if n_attrs else 6
    rows = sorted_rows[:, :lanes]
    if rows.shape[0] == 0:      # no entries at all: nothing wins anywhere
        rows = torch.zeros((1, lanes), dtype=torch.float32, device=dev)
    r = rows[win]                                           # [pad_h,pad_w,L]
    xs = torch.arange(pad_w, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(pad_h, dtype=torch.float32, device=dev)[:, None] + 0.5
    dx = xs - r[..., 0]
    dy = ys - r[..., 1]
    zero = torch.zeros_like(dx)
    b1 = torch.where(won, r[..., 2] * dx + r[..., 3] * dy, zero)
    b2 = torch.where(won, r[..., 4] * dx + r[..., 5] * dy, zero)
    if n_attrs:
        def plane(i):
            return r[..., i] + r[..., i + 1] * dx + r[..., i + 2] * dy
        den = plane(BASE_WIDTH)
        den = torch.where(torch.abs(den) > 1e-9, den, torch.ones_like(den))
        attr = torch.stack([
            torch.where(won, plane(BASE_WIDTH + 3 + 3 * a) / den, zero)
            for a in range(n_attrs)], dim=-3)
    else:
        attr = torch.zeros(won.shape[:-2] + (1, pad_h, pad_w),
                           dtype=torch.float32, device=dev)
    return b1, b2, attr


def _check_bins(sorted_rows, starts, counts, width, height, min_lanes, name,
                tile_h=TILE_H, n_inst=1):
    n_tiles = n_inst * _grid(width, height, tile_h)[2]
    dev = sorted_rows.device
    if sorted_rows.dtype != torch.float32 or sorted_rows.dim() != 2:
        raise TypeError(f"{name}: rows must be float32 [E, W]")
    if sorted_rows.shape[1] < min_lanes:
        raise ValueError(f"{name}: rows need >= {min_lanes} lanes, got "
                         f"{sorted_rows.shape[1]}")
    if starts.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError(f"{name}: starts/counts must be int32")
    if starts.shape != (n_tiles + 1,) or counts.shape != (n_tiles,):
        raise ValueError(f"{name}: starts/counts shapes {tuple(starts.shape)}"
                         f"/{tuple(counts.shape)} do not match {n_tiles} "
                         "tiles")
    if starts.device != dev or counts.device != dev:
        raise ValueError(f"{name}: tensors on different devices")
    if sorted_rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: too many entries for int32 indices")
    return (sorted_rows.contiguous(), starts.contiguous(),
            counts.contiguous())


def _check_boxes(boxes, rows, name):
    """The entries' pixel boxes as K1, K6, K2, K4 and the crowd forms of K2,
    K4 and K1 take them: int16 [E, 4] beside rows of a multiple of 4 lanes.
    None means no entry's reach is known: each gets the whole range, and
    its tile evaluates it over all of its pixels."""
    n = rows.shape[0]
    if rows.shape[1] < 12 or rows.shape[1] % 4:
        raise ValueError(f"{name}: rows must hold a multiple of 4 lanes, at "
                         f"least 12 (the kernel loads them four at a time), "
                         f"got {rows.shape[1]}")
    if boxes is None:
        whole = torch.tensor([_BOX_MIN, _BOX_MIN, _BOX_MAX, _BOX_MAX],
                             dtype=torch.int16, device=rows.device)
        return whole.expand(n, 4).contiguous()
    if boxes.dtype != torch.int16 or boxes.shape != (n, 4):
        raise TypeError(f"{name}: boxes must be int16 [{n}, 4]")
    if boxes.device != rows.device:
        raise ValueError(f"{name}: boxes on another device")
    return boxes.contiguous()


def depth_tiles(sorted_rows, starts, counts, width, height, boxes=None):
    """K1 dispatch: plain version for CPU tensors (brute force: it ignores
    the boxes), CUDA kernel for CUDA, which evaluates an entry only inside
    its box (`boxes` int16 [E, 4] in entry order, from `_bin`; None: every
    entry over its whole tile)."""
    global depth_launches
    dev = sorted_rows.device
    if dev.type == "cpu":
        return depth_tiles_plain(sorted_rows, starts, counts, width, height)
    if dev.type != "cuda":
        raise ValueError(f"depth_tiles: unsupported device {dev}")
    rows, starts, counts = _check_bins(sorted_rows, starts, counts, width,
                                       height, 11, "depth_tiles")
    boxes = _check_boxes(boxes, rows, "depth_tiles")
    tiles_x, tiles_y, n_tiles = _grid(width, height)
    pad_h, pad_w = tiles_y * TILE_H, tiles_x * TILE_W
    if max(pad_h, pad_w) > _BOX_MAX:
        raise ValueError("depth_tiles: frame beyond the boxes' range")
    depth = torch.empty((pad_h, pad_w), dtype=torch.float32, device=dev)
    rc = _build.lib().smr_depth_tiles(
        starts.data_ptr(), counts.data_ptr(), rows.data_ptr(),
        boxes.data_ptr(), rows.shape[1], n_tiles, tiles_x, WIDE_BOX,
        depth.data_ptr(), pad_w, _build.stream_ptr(dev))
    _build.check(rc, "smr_depth_tiles")
    depth_launches += 1
    return depth


def raster_tiles(sorted_rows, starts, counts, width, height, n_attrs,
                 boxes=None):
    """K2 dispatch: plain version for CPU tensors (brute force: it ignores
    the boxes), CUDA kernel for CUDA, which evaluates an entry only inside
    its box (`boxes` int16 [E, 4] in entry order, from `_bin`; None: every
    entry over its whole tile)."""
    global raster_launches
    dev = sorted_rows.device
    if dev.type == "cpu":
        return raster_tiles_plain(sorted_rows, starts, counts, width, height,
                                  n_attrs)
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {dev}")
    if not 0 <= n_attrs <= MAX_ATTRS:
        raise ValueError(f"raster_tiles: n_attrs {n_attrs} out of range")
    rows, starts, counts = _check_bins(
        sorted_rows, starts, counts, width, height,
        BASE_WIDTH + 3 + 3 * n_attrs if n_attrs else 11, "raster_tiles")
    boxes = _check_boxes(boxes, rows, "raster_tiles")
    tiles_x, tiles_y, n_tiles = _grid(width, height)
    pad_h, pad_w = tiles_y * TILE_H, tiles_x * TILE_W
    if max(pad_h, pad_w) > _BOX_MAX:
        raise ValueError("raster_tiles: frame beyond the boxes' range")
    f32 = dict(dtype=torch.float32, device=dev)
    depth = torch.empty((pad_h, pad_w), **f32)
    tri = torch.empty((pad_h, pad_w), dtype=torch.int32, device=dev)
    b1 = torch.empty((pad_h, pad_w), **f32)
    b2 = torch.empty((pad_h, pad_w), **f32)
    attr = torch.empty((max(n_attrs, 1), pad_h, pad_w), **f32)
    rc = _build.lib().smr_raster_tiles(
        starts.data_ptr(), counts.data_ptr(), rows.data_ptr(),
        boxes.data_ptr(), rows.shape[1], n_attrs, n_tiles, tiles_x, WIDE_BOX,
        depth.data_ptr(), tri.data_ptr(), b1.data_ptr(), b2.data_ptr(),
        attr.data_ptr(), pad_h, pad_w, _build.stream_ptr(dev))
    _build.check(rc, "smr_raster_tiles")
    raster_launches += 1
    return depth, tri, b1, b2, attr


def raster_tiles_ms(sorted_rows, starts, counts, width, height, n_attrs,
                    boxes=None):
    """K4 dispatch: plain version for CPU tensors (brute force: it ignores
    the boxes), CUDA kernel for CUDA, which evaluates an entry only inside
    its box (`boxes` int16 [E, 4] in entry order, from `_bin`; None: every
    entry over its whole tile)."""
    global raster_ms_launches
    dev = sorted_rows.device
    if dev.type == "cpu":
        return raster_tiles_ms_plain(sorted_rows, starts, counts, width,
                                     height, n_attrs)
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles_ms: unsupported device {dev}")
    if not 0 <= n_attrs <= MAX_ATTRS:
        raise ValueError(f"raster_tiles_ms: n_attrs {n_attrs} out of range")
    rows, starts, counts = _check_bins(
        sorted_rows, starts, counts, width, height,
        BASE_WIDTH + 3 + 3 * n_attrs if n_attrs else 11, "raster_tiles_ms")
    boxes = _check_boxes(boxes, rows, "raster_tiles_ms")
    tiles_x, tiles_y, n_tiles = _grid(width, height)
    pad_h, pad_w = tiles_y * TILE_H, tiles_x * TILE_W
    if max(pad_h, pad_w) > _BOX_MAX:
        raise ValueError("raster_tiles_ms: frame beyond the boxes' range")
    f32 = dict(dtype=torch.float32, device=dev)
    depth = torch.empty((pad_h, pad_w), **f32)
    tri = torch.empty((pad_h, pad_w), dtype=torch.int32, device=dev)
    b1 = torch.empty((pad_h, pad_w), **f32)
    b2 = torch.empty((pad_h, pad_w), **f32)
    attr = torch.empty((max(n_attrs, 1), pad_h, pad_w), **f32)
    sdepth = torch.empty((4, pad_h, pad_w), **f32)
    rc = _build.lib().smr_raster_tiles_ms(
        starts.data_ptr(), counts.data_ptr(), rows.data_ptr(),
        boxes.data_ptr(), rows.shape[1], n_attrs, n_tiles, tiles_x, WIDE_BOX,
        depth.data_ptr(), tri.data_ptr(), b1.data_ptr(), b2.data_ptr(),
        attr.data_ptr(), sdepth.data_ptr(), pad_h, pad_w,
        _build.stream_ptr(dev))
    _build.check(rc, "smr_raster_tiles_ms")
    raster_ms_launches += 1
    return depth, tri, b1, b2, attr, sdepth


def depth_tiles_win(sorted_rows, starts, counts, window, width, height,
                    tile_h, boxes=None):
    """K6 dispatch: plain version for CPU tensors (brute force: it ignores
    the boxes), CUDA kernel for CUDA, which evaluates an entry only inside
    its box (`boxes` as depth_tiles takes them, over tile_h-row bins).
    `window` is an int32 [4] tensor on the rows' device (see
    depth_tiles_win_plain); the kernel reads it on the card, so sizing the
    window takes no host synchronisation. Its grid covers every tile of
    the map and the blocks past the window's tile count exit at once."""
    global depth_win_launches
    if tile_h not in WIN_TILE_H:
        raise ValueError(f"depth_tiles_win: tile_h {tile_h} not in "
                         f"{WIN_TILE_H}")
    dev = sorted_rows.device
    if window.dtype != torch.int32 or window.shape != (4,):
        raise TypeError("depth_tiles_win: window must be int32 [4]")
    if window.device != dev:
        raise ValueError("depth_tiles_win: window on another device")
    if dev.type == "cpu":
        return depth_tiles_win_plain(sorted_rows, starts, counts, window,
                                     width, height, tile_h)
    if dev.type != "cuda":
        raise ValueError(f"depth_tiles_win: unsupported device {dev}")
    rows, starts, counts = _check_bins(sorted_rows, starts, counts, width,
                                       height, 11, "depth_tiles_win", tile_h)
    boxes = _check_boxes(boxes, rows, "depth_tiles_win")
    tiles_x, tiles_y, n_tiles = _grid(width, height, tile_h)
    pad_h, pad_w = tiles_y * tile_h, tiles_x * TILE_W
    if max(pad_h, pad_w) > _BOX_MAX:
        raise ValueError("depth_tiles_win: frame beyond the boxes' range")
    depth = torch.ones((pad_h, pad_w), dtype=torch.float32, device=dev)
    rc = _build.lib().smr_depth_tiles_win(
        window.contiguous().data_ptr(), starts.data_ptr(), counts.data_ptr(),
        rows.data_ptr(), boxes.data_ptr(), rows.shape[1], n_tiles, tiles_x,
        tile_h, WIDE_BOX, depth.data_ptr(), pad_w,
        _build.stream_ptr(dev))
    _build.check(rc, "smr_depth_tiles_win")
    depth_win_launches += 1
    return depth


def _run_depth_kernel(sorted_rows, starts, counts, width, height,
                      boxes=None):
    return depth_tiles(sorted_rows, starts, counts, width, height,
                       boxes)[:height, :width]


def _run_kernel(sorted_rows, starts, counts, width, height, n_attrs,
                boxes=None):
    depth, tri, b1, b2, attr = raster_tiles(sorted_rows, starts, counts,
                                            width, height, n_attrs, boxes)
    vis = raster.VisBuffer(
        depth=depth[:height, :width],
        tri=tri[:height, :width],
        bary=torch.stack([b1[:height, :width], b2[:height, :width]], -1))
    return vis, attr[:, :height, :width]


def binning_stats(clip, tris, width, height, cull=raster.CULL_BACK, e_max=6,
                  chunk=256, tile_h=None):
    """Binning diagnostics of a scene at given raster parameters ->
    dict(max_tile_entries, total_entries, n_big, big_capacity,
    big_dropped): the fullest tile's entries (the dense-tile cost driver),
    all entries, the triangles spanning more than `e_max` tiles (the
    big-triangle merge's), BIG_TRI_CAP and how many of them the merge's
    cap drops. `chunk` is the reference's streaming chunk, kept for its
    call form: the port's tile loops have none. Reads the host."""
    s = raster.setup(clip, tris, width, height, cull)
    t = tris.shape[0]
    rows = _setup_rows(s, torch.arange(t, device=clip.device))
    _, _, counts, big = _bin(s, rows, width, height, e_max,
                             t >= COMPACT_MIN_T, tile_h or TILE_H)
    n_big = int(big.sum())
    return dict(max_tile_entries=int(counts.max()),
                total_entries=int(counts.sum()), n_big=n_big,
                big_capacity=BIG_TRI_CAP,
                big_dropped=max(0, n_big - BIG_TRI_CAP))


# ---------------------------------------------------------------------------
# Oversized triangles: the exact scan raster (KS), merged by depth
# ---------------------------------------------------------------------------

# pixels x triangles the plain scan evaluates at once (its chunk of
# triangles is this over the frame's pixels, at most SCAN_CHUNK)
SCAN_CHUNK_ELEMS = 1 << 20
SCAN_CHUNK = 64
# KS's coarse tiles (pixels a side, a multiple of its 16 x 16 block):
# chip_smoke.py's `scan:` phase sweeps 16 to 128 at the 1080p character and
# the 2048^2 shadow map, where KSb + KS took least time at 32 (PERF.md §6);
# a launch whose bins would pass SCAN_BINS_MAX bytes takes the least
# doubling of it under that
SCAN_TILE = 32
SCAN_BLOCK = 16
SCAN_BINS_MAX = 1 << 26

scan_launches = 0          # KS
scan_bin_launches = 0      # KSb


def _scan_start(vis, lead, width, height, dev):
    """The scan's start buffer as fresh tensors: a copy of `vis` (depth
    [*lead, H, W] f32, tri i32, bary [*lead, H, W, 2] f32), or cleared to
    depth 1, triangle -1, barycentrics 0."""
    if vis is None:
        vis = raster.empty_vis(width, height, dev, lead)
    want = lead + (height, width)
    if (vis.depth.shape != want or vis.tri.shape != want
            or vis.bary.shape != want + (2,)):
        raise ValueError(f"scan raster: start vis shapes do not match "
                         f"{want}")
    if (vis.depth.dtype != torch.float32 or vis.tri.dtype != torch.int32
            or vis.bary.dtype != torch.float32):
        raise TypeError("scan raster: start vis must be f32 depth, i32 tri, "
                        "f32 bary")
    planes = (vis.depth, vis.tri, vis.bary)
    if any(t.device != dev for t in planes):
        raise ValueError("scan raster: start vis on another device")
    return tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in planes)


def _inv_area(area2):
    return torch.where(torch.abs(area2) > 1e-12, 1.0 / area2,
                       torch.zeros_like(area2))


def _scan_planes(s, ids, inv_area, xs, ys):
    """The scan body's per-pixel planes of triangles `ids` [K] of a setup
    over pixel centres xs [1, W], ys [H, 1] -> (b1, b2, zp, candidate)
    [*lead, K, H, W], the candidates the covered pixels with 0 <= zp <= 1,
    in the reference's per-element arithmetic (each operator rounding
    once)."""
    def px(t):      # [*lead, K] per-triangle values against the pixels
        return t[..., None, None]

    def edge(a, b):
        return (b[0] - a[0]) * (ys - a[1]) - (b[1] - a[1]) * (xs - a[0])

    xy = s["xy"][..., ids, :, :]
    v = [(px(xy[..., j, 0]), px(xy[..., j, 1])) for j in range(3)]
    z = [px(s["z"][..., ids, j]) for j in range(3)]
    ia = px(inv_area[..., ids])
    b0 = edge(v[1], v[2]) * ia
    b1 = edge(v[2], v[0]) * ia
    b2 = edge(v[0], v[1]) * ia
    zp = b0 * z[0] + b1 * z[1] + b2 * z[2]
    cand = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0) & px(s["valid"][..., ids])
            & (zp >= 0.0) & (zp <= 1.0))
    return b1, b2, zp, cand


def scan_raster_plain(width, height, s, vis=None, chunk=None):
    """Plain version of KS: the exact scan raster over a setup of n
    triangles (`raster.setup`'s xy, z, area2, valid as [n, ...], or
    [I, n, ...] for I instances at once) from the start buffer `vis`
    (None: cleared), triangles in draw order, later triangles winning
    z-ties (LESS_EQUAL) -> VisBuffer [*lead, H, W] with tri the index in
    the setup.

    Triangles run in chunks of `chunk` (default: SCAN_CHUNK_ELEMS over the
    frame's pixels, at most SCAN_CHUNK); a chunk's [K, H, W] edge
    functions, barycentrics and depths use exactly the per-element
    arithmetic of the reference's scan body. Within a chunk the candidates
    are the covered pixels with 0 <= zp <= 1; the smallest zp wins, a tie
    going to the larger index, and the winner replaces the carry where
    zp <= depth, with its own zp and barycentrics. Under LESS_EQUAL the
    sequential scan's last pass is the last triangle whose zp equals the
    least over the candidates and the start depth, so this gives the
    scan's bits. Triangles valid in no instance can never pass and are
    left out (a host read)."""
    dev = s["xy"].device
    lead = tuple(s["xy"].shape[:-3])
    depth, tri_id, bary = _scan_start(vis, lead, width, height, dev)
    n_inst = math.prod(lead)
    keep = torch.nonzero(s["valid"].reshape(n_inst, -1).any(0))[:, 0]
    n = keep.shape[0]
    if n == 0 or width * height == 0:
        return raster.VisBuffer(depth=depth, tri=tri_id, bary=bary)
    if chunk is None:
        chunk = max(1, min(SCAN_CHUNK,
                           SCAN_CHUNK_ELEMS // (n_inst * width * height)))
    centres = raster._pixel_centers(width, height, dev)
    inv_area = _inv_area(s["area2"])
    b1_c, b2_c = bary[..., 0], bary[..., 1]
    for k0 in range(0, n, chunk):
        ids = keep[k0:k0 + chunk]
        b1, b2, zp, cand = _scan_planes(s, ids, inv_area, *centres)
        zc = torch.where(cand, zp, torch.full_like(zp, 2.0))
        least = torch.amin(zc, -3, keepdim=True)
        order = torch.arange(ids.shape[0], device=dev)[:, None, None]
        last = torch.amax(torch.where(cand & (zc == least), order,
                                      torch.full_like(order, -1)), -3)
        at = torch.clamp(last, min=0)[..., None, :, :]

        def won(t):
            return torch.gather(t, -3, at)[..., 0, :, :]
        zw = won(zp)
        passed = (last >= 0) & (zw <= depth)
        depth = torch.where(passed, zw, depth)
        tri_id = torch.where(passed, ids[torch.clamp(last, min=0)].to(
            torch.int32), tri_id)
        b1_c = torch.where(passed, won(b1), b1_c)
        b2_c = torch.where(passed, won(b2), b2_c)
    return raster.VisBuffer(depth=depth, tri=tri_id,
                            bary=torch.stack([b1_c, b2_c], -1))


def _scan_table(s):
    """KS's per-triangle setup table f32 [*lead, n, 16]: x0, y0, x1, y1,
    x2, y2, z0, z1, z2, inv_area, valid, 0 and the pixel box (first
    column, first row, last column, last row) at the pixel centre."""
    xy = s["xy"]
    zero = torch.zeros_like(s["area2"])[..., None]
    return torch.cat([
        xy.flatten(-2), s["z"], _inv_area(s["area2"])[..., None],
        s["valid"].to(torch.float32)[..., None], zero,
        _pixel_boxes(s, 0.0).to(torch.float32)], -1)


def _scan_words(n):
    return -(-n // 32)


def scan_tile(n_inst, n, width, height):
    """KS's coarse tile for a launch: SCAN_TILE, doubled while the bins
    (`n_inst` x tiles x (ceil(n / 32) + 1) words) would pass SCAN_BINS_MAX
    bytes and a tile is smaller than the frame. It follows from the shapes
    alone, so the launch reads nothing on the host."""
    tile = SCAN_TILE
    while (tile < max(width, height)
           and 4 * n_inst * (_scan_words(n) + 1) * -(-width // tile)
           * -(-height // tile) > SCAN_BINS_MAX):
        tile *= 2
    return tile


def scan_bins_plain(table, width, height, tile):
    """Plain version of KSb: for each instance and coarse tile of `tile` x
    `tile` pixels, bit k of word k // 32 set when triangle k of `table`
    (`_scan_table`, [n_inst, n, 16]) is valid and its pixel box, clipped
    to the frame, meets the tile, and a last word, the tile's flag, 1 when
    any bit is -> int32 [n_inst, tiles_y * tiles_x, ceil(n / 32) + 1]
    holding the words' bits (tiles row-major)."""
    n_inst, n = table.shape[:2]
    dev = table.device
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    words = _scan_words(n)
    box = table[..., 12:16]
    keep = ((table[..., 10] > 0) & (box[..., 0] <= width - 1)
            & (box[..., 2] >= 0) & (box[..., 1] <= height - 1)
            & (box[..., 3] >= 0))
    box = torch.where(keep[..., None], box, 0.0).long()
    t_lo = torch.clamp(box[..., :2], min=0) // tile
    t_hi = torch.stack([torch.clamp(box[..., 2], max=width - 1),
                        torch.clamp(box[..., 3], max=height - 1)], -1) // tile
    tx = torch.arange(tiles_x, device=dev)
    ty = torch.arange(tiles_y, device=dev)
    out = torch.zeros((n_inst, tiles_y * tiles_x, words), dtype=torch.int64,
                      device=dev)
    weight = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev)
    step = 64 * 32                   # triangles a pass (64 words)
    for k0 in range(0, n, step):
        k1 = min(n, k0 + step)
        in_x = ((tx >= t_lo[:, k0:k1, 0, None])
                & (tx <= t_hi[:, k0:k1, 0, None]))
        in_y = ((ty >= t_lo[:, k0:k1, 1, None])
                & (ty <= t_hi[:, k0:k1, 1, None]))
        hit = (keep[:, k0:k1, None, None] & in_y[..., :, None]
               & in_x[..., None, :]).reshape(n_inst, k1 - k0, -1)
        hit = torch.nn.functional.pad(hit, (0, 0, 0, (-(k1 - k0)) % 32))
        bits = hit.reshape(n_inst, -1, 32, hit.shape[-1]).long()
        out[..., k0 // 32:-(-k1 // 32)] = (
            bits * weight[:, None]).sum(-2).transpose(-1, -2)
    out = torch.cat([out, (out != 0).any(-1, keepdim=True).long()], -1)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def _scan_shapes(table, width, height, tile, who):
    """Checks KSb's and KS's common arguments -> (n_inst, n, tiles)."""
    if table.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {table.device}")
    if max(width, height) > _BOX_MAX:
        raise ValueError(f"{who}: frame beyond the boxes' range")
    if (table.dim() != 3 or table.shape[-1] != 16
            or table.dtype != torch.float32 or not table.is_contiguous()):
        raise ValueError(f"{who}: the table must be contiguous f32 "
                         "[n_inst, n, 16]")
    if tile <= 0 or tile % SCAN_BLOCK:
        raise ValueError(f"{who}: tile {tile} is not a positive multiple "
                         f"of {SCAN_BLOCK}")
    n_inst, n = table.shape[:2]
    return n_inst, n, -(-width // tile) * -(-height // tile)


def scan_bins(table, width, height, tile):
    """KSb dispatch: the scan raster's tile bins (see scan_bins_plain) —
    the plain version for a CPU table, the CUDA kernel (a clear and a
    launch on the stream, no host read) for a CUDA one."""
    global scan_bin_launches
    dev = table.device
    if dev.type == "cpu":
        return scan_bins_plain(table, width, height, tile)
    n_inst, n, tiles = _scan_shapes(table, width, height, tile, "scan_bins")
    shape = (n_inst, tiles, _scan_words(n) + 1)
    if not (n and n_inst and tiles):
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    bins = torch.empty(shape, dtype=torch.int32, device=dev)
    rc = _build.lib().smr_scan_bins(
        table.data_ptr(), n, n_inst, width, height, tile,
        bins.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, "smr_scan_bins")
    scan_bin_launches += 1
    return bins


def scan_walk(table, bins, tile, depth, tri_id, bary):
    """KS: the scan over `table` ([n_inst, n, 16], `_scan_table`) through
    the bins KSb built from it at `tile`, into the start buffer depth /
    tri_id [n_inst, H, W], bary [n_inst, H, W, 2] (contiguous, on the
    card), in place."""
    global scan_launches
    height, width = depth.shape[-2:]
    n_inst, n, tiles = _scan_shapes(table, width, height, tile, "scan_walk")
    if (bins.shape != (n_inst, tiles, _scan_words(n) + 1)
            or bins.dtype != torch.int32 or not bins.is_contiguous()
            or bins.device != table.device):
        raise ValueError(f"scan_walk: bins {tuple(bins.shape)} do not fit "
                         f"the table and tile {tile}")
    pixels = n_inst * height * width
    for plane, dtype, size in ((depth, torch.float32, pixels),
                               (tri_id, torch.int32, pixels),
                               (bary, torch.float32, 2 * pixels)):
        if (plane.dtype != dtype or plane.numel() != size
                or not plane.is_contiguous()
                or plane.device != table.device):
            raise ValueError("scan_walk: the start buffer does not fit the "
                             "table")
    rc = _build.lib().smr_scan_raster(
        table.data_ptr(), bins.data_ptr(), n, n_inst, width, height, tile,
        depth.data_ptr(), tri_id.data_ptr(), bary.data_ptr(),
        _build.stream_ptr(table.device))
    _build.check(rc, "smr_scan_raster")
    scan_launches += 1


def scan_raster(width, height, s, vis=None):
    """KS dispatch: the exact scan raster (see scan_raster_plain) — the
    plain version for CPU tensors; for CUDA tensors KSb (`scan_bins`) bins
    the triangles by their pixel boxes into coarse tiles (`scan_tile`) and
    KS (`scan_walk`) evaluates, in every block of pixels, only the
    triangles of its tile whose box reaches it. No host read on the
    card."""
    dev = s["xy"].device
    if dev.type == "cpu":
        return scan_raster_plain(width, height, s, vis)
    if dev.type != "cuda":
        raise ValueError(f"scan_raster: unsupported device {dev}")
    if max(width, height) > _BOX_MAX:
        raise ValueError("scan_raster: frame beyond the boxes' range")
    lead = tuple(s["xy"].shape[:-3])
    n = s["xy"].shape[-3]
    depth, tri_id, bary = _scan_start(vis, lead, width, height, dev)
    n_inst = math.prod(lead)
    if n and n_inst and width and height:
        table = _scan_table(s).reshape(n_inst, n, 16).contiguous()
        tile = scan_tile(n_inst, n, width, height)
        scan_walk(table, scan_bins(table, width, height, tile), tile, depth,
                  tri_id, bary)
    return raster.VisBuffer(depth=depth, tri=tri_id, bary=bary)


def _big_subset(s, big):
    """Setup of the first BIG_TRI_CAP oversized triangles (stable order) ->
    (order [n], setup dict), or None when there is none. Triangles past
    the oversized ones could never pass the scan, so only those run."""
    with host_read("big"):
        n_big = int(big.sum())          # host sync
    if n_big == 0:
        return None
    n = min(BIG_TRI_CAP, big.shape[0], n_big)
    order = torch.argsort((~big).to(torch.int32), stable=True)[:n]
    return order, {
        "xy": s["xy"][order],
        "z": s["z"][order],
        "area2": s["area2"][order],
        "valid": (s["valid"] & big)[order],
    }


def _merge_big(vis, attr, clip, tris, width, height, s, big, attrs):
    """Exact scan raster over oversized triangles, merged by depth (a big
    triangle wins a tie)."""
    sub = _big_subset(s, big)
    if sub is None:
        return vis, attr
    order, s_big = sub
    vis_big = scan_raster(width, height, s_big)
    real_tri = torch.where(vis_big.tri >= 0,
                           order[torch.clamp(vis_big.tri, min=0).long()].to(
                               torch.int32), -1)
    better = (vis_big.depth <= vis.depth) & (vis_big.tri >= 0)
    merged = raster.VisBuffer(
        depth=torch.where(better, vis_big.depth, vis.depth),
        tri=torch.where(better, real_tri, vis.tri),
        bary=torch.where(better[..., None], vis_big.bary, vis.bary))
    if attrs is not None:
        big_attr = raster.interpolate(vis_big, clip, tris[order], attrs)
        attr = torch.where(better[None], big_attr.movedim(-1, 0), attr)
    return merged, attr


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _check_chunk(chunk, who):
    """The reference's `chunk` is its DMA unit of a tile's entries and
    changes no result; the port takes it and checks it as the reference
    asserts it (a positive multiple of CHUNK_GROUP), and every valid value
    gives the same bits."""
    if (not isinstance(chunk, int) or isinstance(chunk, bool) or chunk <= 0
            or chunk % CHUNK_GROUP):
        raise ValueError(f"{who}: chunk must be a positive multiple of "
                         f"{CHUNK_GROUP}, got {chunk!r}")


def rasterize_depth_tiled(clip, tris, width, height, cull=raster.CULL_BACK,
                          e_max=9, chunk=256, nocull=None, compact=True,
                          cv=None):
    """Depth-only binned rasterization (shadow maps) -> [H, W] depth. `cv`
    may pass pre-gathered per-corner clip coords [T,3,4]. `nocull` [T]
    bool exempts double-sided triangles from face culling (in the setup's
    validity: the binning, K1 and the big-triangle merge all see it).
    `chunk` is the reference's streaming unit: checked, and the same bits
    for every valid value."""
    _check_chunk(chunk, "rasterize_depth_tiled")
    s = raster.setup(clip, tris, width, height, cull, cv=cv, nocull=nocull)
    t = tris.shape[0]
    rows = _setup_rows(s, torch.arange(t, device=clip.device))
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin(
        s, rows, width, height, e_max, compact and t >= COMPACT_MIN_T,
        boxes=_kernel_boxes(s, 0.0))
    depth = _run_depth_kernel(sorted_rows, starts, counts, width, height,
                              *boxes)
    if _covers_all(e_max, width, height):
        return depth
    sub = _big_subset(s, big)
    if sub is None:
        return depth
    return torch.minimum(depth, scan_raster(width, height, sub[1]).depth)


def rasterize_tiled(clip, tris, width, height, cull=raster.CULL_BACK,
                    e_max=9, chunk=256, compact=True) -> raster.VisBuffer:
    """Visibility only (K2 at A = 0), with rasterize_attrs_tiled's
    compaction and big-triangle merge -> VisBuffer [H, W] (the single
    frame's edge hull). `chunk` as rasterize_depth_tiled takes it."""
    _check_chunk(chunk, "rasterize_tiled")
    s = raster.setup(clip, tris, width, height, cull)
    t = tris.shape[0]
    rows = _setup_rows(s, torch.arange(t, device=clip.device))
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin(
        s, rows, width, height, e_max, compact and t >= COMPACT_MIN_T,
        boxes=_kernel_boxes(s, 0.0))
    vis, _ = _run_kernel(sorted_rows, starts, counts, width, height, 0,
                         *boxes)
    if not _covers_all(e_max, width, height):
        vis, _ = _merge_big(vis, None, clip, tris, width, height, s, big,
                            None)
    return vis


def rasterize_attrs_tiled(clip, tris, attrs, width, height,
                          cull=raster.CULL_BACK, e_max=9, chunk=256,
                          nocull=None, compact=True, cv=None, va=None):
    """Raster + in-kernel perspective-correct attribute interpolation.

    attrs: [V, A] per-vertex attributes. Returns (VisBuffer, attr_img
    [H, W, A]) with zeros on empty pixels. `cv`/`va` may pass pre-gathered
    per-corner clip coords [T,3,4] and attributes [T,3,A]. `nocull` [T]
    bool exempts double-sided triangles from face culling: both windings
    bin together. `chunk` as rasterize_depth_tiled takes it."""
    _check_chunk(chunk, "rasterize_attrs_tiled")
    if cv is None:
        g = torch.cat([clip, attrs], -1)[tris.long()]
        cv, va = g[..., :4], g[..., 4:]
    s = raster.setup(clip, tris, width, height, cull, cv=cv, nocull=nocull)
    s["tris_v"] = tris
    s["va"] = va
    t = tris.shape[0]
    rows = _setup_rows(s, torch.arange(t, device=clip.device), attrs)
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin(
        s, rows, width, height, e_max, compact and t >= COMPACT_MIN_T,
        boxes=_kernel_boxes(s, 0.0))
    vis, attr = _run_kernel(sorted_rows, starts, counts, width, height,
                            attrs.shape[1], *boxes)
    if not _covers_all(e_max, width, height):
        vis, attr = _merge_big(vis, attr, clip, tris, width, height, s, big,
                               attrs)
    attr = attr.movedim(0, -1)
    attr = torch.where((vis.tri >= 0)[..., None], attr, torch.zeros_like(attr))
    return vis, attr


def rasterize_attrs_tiled_msaa(clip, tris, attrs, width, height,
                               cull=raster.CULL_BACK, e_max=9, chunk=256,
                               nocull=None, compact=True, cv=None, va=None):
    """4x-MSAA raster: centre visibility + attributes like
    rasterize_attrs_tiled (with any-sample coverage, K4), plus per-sample
    depth [4, H, W] at MSAA4_OFFSETS; a sample is covered iff its depth is
    below 1. The sample-point cull is widened by the samples' 0.375 px
    reach. Where a big triangle wins the merge, its centre depth bounds all
    four samples (oversized triangles are interior-dominated), as in the
    reference. `nocull` and `chunk` as rasterize_attrs_tiled takes them.
    Returns (VisBuffer, attr_img [H, W, A], sdepth)."""
    _check_chunk(chunk, "rasterize_attrs_tiled_msaa")
    if cv is None:
        g = torch.cat([clip, attrs], -1)[tris.long()]
        cv, va = g[..., :4], g[..., 4:]
    s = raster.setup(clip, tris, width, height, cull, cv=cv,
                     sample_extent=MSAA4_EXTENT, nocull=nocull)
    s["tris_v"] = tris
    s["va"] = va
    t = tris.shape[0]
    rows = _setup_rows(s, torch.arange(t, device=clip.device), attrs)
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin(
        s, rows, width, height, e_max, compact and t >= COMPACT_MIN_T,
        boxes=_kernel_boxes(s, MSAA4_EXTENT))
    depth, tri, b1, b2, attr, sdepth = raster_tiles_ms(
        sorted_rows, starts, counts, width, height, attrs.shape[1], *boxes)
    vis = raster.VisBuffer(
        depth=depth[:height, :width], tri=tri[:height, :width],
        bary=torch.stack([b1[:height, :width], b2[:height, :width]], -1))
    attr = attr[:, :height, :width]
    sdepth = sdepth[:, :height, :width]
    if not _covers_all(e_max, width, height):
        vis0 = vis
        vis, attr = _merge_big(vis, attr, clip, tris, width, height, s, big,
                               attrs)
        if vis is not vis0:
            big_won = (vis.depth < vis0.depth) | (vis.tri != vis0.tri)
            sdepth = torch.where(big_won[None],
                                 torch.minimum(sdepth, vis.depth[None]),
                                 sdepth)
    attr = attr.movedim(0, -1)
    attr = torch.where((vis.tri >= 0)[..., None], attr, torch.zeros_like(attr))
    return vis, attr, sdepth


def _caster_window(s, width, height, tile_h):
    """The casters' tile bounding box over valid triangles, with
    _expand_tiles' clamps (so every binned entry's tile lies inside it), as
    an int32 [4] (first row, first column, rows, columns) computed on the
    device. No valid triangle gives an empty window."""
    tiles_x, tiles_y, _ = _grid(width, height, tile_h)
    xy, valid = s["xy"], s["valid"]
    if xy.shape[0] == 0:
        return torch.zeros(4, dtype=torch.int32, device=xy.device)

    def tile_of(v, lo_hi, size, extent):
        v = lo_hi(v, 1)
        return torch.floor_divide(torch.clamp(v, 0.0, extent - 1.0),
                                  size).to(torch.int64)

    x, y = xy[:, :, 0], xy[:, :, 1]
    tx0 = torch.where(valid, tile_of(x, torch.amin, TILE_W, width),
                      tiles_x - 1).amin()
    tx1 = torch.where(valid, tile_of(x, torch.amax, TILE_W, width), 0).amax()
    ty0 = torch.where(valid, tile_of(y, torch.amin, tile_h, height),
                      tiles_y - 1).amin()
    ty1 = torch.where(valid, tile_of(y, torch.amax, tile_h, height),
                      0).amax()
    rows_n = torch.clamp(ty1 + 1 - ty0, min=0)
    cols_n = torch.clamp(tx1 + 1 - tx0, min=0)
    return torch.stack([ty0, tx0, rows_n, cols_n]).to(torch.int32)


def rasterize_depth_tiled_window(clip, tris, width, height,
                                 cull=raster.CULL_BACK, e_max=9, chunk=256,
                                 tile_h=8, cv=None, compact=True):
    """Depth-only rasterization restricted to the casters' tile bounding
    box (K6), pasted into a map of 1.0: equal to rasterize_depth_tiled's
    map wherever no triangle falls to the big-triangle merge, since the
    window's tiles get K1's bits and no entry lies outside it. The window
    is the exact box, sized on the device (the reference picks it from a
    static ladder of extents for its compiler; every extent that holds the
    box gives the same map). Bins are over tile_h x TILE_W tiles, so the
    big-triangle threshold (more than e_max tiles) is at this grid.
    `chunk` as rasterize_depth_tiled takes it; `compact` (the port's alone,
    after the reference's parameters) as there."""
    _check_chunk(chunk, "rasterize_depth_tiled_window")
    s = raster.setup(clip, tris, width, height, cull, cv=cv)
    t = tris.shape[0]
    rows = _setup_rows(s, torch.arange(t, device=clip.device))
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin(
        s, rows, width, height, e_max, compact and t >= COMPACT_MIN_T, tile_h,
        boxes=_kernel_boxes(s, 0.0))
    window = _caster_window(s, width, height, tile_h)
    depth = depth_tiles_win(sorted_rows, starts, counts, window, width,
                            height, tile_h, *boxes)[:height, :width]
    if _covers_all(e_max, width, height, tile_h):
        return depth
    sub = _big_subset(s, big)
    if sub is None:
        return depth
    return torch.minimum(depth, scan_raster(width, height, sub[1]).depth)


# ---------------------------------------------------------------------------
# Crowd: one binning and one kernel launch over instance x tile
# ---------------------------------------------------------------------------

# most tiles a triangle may be binned into on the crowd path (bins then
# compare with the reference's); oversized triangles take the capped merge
CROWD_E_MAX = 6

# launches of the crowd kernels since the last reset
raster_multi_launches = 0      # K5a
raster_ms_multi_launches = 0   # K5b
depth_multi_launches = 0       # K5c


def _crowd_e_max(width, height) -> int:
    return min(_grid(width, height)[2], CROWD_E_MAX)


def _bin_crowd(s, rows, width, height, boxes=None):
    """Crowd binning: one pass over the valid triangles of all instances,
    keyed by the global tile inst * n_tiles + tile, then by draw order
    (inst * T + triangle) -> (sorted_rows [N, W], starts i32
    [I * n_tiles + 1], counts i32 [I * n_tiles], big [I, T]); with
    per-triangle `boxes` [I, T, 4] (`_pixel_boxes`), also those in entry
    order [N, 4].

    The valid triangles are compacted to their exact count on the device
    (one host read, as `_bin` has), so one sort covers them all; it equals
    the reference's validity-compacted passes merged in draw order."""
    n_tiles = _grid(width, height)[2]
    tile, big = _expand_tiles(s, width, height, _crowd_e_max(width, height))
    n_inst, t, e_max = tile.shape
    all_tiles = n_inst * n_tiles
    dev = tile.device
    inst = torch.arange(n_inst, device=dev)[:, None, None]
    gtile = torch.where(tile < n_tiles, inst * n_tiles + tile,
                        all_tiles).reshape(n_inst * t, e_max)
    # slot 0 is real iff the triangle produced any entry at all
    with host_read("bin"):
        ids = torch.nonzero(gtile[:, 0] < all_tiles).squeeze(1)
    id_bits = max(int(n_inst * t - 1).bit_length(), 1)
    key = (gtile[ids] << id_bits) | ids[:, None]
    packed = torch.sort(key.reshape(-1)).values
    sorted_id = packed & ((1 << id_bits) - 1)
    bound = torch.arange(all_tiles + 1, device=dev) << id_bits
    starts = torch.searchsorted(packed, bound).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    sorted_rows = rows.reshape(n_inst * t, -1)[sorted_id]
    if boxes is None:
        return sorted_rows, starts, counts, big
    return (sorted_rows, starts, counts, big,
            boxes.reshape(n_inst * t, 4)[sorted_id])


def depth_tiles_multi_plain(sorted_rows, starts, counts, n_inst, width,
                            height, boxes=None):
    """Plain K5c: K1's per-tile min over the instance x tile grid ->
    depth [n_inst, pad_h, pad_w]. `boxes` as in _depth_plain."""
    return _depth_plain(sorted_rows, starts, counts, width, height, TILE_H,
                        n_inst, boxes)


def raster_tiles_multi_plain(sorted_rows, starts, counts, n_inst, width,
                             height, n_attrs, boxes=None):
    """Plain K5a: K2's order-free reduction over the instance x tile grid
    -> (depth, tri, b1, b2 [n_inst, pad_h, pad_w], attr [n_inst, max(A,1),
    pad_h, pad_w]). `boxes` as in raster_tiles_plain."""
    return raster_tiles_plain(sorted_rows, starts, counts, width, height,
                              n_attrs, n_inst, boxes)


def raster_tiles_ms_multi_plain(sorted_rows, starts, counts, n_inst, width,
                                height, n_attrs, boxes=None):
    """Plain K5b: K4's order-free reduction over the instance x tile grid
    -> K5a's outputs plus sdepth [n_inst, 4, pad_h, pad_w]; the depth is
    un-biased, as K4's. `boxes` as in raster_tiles_ms_plain."""
    return raster_tiles_ms_plain(sorted_rows, starts, counts, width, height,
                                 n_attrs, n_inst, boxes)


def _multi_planes(n_inst, width, height, n_attrs, dev, sdepth=False):
    tiles_x, tiles_y, _ = _grid(width, height)
    shape = (n_inst, tiles_y * TILE_H, tiles_x * TILE_W)
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty(shape, **f32),
           torch.empty(shape, dtype=torch.int32, device=dev),
           torch.empty(shape, **f32), torch.empty(shape, **f32),
           torch.empty((n_inst, max(n_attrs, 1)) + shape[1:], **f32)]
    if sdepth:
        out.append(torch.empty((n_inst, 4) + shape[1:], **f32))
    return out


def depth_tiles_multi(sorted_rows, starts, counts, n_inst, width, height,
                      boxes=None):
    """K5c dispatch: plain version for CPU tensors, CUDA kernel for CUDA;
    `boxes` as depth_tiles takes them (from `_bin_crowd`)."""
    global depth_multi_launches
    dev = sorted_rows.device
    if dev.type == "cpu":
        return depth_tiles_multi_plain(sorted_rows, starts, counts, n_inst,
                                       width, height)
    if dev.type != "cuda":
        raise ValueError(f"depth_tiles_multi: unsupported device {dev}")
    rows, starts, counts = _check_bins(sorted_rows, starts, counts, width,
                                       height, 11, "depth_tiles_multi",
                                       n_inst=n_inst)
    boxes = _check_boxes(boxes, rows, "depth_tiles_multi")
    tiles_x, tiles_y, n_tiles = _grid(width, height)
    pad_h, pad_w = tiles_y * TILE_H, tiles_x * TILE_W
    if max(pad_h, pad_w) > _BOX_MAX:
        raise ValueError("depth_tiles_multi: frame beyond the boxes' range")
    depth = torch.empty((n_inst, pad_h, pad_w), dtype=torch.float32,
                        device=dev)
    rc = _build.lib().smr_depth_tiles_multi(
        starts.data_ptr(), counts.data_ptr(), rows.data_ptr(),
        boxes.data_ptr(), rows.shape[1], n_inst, n_tiles, tiles_x, WIDE_BOX,
        depth.data_ptr(), pad_h, pad_w, _build.stream_ptr(dev))
    _build.check(rc, "smr_depth_tiles_multi")
    depth_multi_launches += 1
    return depth


def raster_tiles_multi(sorted_rows, starts, counts, n_inst, width, height,
                       n_attrs, boxes=None):
    """K5a dispatch: plain version for CPU tensors, CUDA kernel for CUDA;
    `boxes` as raster_tiles takes them (from `_bin_crowd`)."""
    global raster_multi_launches
    dev = sorted_rows.device
    if dev.type == "cpu":
        return raster_tiles_multi_plain(sorted_rows, starts, counts, n_inst,
                                        width, height, n_attrs)
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles_multi: unsupported device {dev}")
    if not 0 <= n_attrs <= MAX_ATTRS:
        raise ValueError(f"raster_tiles_multi: n_attrs {n_attrs} out of range")
    rows, starts, counts = _check_bins(
        sorted_rows, starts, counts, width, height,
        BASE_WIDTH + 3 + 3 * n_attrs if n_attrs else 11,
        "raster_tiles_multi", n_inst=n_inst)
    boxes = _check_boxes(boxes, rows, "raster_tiles_multi")
    tiles_x, _, n_tiles = _grid(width, height)
    depth, tri, b1, b2, attr = _multi_planes(n_inst, width, height, n_attrs,
                                             dev)
    if max(depth.shape[1:]) > _BOX_MAX:
        raise ValueError("raster_tiles_multi: frame beyond the boxes' range")
    rc = _build.lib().smr_raster_tiles_multi(
        starts.data_ptr(), counts.data_ptr(), rows.data_ptr(),
        boxes.data_ptr(), rows.shape[1], n_attrs, n_inst, n_tiles, tiles_x,
        WIDE_BOX, depth.data_ptr(), tri.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), attr.data_ptr(), depth.shape[1], depth.shape[2],
        _build.stream_ptr(dev))
    _build.check(rc, "smr_raster_tiles_multi")
    raster_multi_launches += 1
    return depth, tri, b1, b2, attr


def raster_tiles_ms_multi(sorted_rows, starts, counts, n_inst, width, height,
                          n_attrs, boxes=None):
    """K5b dispatch: plain version for CPU tensors, CUDA kernel for CUDA;
    `boxes` as raster_tiles_ms takes them (from `_bin_crowd`)."""
    global raster_ms_multi_launches
    dev = sorted_rows.device
    if dev.type == "cpu":
        return raster_tiles_ms_multi_plain(sorted_rows, starts, counts,
                                           n_inst, width, height, n_attrs)
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles_ms_multi: unsupported device {dev}")
    if not 0 <= n_attrs <= MAX_ATTRS:
        raise ValueError(f"raster_tiles_ms_multi: n_attrs {n_attrs} out of "
                         "range")
    rows, starts, counts = _check_bins(
        sorted_rows, starts, counts, width, height,
        BASE_WIDTH + 3 + 3 * n_attrs if n_attrs else 11,
        "raster_tiles_ms_multi", n_inst=n_inst)
    boxes = _check_boxes(boxes, rows, "raster_tiles_ms_multi")
    tiles_x, _, n_tiles = _grid(width, height)
    depth, tri, b1, b2, attr, sdepth = _multi_planes(
        n_inst, width, height, n_attrs, dev, sdepth=True)
    if max(depth.shape[1:]) > _BOX_MAX:
        raise ValueError("raster_tiles_ms_multi: frame beyond the boxes' "
                         "range")
    rc = _build.lib().smr_raster_tiles_ms_multi(
        starts.data_ptr(), counts.data_ptr(), rows.data_ptr(),
        boxes.data_ptr(), rows.shape[1], n_attrs, n_inst, n_tiles, tiles_x,
        WIDE_BOX, depth.data_ptr(), tri.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), attr.data_ptr(), sdepth.data_ptr(),
        depth.shape[1], depth.shape[2], _build.stream_ptr(dev))
    _build.check(rc, "smr_raster_tiles_ms_multi")
    raster_ms_multi_launches += 1
    return depth, tri, b1, b2, attr, sdepth


def _take(x, order):
    """x [I, T, ...] gathered along T at order [I, n] -> [I, n, ...]."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))


def _big_subset_crowd(s, big):
    """Per instance, the setup of its first BIG_TRI_CAP oversized triangles
    in stable order -> (order [I, n], setup dict of [I, n, ...]), or None
    when no instance has one (one host read for the whole crowd). n is the
    largest count of any instance, capped; an instance's slots past its own
    count are masked invalid."""
    with host_read("big"):
        n_big = int(big.sum(-1).max())      # host sync
    if n_big == 0:
        return None
    n = min(BIG_TRI_CAP, big.shape[1], n_big)
    order = torch.argsort((~big).to(torch.int32), dim=-1, stable=True)[:, :n]
    return order, {
        "xy": _take(s["xy"], order),
        "z": _take(s["z"], order),
        "area2": _take(s["area2"], order),
        "valid": _take(s["valid"] & big, order),
    }


def _merge_big_crowd(vis, attr, clip, tris, width, height, s, big, attrs):
    """The crowd's _merge_big: per instance the capped exact scan over its
    oversized triangles, all instances per step, merged by depth (a big
    triangle wins a tie). -> (vis, attr [I, A, H, W], big_won [I, H, W])."""
    sub = _big_subset_crowd(s, big)
    if sub is None:
        return vis, attr, torch.zeros_like(vis.tri, dtype=torch.bool)
    order, s_big = sub
    vis_big = scan_raster(width, height, s_big)
    n_inst = order.shape[0]
    real_tri = torch.gather(
        order, 1, torch.clamp(vis_big.tri, min=0).long().reshape(n_inst, -1)
    ).reshape(vis_big.tri.shape).to(torch.int32)
    real_tri = torch.where(vis_big.tri >= 0, real_tri, -1)
    better = (vis_big.depth <= vis.depth) & (vis_big.tri >= 0)
    merged = raster.VisBuffer(
        depth=torch.where(better, vis_big.depth, vis.depth),
        tri=torch.where(better, real_tri, vis.tri),
        bary=torch.where(better[..., None], vis_big.bary, vis.bary))
    big_attr = raster.interpolate(vis_big, clip, tris.long()[order], attrs)
    attr = torch.where(better[:, None], big_attr.movedim(-1, 1), attr)
    return merged, attr, better


def _merge_big_depth_crowd(depth, width, height, s, big):
    """Depth-only crowd big-triangle merge (shadow maps)."""
    sub = _big_subset_crowd(s, big)
    if sub is None:
        return depth
    return torch.minimum(depth, scan_raster(width, height, sub[1]).depth)


def _crowd_setup(clip, tris, attrs, width, height, cull, cv, va, nocull,
                 sample_extent=0.0):
    """Setup and rows of every instance at once -> (s, rows [I, T, W]);
    `nocull` [T] is shared by the instances."""
    if clip.dim() != 3:
        raise ValueError("crowd raster: clip must be [I, V, 4]")
    if cv is None:
        if attrs is None:
            cv = clip[:, tris.long()]
        else:
            g = torch.cat([clip, attrs], -1)[:, tris.long()]
            cv, va = g[..., :4], g[..., 4:]
    s = raster.setup(clip, tris, width, height, cull, cv=cv,
                     sample_extent=sample_extent, nocull=nocull)
    s["va"] = va
    rows = _setup_rows(s, torch.arange(tris.shape[0], device=clip.device),
                       attrs)
    return s, rows


def _crowd_vis(planes, width, height):
    depth, tri, b1, b2, attr = planes[:5]
    vis = raster.VisBuffer(
        depth=depth[:, :height, :width], tri=tri[:, :height, :width],
        bary=torch.stack([b1[:, :height, :width], b2[:, :height, :width]],
                         -1))
    return vis, attr[:, :, :height, :width]


def _crowd_attr_out(vis, attr):
    attr = attr.movedim(1, -1)
    return torch.where((vis.tri >= 0)[..., None], attr,
                       torch.zeros_like(attr))


def rasterize_attrs_tiled_crowd(clip, tris, attrs, width, height,
                                cull=raster.CULL_BACK, chunk=256, cv=None,
                                va=None, nocull=None):
    """Multi-instance raster + attribute interpolation in one binning and
    one launch of K5a.

    clip [I,V,4], tris [T,3] (shared topology), attrs [I,V,A] -> (VisBuffer
    with a leading instance axis, attr [I,H,W,A]). Binning is limited to
    `_crowd_e_max` tiles per triangle; oversized triangles merge through
    the capped scan, per instance. Per pixel and per entry the semantics
    are rasterize_attrs_tiled's. `cv` [I,T,3,4] / `va` [I,T,3,A] may pass
    pre-gathered corner tables; `nocull` [T] (double-sided triangles) is
    shared by the instances. `chunk` as rasterize_depth_tiled takes it."""
    _check_chunk(chunk, "rasterize_attrs_tiled_crowd")
    s, rows = _crowd_setup(clip, tris, attrs, width, height, cull, cv, va,
                           nocull)
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin_crowd(
        s, rows, width, height, _kernel_boxes(s, 0.0))
    vis, attr = _crowd_vis(
        raster_tiles_multi(sorted_rows, starts, counts, clip.shape[0], width,
                           height, attrs.shape[-1], *boxes), width, height)
    if not _covers_all(_crowd_e_max(width, height), width, height):
        vis, attr, _ = _merge_big_crowd(vis, attr, clip, tris, width, height,
                                        s, big, attrs)
    return vis, _crowd_attr_out(vis, attr)


def rasterize_attrs_tiled_msaa_crowd(clip, tris, attrs, width, height,
                                     cull=raster.CULL_BACK, chunk=256,
                                     cv=None, va=None, nocull=None):
    """Multi-instance 4x-MSAA raster (K5b): rasterize_attrs_tiled_crowd's
    outputs plus per-sample depth [I,4,H,W], per instance the semantics of
    rasterize_attrs_tiled_msaa. Where a big triangle wins the merge its
    centre depth bounds all four samples. `chunk` as rasterize_depth_tiled
    takes it."""
    _check_chunk(chunk, "rasterize_attrs_tiled_msaa_crowd")
    s, rows = _crowd_setup(clip, tris, attrs, width, height, cull, cv, va,
                           nocull, sample_extent=MSAA4_EXTENT)
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin_crowd(
        s, rows, width, height, _kernel_boxes(s, MSAA4_EXTENT))
    planes = raster_tiles_ms_multi(sorted_rows, starts, counts, clip.shape[0],
                                   width, height, attrs.shape[-1], *boxes)
    vis, attr = _crowd_vis(planes, width, height)
    sdepth = planes[5][:, :, :height, :width]
    if not _covers_all(_crowd_e_max(width, height), width, height):
        vis, attr, big_won = _merge_big_crowd(vis, attr, clip, tris, width,
                                              height, s, big, attrs)
        sdepth = torch.where(big_won[:, None],
                             torch.minimum(sdepth, vis.depth[:, None]),
                             sdepth)
    return vis, _crowd_attr_out(vis, attr), sdepth


def rasterize_depth_tiled_crowd(clip, tris, width, height,
                                cull=raster.CULL_FRONT, chunk=256, cv=None):
    """Multi-instance depth-only raster (crowd shadow maps, K5c): clip
    [I,V,4], tris [T,3] -> depth [I,H,W]. `cv` [I,T,3,4] may pass
    pre-gathered corner clip coords. `chunk` as rasterize_depth_tiled
    takes it."""
    _check_chunk(chunk, "rasterize_depth_tiled_crowd")
    s, rows = _crowd_setup(clip, tris, None, width, height, cull, cv, None,
                           None)
    # boxes: [entry-order boxes] on the card, [] on the CPU
    sorted_rows, starts, counts, big, *boxes = _bin_crowd(
        s, rows, width, height, _kernel_boxes(s, 0.0))
    depth = depth_tiles_multi(sorted_rows, starts, counts, clip.shape[0],
                              width, height, *boxes)[:, :height, :width]
    if _covers_all(_crowd_e_max(width, height), width, height):
        return depth
    return _merge_big_depth_crowd(depth, width, height, s, big)
