"""The least time of a frame's raster work, counted from the frame's own
inputs: its deformed vertices, the mesh, the render settings.

Two rasters make a frame: the shadow map (depth only, seen from the light,
front faces culled) and the character (back faces culled; at msaa=4 four
rotated-grid samples a pixel). For each, the triangles that can cover a
sample (the setup's valid mask, as the plain reference computes it) are
counted against a fixed tile grid of TILE_W x TILE_H pixels by their pixel
boxes (the pixel centres, or at msaa=4 the samples up to SAMPLE_EXTENT from
them, inside the triangle's bounding box):

- bytes: each (triangle, tile) entry's ROW_LANES setup lanes read once, a
  start and a count a tile, and every output plane written once: the
  shadow map's texels; the character's depth, triangle id, two barycentric
  planes, its attribute planes and, at msaa=4, four sample depths;
- fp32 operations: each entry evaluated over the pixels of its box
  (OPS_DEPTH, OPS_RASTER or OPS_RASTER_MS an evaluation), and the winner's
  epilogue a pixel (OPS_WINNER and OPS_PER_ATTR an attribute).

The per-entry and per-pixel rules are those the program's kernel record
states for its hand kernels K1/K5c (depth), K2/K5a (raster) and K4/K5b
(msaa=4), fixed here: the work is what these inputs need, not what the
program's own bins, boxes or launches do, so a later program that rebins or
fuses is judged against the same work. The bound is the larger of the
bytes over the peak bandwidth and the operations over the fp32 peak
(`peaks.bound_s`).
"""

from __future__ import annotations

import torch

from ..reference.render import pipeline, raster
from .peaks import bound_s

TILE_W, TILE_H = 128, 32
ROW_LANES = 11
SAMPLE_EXTENT = 0.375
OPS_DEPTH, OPS_RASTER, OPS_RASTER_MS = 13, 15, 51
OPS_WINNER, OPS_PER_ATTR = 12, 5


def _box_work(s, width, height, extent):
    """(entries, box pixels) of the valid triangles of setup `s`."""
    xy = s["xy"][s["valid"]]
    lo = torch.ceil(xy.amin(-2) - 0.5 - extent).clamp(min=0)
    hi = torch.floor(xy.amax(-2) - 0.5 + extent)
    hi = torch.minimum(hi, torch.tensor([width - 1.0, height - 1.0],
                                        device=hi.device))
    size = (hi - lo + 1).clamp(min=0)
    live = (size > 0).all(-1)
    lo, hi, size = lo[live], hi[live], size[live]
    tiles_x = (torch.floor(hi[:, 0] / TILE_W) - torch.floor(lo[:, 0] / TILE_W)
               + 1)
    tiles_y = (torch.floor(hi[:, 1] / TILE_H) - torch.floor(lo[:, 1] / TILE_H)
               + 1)
    entries = int((tiles_x * tiles_y).sum())
    pixels = int((size[:, 0] * size[:, 1]).sum())
    return entries, pixels


def _tiles(width, height):
    return -(-width // TILE_W) * -(-height // TILE_H)


def frame_bound_s(positions_mmd, triangles, rcfg, n_attrs: int) -> dict:
    """{'shadow': s, 'character': s}: the least time of one instance's
    shadow map and character raster. positions_mmd [V, 3] (MMD units),
    triangles [T, 3] as the model stores them, rcfg the RenderConfig of
    the frame, n_attrs the attribute planes the character raster carries
    (3 normals; 5 with UVs riding it)."""
    dev = positions_mmd.device
    mats = pipeline.build_matrices(rcfg, None, rcfg.width / rcfg.height,
                                   None, device=dev)
    verts_m = positions_mmd * rcfg.mmd_to_meter
    tris = torch.as_tensor(triangles, device=dev).flip(-1)
    out = {}
    if rcfg.shadows_enabled:
        size = rcfg.shadow_map_size
        s = raster.setup(raster.transform_clip(verts_m, mats["light_mvp"]),
                         tris, size, size, raster.CULL_FRONT)
        entries, evals = _box_work(s, size, size, 0.0)
        n_bytes = 4 * (entries * ROW_LANES + 2 * _tiles(size, size) + 1
                       + size * size)
        out["shadow"] = bound_s(n_bytes, evals * OPS_DEPTH)
    w, h = rcfg.width, rcfg.height
    msaa = rcfg.msaa >= 4
    extent = SAMPLE_EXTENT if msaa else 0.0
    s = raster.setup(raster.transform_clip(verts_m, mats["mvp"]), tris, w, h,
                     raster.CULL_BACK, sample_extent=extent)
    entries, evals = _box_work(s, w, h, extent)
    planes = 4 + n_attrs + (4 if msaa else 0)    # depth, id, 2 bary, ...
    n_bytes = 4 * (entries * ROW_LANES + 2 * _tiles(w, h) + 1
                   + planes * w * h)
    n_ops = (evals * (OPS_RASTER_MS if msaa else OPS_RASTER)
             + w * h * (OPS_WINNER + OPS_PER_ATTR * n_attrs))
    out["character"] = bound_s(n_bytes, n_ops)
    return out
