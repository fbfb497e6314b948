"""Triangle setup and visibility buffers shared by the tiled raster.

Port of `simple_mmd_renderer_tpu/render/raster.py`: `VisBuffer`,
`transform_clip`, `screen_from_clip`, `setup`, `interpolate`, and the exact
scan raster `rasterize` (triangles in draw order, full-frame edge functions,
LESS_EQUAL) with `empty_vis` and `_pixel_centers`. `rasterize` is the
raster of `raster_mode="scan"`; its body is `ops.tiled_raster.scan_raster`
(kernel KS on the card, its plain version on the CPU), which the tiled
path's big-triangle merges share.

Depth convention: zero-to-one (RH_ZO), z-less wins, cleared to 1.0; screen
y points down; pixel centres sit at integer + 0.5.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CULL_NONE, CULL_BACK, CULL_FRONT = 0, 1, 2
_W_EPS = 1e-6


@dataclass
class VisBuffer:
    depth: torch.Tensor   # [H,W] f32, 1.0 = far/empty
    tri: torch.Tensor     # [H,W] i32, -1 = empty
    bary: torch.Tensor    # [H,W,2] f32 screen-space (u,v) for verts 1,2


def transform_clip(positions, mvp):
    """[...,3] model/world-space points -> [...,4] clip coords (MVP @ p)."""
    p = torch.cat([positions, torch.ones_like(positions[..., :1])], -1)
    return p @ mvp.T


def screen_from_clip(clip, width, height):
    """NDC -> pixel coordinates, y flipped (row 0 = top), plus z and 1/w."""
    w = clip[..., 3]
    inv_w = torch.where(torch.abs(w) > _W_EPS, 1.0 / w, torch.zeros_like(w))
    ndc = clip[..., :3] * inv_w[..., None]
    x = (ndc[..., 0] * 0.5 + 0.5) * width
    y = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    return torch.stack([x, y], -1), ndc[..., 2], inv_w


def setup(clip, tris, width, height, cull=CULL_BACK, cv=None,
          sample_extent=0.0, nocull=None):
    """Per-triangle rasterization setup -> dict of [T,...] tensors: screen xy
    per vertex, z, 1/w, twice the signed area, and the valid mask (in front
    of the camera, non-degenerate, not culled, straddling a sample point).
    `cv` may pass pre-gathered clip[tris]. `sample_extent` widens the
    sample-point cull for MSAA samples up to that many pixels from the
    centre (0 = centre sampling). `nocull` [T] bool marks triangles exempt
    from face culling (double-sided materials). A crowd's clip [I,V,4] (cv
    [I,T,3,4]) gives [I,T,...] tensors, `nocull` shared by the instances."""
    if cv is None:
        cv = clip[..., tris.long(), :]                  # [T,3,4]
    xy, z, iw = screen_from_clip(cv, width, height)
    w_ok = torch.all(cv[..., 3] > _W_EPS, dim=-1)

    d1 = xy[..., 1, :] - xy[..., 0, :]
    d2 = xy[..., 2, :] - xy[..., 0, :]
    area2 = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]  # y-down: CW>0

    if cull == CULL_BACK:
        face_ok = area2 < 0.0
    elif cull == CULL_FRONT:
        face_ok = area2 > 0.0
    else:
        face_ok = torch.abs(area2) > 0.0
    if nocull is not None:
        face_ok = face_ok | (nocull & (torch.abs(area2) > 0.0))

    # sample-point cull (exact): a triangle whose bbox straddles no sample
    # point in x or y can never produce coverage
    xmin = torch.amin(xy[..., 0], -1)
    xmax = torch.amax(xy[..., 0], -1)
    ymin = torch.amin(xy[..., 1], -1)
    ymax = torch.amax(xy[..., 1], -1)
    e = float(sample_extent)
    hits_sample = ((torch.ceil(xmin - 0.5 - e) <= torch.floor(xmax - 0.5 + e))
                   & (torch.ceil(ymin - 0.5 - e)
                      <= torch.floor(ymax - 0.5 + e)))

    valid = w_ok & face_ok & (torch.abs(area2) > 1e-12) & hits_sample
    return dict(xy=xy, z=z, inv_w=iw, area2=area2, valid=valid)


def _pixel_centers(width, height, device="cuda"):
    """Pixel-centre coordinates: xs [1, W] and ys [H, 1] (integer + 0.5)."""
    ys = (torch.arange(height, dtype=torch.float32, device=device)
          + 0.5)[:, None]
    xs = (torch.arange(width, dtype=torch.float32, device=device)
          + 0.5)[None, :]
    return xs, ys


def rasterize(clip, tris, width, height, cull=CULL_BACK,
              vis: VisBuffer | None = None, nocull=None) -> VisBuffer:
    """Exact rasterization: every triangle's edge functions over the whole
    frame, in draw order, a pixel passing where it is covered and
    0 <= zp <= depth, zp <= 1 (LESS_EQUAL: a later triangle wins a z-tie),
    from `vis` (None: `empty_vis`). clip [V, 4], tris [T, 3]; a crowd's
    clip [I, V, 4] gives a VisBuffer [I, H, W]. `cull` and `nocull` as
    `setup` takes them. Runs kernel KS on a CUDA tensor."""
    from ..ops.tiled_raster import scan_raster
    s = setup(clip, tris, width, height, cull, nocull=nocull)
    return scan_raster(width, height, s, vis)


def empty_vis(width, height, device="cuda", lead=()) -> VisBuffer:
    """A cleared visibility buffer [*lead, H, W]: depth 1, triangle -1,
    barycentrics 0."""
    shape = tuple(lead) + (height, width)
    return VisBuffer(
        depth=torch.ones(shape, dtype=torch.float32, device=device),
        tri=torch.full(shape, -1, dtype=torch.int32, device=device),
        bary=torch.zeros(shape + (2,), dtype=torch.float32, device=device))


def interpolate(vis: VisBuffer, clip, tris, attrs):
    """Perspective-correct interpolation of per-vertex attributes over the
    visibility buffer. attrs: [V,A] -> [H,W,A]; empty pixels get zeros.
    With a leading instance axis (vis [I,H,W], clip [I,V,4], tris [I,T,3]
    or [T,3], attrs [I,V,A]) -> [I,H,W,A]."""
    tid = torch.clamp(vis.tri, min=0).long()
    if clip.dim() == 3:
        n_inst, n_verts = clip.shape[:2]
        tris_b = tris.long().expand(n_inst, -1, -1)
        v = torch.gather(tris_b, 1, tid.reshape(n_inst, -1, 1).expand(
            -1, -1, 3)).reshape(tid.shape + (3,))
        # instance-major vertex rows
        v = v + (torch.arange(n_inst, device=v.device)
                 * n_verts)[:, None, None, None]
        clip = clip.reshape(-1, 4)
        attrs = attrs.reshape(-1, attrs.shape[-1])
    else:
        v = tris.long()[tid]                            # [H,W,3]
    cw = clip[v][..., 3]
    iw = torch.where(torch.abs(cw) > _W_EPS, 1.0 / cw, torch.zeros_like(cw))
    b1 = vis.bary[..., 0]
    b2 = vis.bary[..., 1]
    b0 = 1.0 - b1 - b2
    wgt = torch.stack([b0, b1, b2], -1) * iw            # [H,W,3]
    denom = torch.sum(wgt, -1, keepdim=True)
    wgt = wgt / torch.where(torch.abs(denom) > _W_EPS, denom,
                            torch.ones_like(denom))
    a = attrs[v]                                        # [H,W,3,A]
    out = torch.einsum("...k,...ka->...a", wgt, a)
    return torch.where((vis.tri >= 0)[..., None], out, torch.zeros_like(out))
