"""Frame pipeline: shadow pass -> ground -> character -> shading.

Port of `simple_mmd_renderer_tpu/render/pipeline.py`: `build_matrices`
(with the orthographic camera, `model_mat` and `proj_transform`), `ground_pass` (with its row0/rows halo),
`unproject_depth`, `upsample_bilinear_int`, `_tiled_e_max`, `shadow_pass`
(with the caster window), the textures (the shelf-packed atlas with its
mip chain, `PackedAtlas`, deferred-UV albedo from the visibility buffer,
the resident mini-atlas) and `render_frame`, at msaa=1 or msaa=4 (native
per-sample MSAA with a coverage resolve, or 2x2 supersampling with
`msaa_supersample`), with the skybox (`render/ibl.py`), the edge outlines
(the inverted hull through K2 at 0 attributes), double-sided materials
(the `nocull` exemption and two-sided lighting) and the MMD toon ramps and
sphere maps (`MmdMaps`, packed once), and the extended morphs'
consumers: UV offsets added to the UVs before the raster or the deferred
albedo reads them, and the material morphs' per-part colour
(`part_color` = (mul, add)) applied to the albedo by the pixel's part.
`RenderConfig.raster_mode` picks the rasterizer, as the reference's
`_pick_raster` does: "scan" takes the exact scan raster
(`render/raster.rasterize`, kernels KSb and KS), "tiled" and "auto" the
binned tile raster (`ops/tiled_raster.py`; the reference's "auto" takes
the scan raster off the TPU, the port the tiled one on every device),
whose kernels (K1/K6 shadow depth, K2/K4 character) run as hand-written
CUDA on the card, as does the ground's PCF kernel (K3). The albedo pass
is gathers (plain PyTorch), as it is XLA gathers in the reference.

`crowd_render_frame` is the multi-instance frame: one binning and one
kernel launch for all instances' shadow maps (K5c) and character rasters
(K5a, or K5b at msaa=4), K3 over the batch of shadow maps, the
camera-shared skybox and ground computed once, the albedo of every
instance from one shared atlas, the edge hull through K5a, and the MMD
shading over the instance axis, with per-instance UV offsets and part
colours.

The single frame takes every option of the reference's. Like the
reference's, `crowd_render_frame` raises NotImplementedError for
`msaa_supersample` and `raster_mode="scan"`; `parallel.mesh.crowd_step_fn`
renders those instance by instance.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import host_read, pass_scope
from . import camera as cam
from . import ibl
from . import raster
from . import shade


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def build_matrices(cfg, model_mat=None, aspect=None, proj_transform=None,
                   device=None):
    """Camera and light matrices (float32 on `device`): view, proj, mvp
    (with `model_mat`), light_mvp (with it) and light_vp (without it, for
    the ground).

    `cfg.camera_orthographic` a host bool picks the perspective or the
    orthographic camera; a bool tensor (a camera track's "perspective off"
    key) selects with `torch.where`. The orthographic frame's height
    matches the perspective frustum at the look-at distance, so that
    toggling the flag keeps the subject at the same screen size.
    `proj_transform` (4x4, e.g. one band of the frame, with `aspect` the
    full frame's ratio) pre-multiplies proj, so that every consumer (the
    raster, the ground's rays, the skybox, the depth unprojection) sees one
    camera."""
    if aspect is None:
        aspect = cfg.width / cfg.height
    fov = cam.deg2rad(cfg.camera_fov_deg, device)
    proj = cam.perspective(fov, aspect, cfg.near, cfg.far, device=device)
    ortho = cfg.camera_orthographic
    tensor_flag = isinstance(ortho, torch.Tensor)
    if tensor_flag or ortho:
        eye = _f32(cfg.camera_pos, device)
        tgt = _f32(cfg.camera_target, device)
        half_h = torch.linalg.vector_norm(eye - tgt) * torch.tan(fov * 0.5)
        half_w = half_h * aspect
        oproj = cam.orthographic(-half_w, half_w, -half_h, half_h, cfg.near,
                                 cfg.far, device=device)
        proj = torch.where(ortho, oproj, proj) if tensor_flag else oproj
    if proj_transform is not None:
        proj = _f32(proj_transform, device) @ proj
    up = torch.zeros(3, dtype=torch.float32, device=device)
    up[1].fill_(1.0)
    view = cam.look_at(cfg.camera_pos, cfg.camera_target, up, device=device)
    mvp = proj @ view

    hs = cfg.shadow_frustum_half
    light_proj = cam.orthographic(-hs, hs, -hs, hs, cfg.shadow_near,
                                  cfg.shadow_far, device=device)
    light_view = cam.directional_light_view(cfg.light_direction, device)
    light_vp = light_proj @ light_view
    light_mvp = light_vp
    if model_mat is not None:
        model_mat = _f32(model_mat, device)
        mvp = mvp @ model_mat
        light_mvp = light_vp @ model_mat
    return dict(model=model_mat, view=view, proj=proj, mvp=mvp,
                light_mvp=light_mvp, light_vp=light_vp)


def ground_geometry(size, device="cuda"):
    """The 2*size-metre white stage quad: vertices [4, 3] f32 on the y = 0
    plane and its two triangles [2, 3] i32."""
    s = float(size)
    verts = torch.tensor([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                         dtype=torch.float32, device=device)
    tris = torch.tensor([[0, 1, 2], [2, 3, 0]], dtype=torch.int32,
                        device=device)
    return verts, tris


def unproject_depth(depth, vp, width, height):
    """[H,W] NDC depth -> [H,W,3] world positions through inv(vp), evaluated
    per row of inv(vp) on [H,W] planes; [I,H,W] depths of a shared camera
    -> [I,H,W,3]."""
    dev = depth.device
    inv = torch.linalg.inv_ex(vp).inverse   # no host sync on the card
    xs = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width * 2.0 - 1.0)[None, :]
    ys = (1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
          / height * 2.0)[:, None]

    def row(i):
        return (inv[i, 0] * xs + inv[i, 1] * ys + inv[i, 2] * depth
                + inv[i, 3])

    pw = row(3)
    pw = torch.where(torch.abs(pw) > 1e-12, pw, torch.full_like(pw, 1e-12))
    return torch.stack([row(0) / pw, row(1) / pw, row(2) / pw], -1)


def ground_pass(cfg, view, proj, width, height, row0=0, rows=None):
    """Analytic ray/plane ground raster of the 50 m y=0 quad -> (mask,
    world_pos, ndc_depth), for the row range [row0, row0 + rows) of the
    height-pixel grid (row0 may be negative: the downsampled shadow lookup
    renders one geometric halo row beyond each edge)."""
    rows = height if rows is None else rows
    dev = view.device
    eye = _f32(cfg.camera_pos, dev)
    vp = proj @ view
    inv = torch.linalg.inv_ex(vp).inverse   # no host sync on the card
    xs = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width * 2.0 - 1.0)[None, :]
    ys = (1.0 - (torch.arange(rows, dtype=torch.float32, device=dev) + row0
                 + 0.5) / height * 2.0)[:, None]

    def row(i):  # inv @ (x, y, 0.5, 1)
        return (inv[i, 0] * xs + inv[i, 1] * ys
                + (inv[i, 2] * 0.5 + inv[i, 3]))

    pw = row(3)
    pw = torch.where(torch.abs(pw) > 1e-12, pw, torch.ones_like(pw))
    wx, wy, wz = row(0) / pw, row(1) / pw, row(2) / pw
    dx_, dy, dz_ = wx - eye[0], wy - eye[1], wz - eye[2]
    t = -eye[1] / torch.where(torch.abs(dy) > 1e-9, dy,
                              torch.full_like(dy, 1e-9))
    hx = eye[0] + t * dx_
    hy = eye[1] + t * dy
    hz = eye[2] + t * dz_
    s = cfg.ground_size
    mask = ((t > 0) & (torch.abs(dy) > 1e-9)
            & (torch.abs(hx) <= s) & (torch.abs(hz) <= s))
    cz = vp[2, 0] * hx + vp[2, 1] * hy + vp[2, 2] * hz + vp[2, 3]
    cw = vp[3, 0] * hx + vp[3, 1] * hy + vp[3, 2] * hz + vp[3, 3]
    depth = cz / torch.where(torch.abs(cw) > 1e-9, cw, torch.ones_like(cw))
    mask = mask & (depth >= 0.0) & (depth <= 1.0)
    hit = torch.stack([hx, hy, hz], -1)
    return mask, hit, torch.where(mask, depth, torch.ones_like(depth))


def upsample_bilinear_int(img, f, pre_padded_rows=False):
    """[h,w,1] -> [f*h, f*w, 1] bilinear upsample with half-pixel centres,
    as f static per-phase plane blends per axis (leading axes, as the
    crowd's [I,h,w,1], pass through). `pre_padded_rows`: the input's first
    and last row are halo rows used as the row padding (output rows =
    f*(h-2)); columns always edge-pad."""
    lo = img[..., 0]
    row_axis = lo.dim() - 2

    def axis_up(a, axis):
        if axis == row_axis and pre_padded_rows:
            n = a.shape[axis] - 2
            p = a
        else:
            n = a.shape[axis]
            idx = torch.clamp(torch.arange(-1, n + 1, device=a.device),
                              0, n - 1)
            p = torch.index_select(a, axis, idx)
        outs = []
        for ph in range(f):
            o = (ph + 0.5) / f - 0.5
            fl = math.floor(o)
            fr = o - fl
            s0 = p.narrow(axis, 1 + fl, n)
            s1 = p.narrow(axis, 2 + fl, n)
            outs.append(s0 * (1.0 - fr) + s1 * fr)
        st = torch.stack(outs, dim=axis + 1)
        shape = list(a.shape)
        shape[axis] = n * f
        return st.reshape(shape)

    return axis_up(axis_up(lo, row_axis), row_axis + 1)[..., None]


def _tiled_e_max(width, height, default=6):
    """Covers-all e_max at small targets: when the whole tile grid fits in
    <= 16 entries per triangle, binning every covered tile removes the
    big-triangle merge."""
    from ..ops.tiled_raster import TILE_H, TILE_W
    n_tiles = (-(-width // TILE_W)) * (-(-height // TILE_H))
    return n_tiles if n_tiles <= 16 else default


def shadow_pass(verts_m, tris_flipped, light_mvp, size, raster_fn=None,
                window=False, compact=True, corner_pos=None):
    """Depth-only character raster from the light (front-face cull), as
    the reference's: `raster_fn=None` (or `raster.rasterize`) takes the
    exact scan raster's depth (KS on the card); any other raster function
    takes the binned depth kernels, K1, or K6 with `window` at maps of at
    least 1024^2 (the casters' tile bounding box). `corner_pos` [T,3,3]
    may pass pre-gathered per-corner world positions shared with the main
    pass (the tiled kernels use it)."""
    raster_fn = raster_fn or raster.rasterize
    clip = raster.transform_clip(verts_m, light_mvp)
    if raster_fn is raster.rasterize:
        return raster.rasterize(clip, tris_flipped, size, size,
                                raster.CULL_FRONT).depth
    from ..ops.tiled_raster import (rasterize_depth_tiled,
                                    rasterize_depth_tiled_window)
    cv = (raster.transform_clip(corner_pos, light_mvp)
          if corner_pos is not None else None)
    if window and size >= 1024:
        return rasterize_depth_tiled_window(
            clip, tris_flipped, size, size, raster.CULL_FRONT,
            e_max=_tiled_e_max(size, size), tile_h=32, cv=cv,
            compact=compact)
    return rasterize_depth_tiled(clip, tris_flipped, size, size,
                                 raster.CULL_FRONT,
                                 e_max=_tiled_e_max(size, size),
                                 compact=compact, cv=cv)


# ---------------------------------------------------------------------------
# textures: the packed atlas, its mip chain, the resident mini-atlas and the
# albedo samplers. Host packing is NumPy (the reference's code); sampling is
# gathers on the device tensors of a PackedAtlas.
# ---------------------------------------------------------------------------

def _tri_part(static, pn):
    """[T] part id per triangle (`ModelTables.tri_part`) for an atlas of
    `pn` parts."""
    return torch.clamp(static.tri_part, max=pn - 1)


def character_albedo(static, tri, uv_px, part_textures, atlas=None):
    """Per-part diffuse texture lookup (main.cpp:2093-2146: one draw and
    bind per part) from the triangle-id image `tri` [..., H, W] and the
    per-pixel UVs [..., H, W, 2]. Any real texture (or a given `atlas`)
    routes through the packed atlas (`_albedo_atlas`); flat-colour-only
    parts keep the gather-free broadcast, part by part."""
    real = [p for p, t in enumerate(part_textures)
            if t.shape[0] > 1 or t.shape[1] > 1]
    if atlas is not None or len(real) >= 1:
        return _albedo_atlas(static, tri, uv_px, part_textures, atlas)

    albedo = torch.ones(tri.shape + (3,), dtype=torch.float32,
                        device=tri.device)
    host = static.host
    for p in range(len(host.part_base)):
        base = int(host.part_base[p])
        count = int(host.part_count[p])
        if count == 0:
            continue
        mask = (tri >= base) & (tri < base + count)
        # fills, not a copy from the host: no synchronisation
        color = torch.stack([torch.full(tri.shape, float(c),
                                        dtype=torch.float32,
                                        device=tri.device)
                             for c in part_textures[p][0, 0, :3]], -1)
        albedo = torch.where(mask[..., None], color, albedo)
    return albedo


def _pack_atlas(part_textures):
    """Shelf-pack per-part textures into ONE [H, W, 12] packed atlas (host
    side): each texel carries its own colour plus the +x, +y and +x+y
    neighbours (wrapped within the part, so repeat-wrap bilinear stays exact
    at part edges), so one gather fetches all four bilinear taps. Memory is
    the sum of the texture areas plus the shelves' slack.

    Returns (atlas [H,W,12] f32, offsets [P,2] (y,x), sizes [P,2] (h,w))."""
    pn = len(part_textures)
    sizes = np.array([(t.shape[0], t.shape[1]) for t in part_textures],
                     np.int64)
    atlas_w = max(int(sizes[:, 1].max()), 1)
    order = np.argsort(-sizes[:, 0], kind="stable")  # tall shelves first
    offsets = np.zeros((pn, 2), np.int64)
    shelf_y, shelf_h, x = 0, 0, 0
    for p in order:
        h, w = int(sizes[p, 0]), int(sizes[p, 1])
        if x + w > atlas_w:
            shelf_y += shelf_h
            x, shelf_h = 0, 0
        offsets[p] = (shelf_y, x)
        x += w
        shelf_h = max(shelf_h, h)
    atlas = np.zeros((shelf_y + shelf_h, atlas_w, 12), np.float32)
    for p, t in enumerate(part_textures):
        y0, x0 = offsets[p]
        t3 = np.asarray(t[..., :3], np.float32)
        xr = np.roll(t3, -1, 1)          # +x neighbour, wrapped in-part
        yr = np.roll(t3, -1, 0)          # +y
        xyr = np.roll(xr, -1, 0)         # +x+y
        atlas[y0:y0 + t.shape[0], x0:x0 + t.shape[1]] = np.concatenate(
            [t3, xr, yr, xyr], -1)
    return atlas, offsets.astype(np.float32), sizes.astype(np.float32)


@dataclass
class PackedAtlas:
    """Device form of the shelf-packed texture atlas (`build_packed_atlas`).

    `data` is [H,W,4] int32 of bit-packed RGB888 2x2 neighbourhoods (the
    reference's uint32 words: each is below 2^24, so int32 holds it exactly
    and `&` and `>>` read it) when every source texel sits on the 8-bit
    grid, else [H,W,12] float32. With a mip chain (`n_mips` > 1) every
    level of every part is packed into the same atlas; `mip_offsets`,
    `mip_sizes` and the host tuple `mip_meta` ((oy, ox, h, w) per part and
    level) address them."""
    data: torch.Tensor
    offsets: torch.Tensor                     # [P,2] i32 (y,x)
    sizes: torch.Tensor                       # [P,2] f32 (h,w)
    eight_bit: bool = True
    mip_offsets: torch.Tensor | None = None   # [P,L,2] i32 (y,x)
    mip_sizes: torch.Tensor | None = None     # [P,L,2] f32 (h,w)
    n_mips: int = 0
    mip_meta: tuple = ()


def _downsample2(t):
    """One mip step: 2x2 box filter (odd trailing row/col dropped), never
    below 1 texel per axis."""
    h, w = t.shape[:2]
    if h > 1:
        t = 0.5 * (t[0:2 * (h // 2):2] + t[1:2 * (h // 2):2])
    if w > 1:
        t = 0.5 * (t[:, 0:2 * (w // 2):2] + t[:, 1:2 * (w // 2):2])
    return t


def build_packed_atlas(part_textures, mip_levels: int = 0, device="cuda") \
        -> PackedAtlas | None:
    """Host-side packing -> PackedAtlas on `device` (the card unless the
    caller asks for another device); None when every part is a flat 1x1
    colour, which keeps the gather-free broadcast path.

    mip_levels > 1 packs a box-filtered mip chain of every part into the
    same shelf atlas (+~33% texels) for per-triangle level selection in
    affine_uv_part_rows; 8-bit sources keep their levels quantized to the
    8-bit grid so the bit-packing stays exact."""
    if part_textures is None or not any(
            t.shape[0] > 1 or t.shape[1] > 1 for t in part_textures):
        return None
    device = resolve_device(device)
    pn = len(part_textures)
    entries = [np.asarray(t, np.float32) for t in part_textures]
    src8 = all(
        np.abs(e * 255.0 - np.round(e * 255.0)).max() < 1e-3
        for e in entries)
    mip_index = None
    if mip_levels and int(mip_levels) > 1:
        L = int(mip_levels)
        mip_index = np.zeros((pn, L), np.int64)
        for p in range(pn):
            mip_index[p, 0] = p
            cur = entries[p]
            for lv in range(1, L):
                if cur.shape[0] > 1 or cur.shape[1] > 1:
                    cur = _downsample2(cur)
                    if src8:
                        cur = np.round(cur * 255.0) / 255.0
                    entries.append(cur)
                    mip_index[p, lv] = len(entries) - 1
                else:
                    mip_index[p, lv] = mip_index[p, lv - 1]
    atlas, offsets, sizes = _pack_atlas(entries)
    scaled = atlas * 255.0
    eight_bit = bool(np.abs(scaled - np.round(scaled)).max() < 1e-3)
    if eight_bit:
        q8 = np.clip(scaled + 0.5, 0, 255).astype(np.int32)
        data = (q8[..., 0::3] | (q8[..., 1::3] << 8)
                | (q8[..., 2::3] << 16))             # [H,W,4] i32 < 2^24
    else:
        data = atlas                                  # [H,W,12] f32
    del atlas, scaled

    def dev(x):
        return torch.as_tensor(x, device=device)

    mo = ms = None
    meta = ()
    if mip_index is not None:
        mo = dev(offsets[mip_index].astype(np.int32))      # [P,L,2]
        ms = dev(sizes[mip_index])                         # [P,L,2]
        oi = offsets[mip_index].astype(np.int64)
        si = sizes[mip_index].astype(np.int64)
        meta = tuple(tuple((int(oi[p, l, 0]), int(oi[p, l, 1]),
                            int(si[p, l, 0]), int(si[p, l, 1]))
                           for l in range(oi.shape[1]))
                     for p in range(pn))
    return PackedAtlas(data=dev(data),
                       offsets=dev(offsets[:pn].astype(np.int32)),
                       sizes=dev(sizes[:pn]), eight_bit=eight_bit,
                       mip_offsets=mo, mip_sizes=ms,
                       n_mips=int(mip_levels) if mip_index is not None
                       else 0, mip_meta=meta)


def _albedo_atlas(static, tri, uv_px, part_textures, atlas=None):
    """Single-pass atlas sampling: the part of each pixel from its
    triangle id (a search of the parts' first triangles), then full
    bilinear filtering from one gather a pixel (`_atlas_bilinear`). Built
    from `part_textures` (no mips) when no `atlas` is given."""
    pn = len(part_textures)
    if atlas is None:
        atlas = build_packed_atlas(part_textures, device=tri.device)

    cov = tri >= 0
    tri = torch.clamp(tri, min=0).contiguous()
    pid = torch.clamp(torch.searchsorted(static.part_base, tri,
                                         right=True) - 1, 0, pn - 1)
    size = _take_rows(atlas.sizes.flip(-1), pid)      # [.., 2] (w, h)
    uv = uv_px * size - 0.5                           # u and v at once
    x0 = torch.floor(uv)
    f = uv - x0
    # repeat wrap within the part's own extent (a floor-mod: negative texel
    # indices wrap from the far edge), then shift into the atlas
    xy = (torch.remainder(x0.to(torch.int32),
                          torch.clamp(size.to(torch.int32), min=1))
          + _take_rows(atlas.offsets.flip(-1), pid))
    # uncovered pixels are masked downstream: their address is texel 0
    xy = torch.where(cov[..., None], xy, 0)
    return _atlas_bilinear(atlas, xy[..., 0], xy[..., 1], f[..., 0:1],
                           f[..., 1:2])


def _atlas_bilinear(atlas, xm, ym, fx, fy):
    """Bilinear filter from the neighbourhood-packed atlas: one gather a
    pixel (the texel's 2x2 neighbourhood rides its row), then 3 lerps."""
    atlas_w = atlas.data.shape[1]
    idx = ym.to(torch.int64) * atlas_w + xm
    if atlas.eight_bit:
        # a word's bytes are R, G, B, 0 (little-endian, on the host and
        # the card alike): one conversion unpacks all four corners
        q = _take_rows(atlas.data.reshape(-1, 4), idx)  # c00 c10 c01 c11
        c = q.view(torch.uint8).reshape(q.shape + (4,))[..., :3] \
            .to(torch.float32) * (1.0 / 255.0)   # [.., 4, 3]
    else:
        c = _take_rows(atlas.data.reshape(-1, 12), idx).reshape(
            idx.shape + (4, 3))
    gx = 1 - fx
    top = c[..., 0, :] * gx + c[..., 1, :] * fx
    bot = c[..., 2, :] * gx + c[..., 3, :] * fx
    return top * (1 - fy) + bot * fy


def resident_slot_size(n_parts, budget_bytes=20 << 20):
    """Slot edge (a multiple of 128, 128-512) of the resident mini-atlas:
    P slots of 16 B texels within `budget_bytes` (the reference's sizing)."""
    s = int(math.sqrt(budget_bytes / (16.0 * max(n_parts, 1)))) // 128 * 128
    return max(min(s, 512), 128)


def resident_fit_levels(atlas, slot):
    """[P] i32: each part's first mip level that fits a slot x slot window,
    or None when some part's chain never fits (texture_mips too shallow
    for this slot). Host data, from the atlas layout."""
    metas = np.asarray(atlas.mip_meta, np.int64)      # [P,L,4] oy,ox,h,w
    L = atlas.n_mips
    fit = []
    for p in range(metas.shape[0]):
        f = next((lv for lv in range(L)
                  if metas[p, lv, 2] <= slot and metas[p, lv, 3] <= slot),
                 None)
        if f is None:
            return None
        fit.append(f)
    return np.asarray(fit, np.int32)


def _fit_levels(atlas, slot):
    """`resident_fit_levels` at `slot` on the atlas's device, from its level
    sizes: a part's levels shrink, so its first level that fits is the
    count of those that do not."""
    return (atlas.mip_sizes > slot).any(-1).sum(-1)


def build_resident_atlas(atlas, need_level, slot):
    """Per-frame resident mip atlas: for each part, ONE level (the most
    detailed level any of its triangles needs this frame, `need_level` [P]
    i32 on the device, clamped to the first level that fits a slot x slot
    window) copied out of the big mip atlas into a [P*slot, slot, lanes]
    mini table. The copy is one gather: each slot's rows and columns are
    its clamped start plus an arange, so the window stays in bounds
    without padding the big atlas and nothing is read on the host; the
    residual (start - clamped start) rides into the per-part offsets.

    Returns (mini PackedAtlas, off_xy [P,2] f32 (x,y) part origins inside
    the mini table, sz_hw [P,2] f32 resident level sizes)."""
    P = len(atlas.mip_meta)
    L = atlas.n_mips
    data = atlas.data
    hd, wd, lanes = data.shape
    slot = min(int(slot), hd, wd)   # small atlases: window within bounds
    metas = np.asarray(atlas.mip_meta, np.int64)      # [P,L,4] oy,ox,h,w
    fit = resident_fit_levels(atlas, slot)
    if fit is None:
        raise ValueError(
            f"texture_resident: some parts have no mip level that fits "
            f"the {slot}px resident slot — raise RenderConfig.texture_mips "
            f"so every part's chain reaches <= {slot}px (largest texture "
            f"{int(metas[:, 0, 2:].max())}px needs "
            f">= {int(np.ceil(np.log2(metas[:, 0, 2:].max() / slot))) + 1} "
            f"levels)")
    dev = data.device
    parts = torch.arange(P, device=dev)
    rl = torch.clamp(torch.maximum(need_level.to(torch.int64),
                                   _fit_levels(atlas, slot)), 0, L - 1)
    oy = atlas.mip_offsets[parts, rl, 0].to(torch.int64)
    ox = atlas.mip_offsets[parts, rl, 1].to(torch.int64)
    hh = atlas.mip_sizes[parts, rl, 0]
    ww = atlas.mip_sizes[parts, rl, 1]
    cy = torch.clamp(oy, 0, hd - slot)
    cx = torch.clamp(ox, 0, wd - slot)
    r = torch.arange(slot, device=dev)
    ys = (cy[:, None] + r)[:, :, None]                # [P,slot,1]
    xs = (cx[:, None] + r)[:, None, :]                # [P,1,slot]
    mini = data[ys, xs].reshape(P * slot, slot, lanes)
    off = torch.stack([ox - cx, parts * slot + (oy - cy)], -1)   # (x, y)
    mini_atlas = PackedAtlas(data=mini, offsets=atlas.offsets,
                             sizes=atlas.sizes, eight_bit=atlas.eight_bit)
    return (mini_atlas, off.to(torch.float32),
            torch.stack([hh, ww], -1).to(torch.float32))


def _take_rows(table, idx):
    """table [N, C] at int64 idx [...] -> [..., C]: a row gather along
    dim 0 (`index_select`, not the general advanced-indexing kernel)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def _rows_at(rows, tri):
    """Per-pixel rows of a per-triangle table: rows [T, C] at tri [..., H,
    W], or per instance rows [I, T, C] at tri [I, H, W] (instance i's
    pixels read its own table). Uncovered pixels (tri < 0) read row 0."""
    tri = torch.clamp(tri, min=0).to(torch.int64)
    if rows.dim() == 3:
        n_inst, t = rows.shape[:2]
        inst = torch.arange(n_inst, device=tri.device) * t
        tri = tri + inst.reshape((n_inst,) + (1,) * (tri.dim() - 1))
        rows = rows.reshape(n_inst * t, rows.shape[2])
    return _take_rows(rows, tri)


def affine_uv_rows(uvs, tris):
    """Per-triangle affine UV plane rows [T, 8]: (u0, v0, du1, dv1, du2,
    dv2, 0, 0) — uv(pixel) = (u0, v0) + b1*(du1, dv1) + b2*(du2, dv2) from
    the visibility buffer's screen barycentrics. See uv_from_vis."""
    g = uvs[tris.to(torch.int64)]                     # [T,3,2]
    pad = torch.zeros(tris.shape[:1] + (2,), dtype=torch.float32,
                      device=uvs.device)
    return torch.cat([g[:, 0], g[:, 1] - g[:, 0], g[:, 2] - g[:, 0], pad], -1)


def _tri_mip_levels(g, sz0, screen_xy, tris, L):
    """Per-triangle mip level [..., T] from the UV-area / screen-area ratio
    (isotropic sqrt(texels per pixel)): g [..., T,3,2] UVs, sz0 [T,2]
    level-0 (w,h) texels, screen_xy [..., V,2] pixel positions (a leading
    instance axis passes through)."""
    d1t = (g[..., 1, :] - g[..., 0, :]) * sz0
    d2t = (g[..., 2, :] - g[..., 0, :]) * sz0
    s = screen_xy[..., tris.to(torch.int64), :]       # [..., T,3,2] px
    e1 = s[..., 1, :] - s[..., 0, :]
    e2 = s[..., 2, :] - s[..., 0, :]
    area_px = torch.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    area_tx = torch.abs(d1t[..., 0] * d2t[..., 1] - d1t[..., 1] * d2t[..., 0])
    rho2 = area_tx / torch.clamp(area_px, min=1e-12)
    lvl = torch.clamp(torch.floor(0.5 * torch.log2(torch.clamp(rho2,
                                                               min=1e-20))),
                      0, L - 1).to(torch.int32)
    # degenerate screen triangles (<= a pixel) take the smallest level
    return torch.where(area_px < 1e-9, L - 1, lvl)


def affine_uv_part_rows(uvs, tris, atlas, static, screen_xy=None,
                        resident=None):
    """[..., T, 12] texel-space affine UV rows with each triangle's atlas
    placement baked in: (u0, v0, du1, dv1, du2, dv2, ox, oy, tw, th, 0, 0),
    all in atlas texels. The triangle -> part mapping is static, so the
    per-part offset and size tables are gathered once a frame per triangle
    here, not per pixel in the sampler.

    With `screen_xy` ([..., V,2] pixel positions) and a mip-chain atlas
    (n_mips > 1), each triangle's mip level is selected here too, from the
    ratio of its UV-space to its screen-space area, and the row addresses
    that level's region of the atlas. With `resident` = (off_xy [P,2] f32
    (x,y), sz_hw [P,2] f32) from build_resident_atlas, rows instead address
    each part's slot in the resident mini-atlas. `uvs` [..., V, 2] and
    `screen_xy` may carry a leading instance axis (the crowd)."""
    g = uvs[..., tris.to(torch.int64), :]             # [..., T,3,2]
    pid = _tri_part(static, atlas.sizes.shape[0])
    d1u = g[..., 1, :] - g[..., 0, :]
    d2u = g[..., 2, :] - g[..., 0, :]
    if resident is not None:
        roff, rsz = resident
        off_xy = roff[pid].to(torch.float32)          # [T,2] (x,y)
        sz_wh = rsz[pid].flip(-1).to(torch.float32)   # (w,h)
    elif atlas.n_mips > 1 and screen_xy is not None:
        L = atlas.n_mips
        sz0 = atlas.sizes[pid].flip(-1)               # [T,2] (w,h) level 0
        lvl = _tri_mip_levels(g, sz0, screen_xy, tris, L)
        idx = pid * L + lvl                           # [..., T]
        off_xy = atlas.mip_offsets.reshape(-1, 2)[idx].flip(-1) \
            .to(torch.float32)
        sz_wh = atlas.mip_sizes.reshape(-1, 2)[idx].flip(-1)
    else:
        sz_wh = atlas.sizes[pid].flip(-1)             # [T,2] f32 (w,h)
        off_xy = atlas.offsets[pid].flip(-1).to(torch.float32)
    u0 = g[..., 0, :] * sz_wh
    d1 = d1u * sz_wh
    d2 = d2u * sz_wh
    lead = u0.shape[:-1]
    off_xy = off_xy.expand(lead + (2,))
    sz_wh = sz_wh.expand(lead + (2,))
    pad = torch.zeros(lead + (2,), dtype=torch.float32, device=uvs.device)
    return torch.cat([u0, d1, d2, off_xy, sz_wh, pad], -1)


def _albedo_rows(atlas, tri, bary, rows):
    """Deferred-UV atlas sampling from fused rows (affine_uv_part_rows):
    one 48-byte row gather and one atlas gather a pixel, no per-pixel part
    tables. Pixels with no coverage (tri < 0) are masked downstream, so
    their atlas address is pinned to texel 0. Per-instance rows [I, T, 12]
    sample instance i's pixels of tri [I, H, W] with its own rows."""
    cov = tri >= 0
    r = _rows_at(rows, tri)                           # [.., 12] gather
    # u and v at once: (u0, v0) + b1 * (du1, dv1) + b2 * (du2, dv2) - 0.5
    uv = (r[..., 0:2] + bary[..., 0:1] * r[..., 2:4]
          + bary[..., 1:2] * r[..., 4:6] - 0.5)
    x0 = torch.floor(uv)
    f = uv - x0
    size = torch.clamp(r[..., 8:10].to(torch.int32), min=1)
    xy = torch.remainder(x0.to(torch.int32), size) \
        + r[..., 6:8].to(torch.int32)
    xy = torch.where(cov[..., None], xy, 0)
    return _atlas_bilinear(atlas, xy[..., 0], xy[..., 1], f[..., 0:1],
                           f[..., 1:2])


def uv_from_vis(tri, bary, uv_rows):
    """Per-pixel UVs from the visibility buffer: one row gather a pixel
    (affine_uv_rows) instead of two attribute channels through the raster
    kernel. Interpolation is affine in screen space."""
    r = _rows_at(uv_rows, tri)                        # [.., 8] gather
    b1 = bary[..., 0]
    b2 = bary[..., 1]
    return torch.stack([r[..., 0] + b1 * r[..., 2] + b2 * r[..., 4],
                        r[..., 1] + b1 * r[..., 3] + b2 * r[..., 5]], -1)


def character_albedo_windowed(static, tri, uv_px, part_textures,
                              atlas=None, bary=None, uv_rows=None):
    """The reference's `character_albedo` restricted to the character's
    screen box, with the same output wherever it is read (covered pixels,
    `char_mask`).

    The reference picks the box's size from a static ladder under
    `lax.switch` because gathers cost a TPU ~5 ns each. Here a box size
    would need a host read, so every pixel is sampled, the uncovered ones
    at texel 0 (as the reference's own full-frame path does).

    With `bary` + `uv_rows`, per-pixel UVs are reconstructed from the
    visibility buffer and `uv_px` may be None. 12-column rows
    (affine_uv_part_rows) carry the atlas placement too and sample via
    `_albedo_rows`; 8-column rows (affine_uv_rows) give plain UVs
    (uv_from_vis)."""
    if uv_rows is not None and atlas is not None and uv_rows.shape[-1] == 12:
        return _albedo_rows(atlas, tri, bary, uv_rows)
    if uv_rows is not None:
        uv_px = uv_from_vis(tri, bary, uv_rows)
    return character_albedo(static, tri, uv_px, part_textures, atlas)


def _frame_albedo(static, cfg, part_textures, atlas, vis, uv_px, uvs, tris,
                  clip, width, height):
    """The single frame's albedo pass (reference `render_frame`
    l.1277-1350): deferred UVs from the visibility buffer with
    `albedo_window` on the tiled raster (per-triangle mip levels and the
    resident mini-atlas where the config asks for them), else the UVs the
    raster carried (`uv_px`: given without albedo_window, and on the scan
    raster, whose UVs always ride as attributes 3-4)."""
    if uv_px is not None:
        return character_albedo(static, vis.tri, uv_px, part_textures, atlas)
    atl = atlas if atlas is not None else build_packed_atlas(
        part_textures, mip_levels=cfg.texture_mips, device=tris.device)
    screen = None
    if atl is not None and atl.n_mips > 1 and cfg.texture_mips > 1:
        screen, _, _ = raster.screen_from_clip(clip, width, height)
    fit = None
    if screen is not None and cfg.texture_resident and atl.mip_meta:
        pn = atl.sizes.shape[0]
        slot = (resident_slot_size(pn) if int(cfg.texture_resident) == 1
                else int(cfg.texture_resident))
        slot = min(int(slot), atl.data.shape[0], atl.data.shape[1])
        # a chain that never fits the slot skips the resident path
        fit = resident_fit_levels(atl, slot)
    if fit is None:
        rows = (affine_uv_part_rows(uvs, tris, atl, static, screen_xy=screen)
                if atl is not None else affine_uv_rows(uvs, tris))
        return character_albedo_windowed(static, vis.tri, None, part_textures,
                                         atl, bary=vis.bary, uv_rows=rows)

    # the resident mini-atlas, with an exact fallback: where some part needs
    # a finer level than its slot holds (magnification), the frame samples
    # the big atlas instead
    pid = _tri_part(static, pn)
    sz0 = atl.sizes[pid].flip(-1)
    lvl = _tri_mip_levels(uvs[tris.to(torch.int64)], sz0, screen, tris,
                          atl.n_mips)
    nl = torch.full((pn,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=lvl.device).scatter_reduce(0, pid, lvl, "amin")
    # one host read a frame (listed with the render's host syncs in ROADMAP)
    with host_read("resident"):
        magnified = bool(torch.any(nl < _fit_levels(atl, slot)))
    if magnified:
        rows = affine_uv_part_rows(uvs, tris, atl, static, screen_xy=screen)
        return character_albedo_windowed(static, vis.tri, None, part_textures,
                                         atl, bary=vis.bary, uv_rows=rows)
    mini, roff, rsz = build_resident_atlas(atl, nl, slot)
    rows = affine_uv_part_rows(uvs, tris, atl, static, screen_xy=screen,
                               resident=(roff, rsz))
    return character_albedo_windowed(static, vis.tri, None, part_textures,
                                     mini, bary=vis.bary, uv_rows=rows)


# ---------------------------------------------------------------------------
# MMD toon ramps and sphere maps (the `mmd_maps` option)
# ---------------------------------------------------------------------------

@dataclass
class MmdMaps:
    """Device form of the reference's `mmd_maps` tuple (sphere_textures,
    sphere_modes, toon_ramps), built once by `build_mmd_maps`: the sphere
    maps packed into one atlas (None when every map is a flat 1x1 colour,
    which `character_albedo` broadcasts from the host values), the modes
    and the ramps on the device, and the host facts the per-frame gates
    read."""
    sphere_textures: list          # [P] host [h,w,3] maps
    sphere_atlas: PackedAtlas | None
    sphere_modes: torch.Tensor     # [P] i32 (0 off, 1 SPH multiply, 2 SPA add)
    any_sphere: bool               # some part's mode is not 0 (host)
    toon_ramps: torch.Tensor       # [P*K, 3] f32, part-major
    k: int                         # ramp length K


def build_mmd_maps(mmd_maps, device="cuda") -> MmdMaps:
    """The reference's `mmd_maps` tuple (formats.textures.load_sphere_maps
    and load_toon_ramps: sphere textures [P] of [h,w,3], modes [P], toon
    ramps [P,K,3]) -> MmdMaps on `device` (the card unless the caller asks
    for another). The sphere maps are packed here, on the host, once: a
    Scene keeps the result (`Scene.mmd_device_maps`); an MmdMaps passes
    through unchanged."""
    if isinstance(mmd_maps, MmdMaps):
        return mmd_maps
    device = resolve_device(device)
    texs, modes, ramps = mmd_maps
    modes = np.asarray(modes, np.int32)
    ramps = np.asarray(ramps, np.float32)
    any_sphere = bool((modes != 0).any())
    return MmdMaps(
        sphere_textures=list(texs),
        sphere_atlas=(build_packed_atlas(texs, device=device) if any_sphere
                      else None),
        sphere_modes=torch.as_tensor(modes, device=device),
        any_sphere=any_sphere,
        toon_ramps=torch.as_tensor(ramps.reshape(-1, 3), device=device),
        k=int(ramps.shape[1]))


def _part_of(static, tri):
    """Each pixel's part from its triangle id (uncovered pixels: part 0)."""
    n_parts = static.part_base.shape[0]
    return torch.clamp(torch.searchsorted(
        static.part_base, torch.clamp(tri, min=0).contiguous(),
        right=True) - 1, 0, n_parts - 1)


def _part_rows(table, pid):
    """table [..., P, C] at the pixels' parts pid [..., H, W] (the same
    leading instance axes, each instance reading its own rows)."""
    if table.dim() == 2:
        return table[pid]
    n_parts = table.shape[-2]
    base = torch.arange(pid[..., 0, 0].numel(), device=pid.device) * n_parts
    return table.reshape(-1, table.shape[-1])[
        pid + base.reshape(pid.shape[:-2] + (1, 1))]


def _part_colour(static, tri, albedo, part_color):
    """The material morphs' albedo modulation (reference `render_frame`
    l.1361-1365, crowd l.987-1000; beyond the original app): each pixel's
    albedo times its part's `mul` plus its `add`, clamped at 0. `part_color`
    = (mul, add), [P, 3] each, or [I, P, 3] for a crowd."""
    with pass_scope("morphs"):
        mul, add = part_color
        pid = _part_of(static, tri)
        return torch.clamp(albedo * _part_rows(mul, pid)
                           + _part_rows(add, pid), min=0.0)


def _mmd_shading(cfg, mats, static, tri, nrm_px, albedo, mmd):
    """MMD extended shading (reference `render_frame` l.1367-1397, beyond
    the original app, whose shader ignores toon and sphere maps): the
    part's toon ramp at v = 0.5 - 0.5 dot(N, L) multiplies the albedo
    (index rounded half to even, as jnp.round), SPH sphere maps multiply
    it, SPA maps are added after shading; sphere maps are sampled at
    view-space-normal UVs. Leading instance axes pass through.
    -> (albedo, addend or None)."""
    dev = nrm_px.device
    pid = _part_of(static, tri)
    ldir = _f32(cfg.light_direction, dev)
    ldir = ldir / torch.linalg.vector_norm(ldir)
    ndl = -torch.sum(nrm_px * ldir, -1)              # dot(N, toward the light)
    k = mmd.k
    qi = torch.clamp(torch.round((0.5 - 0.5 * ndl) * (k - 1)), 0,
                     k - 1).to(torch.int64)
    albedo = albedo * _take_rows(mmd.toon_ramps, pid * k + qi)
    if not mmd.any_sphere:
        return albedo, None
    nv = nrm_px @ mats["view"][:3, :3].T
    uv_s = torch.stack([nv[..., 0] * 0.5 + 0.5, 0.5 - nv[..., 1] * 0.5], -1)
    scol = character_albedo(static, tri, uv_s, mmd.sphere_textures,
                            mmd.sphere_atlas)
    modes_px = mmd.sphere_modes[pid][..., None]
    albedo = torch.where(modes_px == 1, albedo * scol, albedo)
    return albedo, torch.where(modes_px == 2, scol, torch.zeros_like(scol))


# ---------------------------------------------------------------------------
# The frame's stages, shared by the single frame and the crowd (leading
# instance axes pass through)
# ---------------------------------------------------------------------------

def _background(cfg, mats, shadow_map, lead, width, height, dev,
                cubemap=None):
    """Clear colour or skybox, then the shadowed ground -> (color [*lead, H,
    W, 3], ground_depth [H, W]). `shadow_map` is [S, S] for one frame (lead
    ()) or [I, S, S] for a crowd (lead (I,)), None with shadows off: the
    skybox, the ground's geometry and its light-space positions belong to
    the camera and are computed once, the lit lookup per map."""
    color = _f32(cfg.clear_color, dev).expand(height, width, 3)
    if cfg.show_skybox and cubemap is not None:
        with pass_scope("skybox"):
            color = ibl.skybox_colors(
                torch.as_tensor(cubemap, dtype=torch.float32, device=dev),
                mats["view"], mats["proj"], width, height)
    if not cfg.show_ground:
        return color.expand(lead + (height, width, 3)), torch.ones(
            (height, width), dtype=torch.float32, device=dev)
    with pass_scope("ground"):
        ground_mask, gpos, ground_depth = ground_pass(
            cfg, mats["view"], mats["proj"], width, height)
        if shadow_map is not None:
            lit_map = shade.ground_lit_map(shadow_map, mats["light_vp"])
            ds = max(int(cfg.shadow_lookup_downsample), 1)
            if ds > 1 and width % ds == 0 and height % ds == 0:
                # one geometric halo row beyond each edge (row0=-1,
                # rows=lh+2) feeds the bilinear upsample
                lw, lh = width // ds, height // ds
                _, gpos_lo, _ = ground_pass(cfg, mats["view"], mats["proj"],
                                            lw, lh, row0=-1, rows=lh + 2)
                lclip = raster.transform_clip(
                    gpos_lo.reshape(-1, 3), mats["light_vp"]).reshape(
                        lh + 2, lw, 4)
                lit = upsample_bilinear_int(
                    shade.ground_shadow_lookup(lclip, lit_map), ds,
                    pre_padded_rows=True)
            else:
                lclip = raster.transform_clip(
                    gpos.reshape(-1, 3), mats["light_vp"]).reshape(
                        height, width, 4)
                lit = shade.ground_shadow_lookup(lclip, lit_map)
        else:
            lit = torch.ones(lead + (height, width, 1), dtype=torch.float32,
                             device=dev)
        gcolor = torch.ones(3, dtype=torch.float32, device=dev) * 0.7 * lit
        color = torch.where(ground_mask[..., None], gcolor, color)
        return color.expand(lead + (height, width, 3)), ground_depth


def _edge_hull(static, positions_mmd, normals, cfg, mats, width, height,
               ground_depth):
    """Edge outlines (reference `render_frame` l.1204-1227, crowd
    l.934-953; beyond the original app): the inverted hull of the
    MAT_DRAW_EDGE parts, its vertices displaced along the deformed normals
    by edge_mag * 0.01 * edge_scale, front faces culled so that only the
    silhouette ring shows. One frame rasterizes it with K2 at 0 attributes
    (`rasterize_tiled`), or with the scan raster (`raster.rasterize`, KS)
    under raster_mode="scan", a crowd [I, V, 3] with K5a and one zero
    attribute, as the reference does. -> (mask [*lead, H, W] where the
    hull is nearer than the ground, its part's edge colour [*lead, H, W,
    3]), or None without edges."""
    from ..ops.tiled_raster import rasterize_attrs_tiled_crowd, rasterize_tiled
    if not (cfg.show_edges and static.n_edge_tris):
        return None
    with pass_scope("edges"):
        emag = (static.edge_mag * (0.01 * cfg.edge_scale))[:, None]
        verts_e = (positions_mmd + normals * emag) * cfg.mmd_to_meter
        etris = static.edge_tris.flip(-1)
        clip_e = raster.transform_clip(verts_e, mats["mvp"])
        if cfg.raster_mode == "scan":
            vis_e = raster.rasterize(clip_e, etris, width, height,
                                     raster.CULL_FRONT)
        elif clip_e.dim() == 3:
            vis_e, _ = rasterize_attrs_tiled_crowd(
                clip_e, etris, torch.zeros(positions_mmd.shape[:2] + (1,),
                                           dtype=torch.float32,
                                           device=clip_e.device),
                width, height, raster.CULL_FRONT)
        else:
            vis_e = rasterize_tiled(clip_e, etris, width, height,
                                    raster.CULL_FRONT,
                                    e_max=_tiled_e_max(width, height),
                                    compact=cfg.compact_bin)
        pid_e = static.edge_tri_part[torch.clamp(vis_e.tri, min=0).long()]
        color = static.edge_colors[pid_e][..., :3]
        return (vis_e.tri >= 0) & (vis_e.depth <= ground_depth), color


def _nocull(cfg, static):
    """The double-sided materials' [T] cull exemption (a host gate), or
    None."""
    return (static.nocull_tris if cfg.double_sided and static.has_nocull
            else None)


def _surface(cfg, mats, vis, attr_px, nocull, width, height):
    """(world positions unprojected from the depth, normals): with a model
    matrix (`mats["model"]`) the normals get its normal matrix inv(M3)^T
    (the positions are unprojected after it already); with double-sided
    materials the back faces shade with the viewer-facing normal, before
    the albedo and the MMD shading read it."""
    world_px = unproject_depth(vis.depth, mats["proj"] @ mats["view"],
                               width, height)
    nrm_px = attr_px[..., 0:3]
    if mats["model"] is not None:
        nmat = torch.linalg.inv_ex(mats["model"][:3, :3]).inverse.T
        nrm_px = nrm_px @ nmat.T
    if nocull is not None:
        to_eye = _f32(cfg.camera_pos, world_px.device) - world_px
        flip = torch.sum(nrm_px * to_eye, -1, keepdim=True) < 0.0
        nrm_px = torch.where(flip, -nrm_px, nrm_px)
    return world_px, nrm_px


def _composite(cfg, mats, static, color, vis, world_px, nrm_px, albedo,
               sdepth, ground_depth, mmd=None, edges=None, part_color=None):
    """Shade the character once per pixel from the visibility buffer, its
    world positions, normals and albedo (None: white), with the material
    morphs' part colour (`_part_colour`) and then the MMD toon / sphere
    shading where they are given, and lay it over `color`: the edge
    outlines first (under the character), then the character by the depth
    test against the ground, or with per-sample depths (`sdepth`
    [..., 4, H, W]) by coverage. Leading instance axes pass through."""
    dev = vis.depth.device
    char_mask = (vis.tri >= 0) & (vis.depth <= ground_depth)
    if albedo is None:
        albedo = torch.ones(vis.depth.shape + (3,), dtype=torch.float32,
                            device=dev)
    if part_color is not None:
        albedo = _part_colour(static, vis.tri, albedo, part_color)
    addend = None
    if mmd is not None:
        with pass_scope("mmd"):
            albedo, addend = _mmd_shading(cfg, mats, static, vis.tri, nrm_px,
                                          albedo, mmd)
    with pass_scope("shade"):
        char_color = shade.shade_character(
            albedo, nrm_px, world_px, _f32(cfg.camera_pos, dev), cfg)
    if addend is not None:
        char_color = char_color + addend
    if edges is not None:
        edge_mask, edge_color = edges
        color = torch.where((edge_mask & ~char_mask)[..., None], edge_color,
                            color)
    if sdepth is not None:
        # MSAA resolve: shaded once per pixel (centre attributes), coverage
        # from the 4 per-sample depths against the ground's depth
        mask_s = (sdepth < 1.0 - 1e-7) & (sdepth <= ground_depth)
        frac = mask_s.to(torch.float32).mean(-3)[..., None]
        color = color * (1.0 - frac) + char_color * frac
    else:
        color = torch.where(char_mask[..., None], char_color, color)
    return torch.clamp(color, 0.0, 1.0)


def render_frame(static, positions_mmd, normals, cfg, part_textures=None,
                 cubemap=None, model_mat=None, width=None, height=None,
                 uv_offsets=None, part_color=None, mmd_maps=None, atlas=None,
                 proj_transform=None, aspect=None):
    """Full main-pass image, [H,W,3] float32 in [0,1], on the device of
    `positions_mmd`.

    static: the model's device tables (core.model.ModelTables).
    positions_mmd/normals: deformed vertices from core.pose.deform (MMD
    units). part_textures: per-part [h,w,3] textures (NumPy), sampled
    through `atlas` (a PackedAtlas, e.g. `Scene.packed_atlas()`), or
    through one packed here from `part_textures` when none is given.
    cubemap: [6,S,S,3] (`render.ibl.equirect_to_cubemap`), drawn as the
    skybox when `cfg.show_skybox`. mmd_maps: the toon ramps and sphere maps,
    an MmdMaps (`build_mmd_maps`, e.g. `Scene.mmd_device_maps()`) or the
    reference's tuple, then packed here on every call. `cfg.show_edges`
    draws the edge outlines, `cfg.double_sided` exempts the double-faced
    parts' triangles from culling and lights their back faces.
    uv_offsets [V, 2] (`core.pose.uv_morph_offsets`) move the UVs the
    textures are sampled at; part_color = (mul [P, 3], add [P, 3])
    (`core.pose.material_morph_factors`) modulates the albedo by part.
    model_mat (4x4) places the character (its shadow and edges too; the
    normals get its normal matrix). proj_transform (4x4 clip-space
    transform, with `aspect` the full frame's ratio) renders one band of a
    larger frame. The camera and light may be tensors (a camera or light
    track's samples, `Scene.frame_config`), `camera_orthographic` a bool
    tensor. `cfg.raster_mode="scan"` rasterizes the shadow map, the edge
    hull and the character with the exact scan raster (`raster.rasterize`,
    KS), the attributes interpolated from its visibility buffer, the UVs
    riding as attributes 3-4 and 4x MSAA supersampled, as the reference's
    scan raster does; "auto" and "tiled" take the binned tile rasters."""
    dev = positions_mmd.device
    width = width or cfg.width
    height = height or cfg.height
    if mmd_maps is not None:
        mmd_maps = build_mmd_maps(mmd_maps, dev)
    scan = cfg.raster_mode == "scan"
    msaa_native = cfg.msaa >= 4 and not cfg.msaa_supersample and not scan
    if cfg.msaa >= 4 and not msaa_native:
        # 2x2 supersampling at msaa=1 (the ground's lit lookup at twice the
        # downsample, so it runs at the same resolution), then a box filter
        sub = dataclasses.replace(cfg, msaa=1, shadow_lookup_downsample=max(
            2 * cfg.shadow_lookup_downsample, 2))
        big = render_frame(static, positions_mmd, normals, sub,
                           part_textures=part_textures, cubemap=cubemap,
                           model_mat=model_mat, width=2 * width,
                           height=2 * height, uv_offsets=uv_offsets,
                           part_color=part_color, mmd_maps=mmd_maps,
                           atlas=atlas, proj_transform=proj_transform,
                           aspect=aspect)
        return big.reshape(height, 2, width, 2, 3).mean(dim=(1, 3))
    mats = build_matrices(cfg, model_mat,
                          width / height if aspect is None else aspect,
                          proj_transform, device=dev)

    verts_m = positions_mmd * cfg.mmd_to_meter
    tris = static.triangles.flip(-1)              # winding flip at upload
    # deferred UV: with albedo_window on the tiled raster the UVs are
    # rebuilt from the visibility buffer (uv_from_vis), else they ride the
    # raster as attributes 3-4
    defer_uv = part_textures is not None and cfg.albedo_window and not scan
    attrs, uvs = normals, static.uvs
    if part_textures is not None and uv_offsets is not None:
        with pass_scope("morphs"):
            uvs = uvs + uv_offsets          # UV morphs, before either path
    if part_textures is not None and not defer_uv:
        attrs = torch.cat([normals, uvs], -1)

    # per-corner vertex table shared by the tiled shadow and character
    # rasters: one 3T-row gather of [pos | attrs], transformed per pass
    corner_pos = corner_va = None
    if not scan:
        g3 = torch.cat([verts_m, attrs], -1)[tris.long()]
        corner_pos, corner_va = g3[..., :3], g3[..., 3:]

    shadow_map = None
    if cfg.shadows_enabled:
        from ..ops.tiled_raster import rasterize_tiled
        with pass_scope("shadow"):
            # the raster function, as the reference's _pick_raster gives it
            shadow_map = shadow_pass(verts_m, tris, mats["light_mvp"],
                                     cfg.shadow_map_size,
                                     raster.rasterize if scan
                                     else rasterize_tiled,
                                     cfg.shadow_window,
                                     compact=cfg.compact_bin,
                                     corner_pos=corner_pos)

    color, ground_depth = _background(cfg, mats, shadow_map, (), width,
                                      height, dev, cubemap)
    edges = _edge_hull(static, positions_mmd, normals, cfg, mats, width,
                       height, ground_depth)

    clip = raster.transform_clip(verts_m, mats["mvp"])
    nocull = _nocull(cfg, static)
    sdepth = None
    with pass_scope("character"):
        from ..ops.tiled_raster import (rasterize_attrs_tiled,
                                        rasterize_attrs_tiled_msaa)
        if scan:
            vis = raster.rasterize(clip, tris, width, height,
                                   raster.CULL_BACK, nocull=nocull)
            attr_px = raster.interpolate(vis, clip, tris, attrs)
        else:
            cv = raster.transform_clip(corner_pos, mats["mvp"])
            raster_fn = (rasterize_attrs_tiled_msaa if msaa_native
                         else rasterize_attrs_tiled)
            vis, attr_px, *ms = raster_fn(
                clip, tris, attrs, width, height, raster.CULL_BACK,
                e_max=_tiled_e_max(width, height), nocull=nocull,
                compact=cfg.compact_bin, cv=cv, va=corner_va)
            sdepth = ms[0] if ms else None
    world_px, nrm_px = _surface(cfg, mats, vis, attr_px, nocull, width,
                                height)
    albedo = None
    if part_textures is not None:
        with pass_scope("albedo"):
            albedo = _frame_albedo(static, cfg, part_textures, atlas, vis,
                                   None if defer_uv else attr_px[..., 3:5],
                                   uvs, tris, clip, width, height)
    return _composite(cfg, mats, static, color, vis, world_px, nrm_px,
                      albedo, sdepth, ground_depth, mmd_maps, edges,
                      part_color)


def crowd_render_supported(cfg, part_textures=None, cubemap=None,
                           camera=None) -> bool:
    """True when `crowd_render_frame` covers the config: textures (one
    shared atlas, mips selected per instance), native 4x MSAA, edge
    outlines (a second crowd raster over the displaced hull), double-sided
    materials (the shared nocull mask), the skybox (one camera-shared
    pass), MMD toon/sphere shading (over the instance axis), shadows and
    ground are all in the fused frame. A per-instance camera, the
    supersampled MSAA and the scan raster (as in the reference) render
    instance by instance instead (parallel.mesh.crowd_step_fn).
    `texture_resident` is ignored on the crowd path: the mip atlas is
    sampled directly, which is exact."""
    return (camera is None
            and not (cfg.msaa >= 4 and cfg.msaa_supersample)
            and cfg.raster_mode != "scan")


def crowd_render_frame(static, positions_mmd, normals, cfg, width=None,
                       height=None, part_textures=None, atlas=None,
                       cubemap=None, mmd_maps=None, uv_offsets=None,
                       part_color=None):
    """Multi-instance frame: positions/normals carry a leading instance
    axis [I,N,3]; one binning sort and one kernel launch cover all
    instances' shadow maps, and one more their character rasters. Work the
    instances share through the camera (the skybox, ground geometry, the
    ground's light-space positions) is computed once. Per-part textures
    sample the shared atlas per instance, the UVs riding the raster as
    attributes 3-4; a mip-chain atlas selects each triangle's level from
    its own instance's screen footprint (`texture_resident` is ignored
    here, as in the reference: the mip atlas is sampled directly). Edge
    outlines are one more crowd raster (K5a), the double-sided materials'
    exemption is shared by the instances, and the MMD shading runs over
    the instance axis. `cubemap` and `mmd_maps` as render_frame takes
    them; `uv_offsets` [I, V, 2] and `part_color` = (mul, add) [I, P, 3]
    each are the instances' own extended morphs. -> [I,H,W,3]."""
    from ..ops.tiled_raster import (rasterize_attrs_tiled_crowd,
                                    rasterize_attrs_tiled_msaa_crowd,
                                    rasterize_depth_tiled_crowd)
    if not crowd_render_supported(cfg):
        raise NotImplementedError('raster_mode="scan"'
                                  if cfg.raster_mode == "scan"
                                  else "msaa_supersample")
    dev = positions_mmd.device
    width = width or cfg.width
    height = height or cfg.height
    if mmd_maps is not None:
        mmd_maps = build_mmd_maps(mmd_maps, dev)
    n_inst = positions_mmd.shape[0]
    mats = build_matrices(cfg, aspect=width / height, device=dev)
    verts_m = positions_mmd * cfg.mmd_to_meter
    tris = static.triangles.flip(-1)              # winding flip at upload
    attrs = normals
    uvs = None
    if part_textures is not None:
        uvs = static.uvs.expand((n_inst,) + static.uvs.shape)
        if uv_offsets is not None:
            with pass_scope("morphs"):
                uvs = static.uvs + uv_offsets     # per-instance UV morphs
        attrs = torch.cat([normals, uvs], -1)

    # per-corner vertex tables shared by the shadow and character rasters:
    # one [I*T*3]-row gather of [pos | attrs], transformed per pass
    g3 = torch.cat([verts_m, attrs], -1)[:, tris.long()]
    corner_pos, corner_va = g3[..., :3], g3[..., 3:]

    shadow_maps = None
    if cfg.shadows_enabled:
        with pass_scope("shadow"):
            shadow_maps = rasterize_depth_tiled_crowd(
                raster.transform_clip(verts_m, mats["light_vp"]), tris,
                cfg.shadow_map_size, cfg.shadow_map_size, raster.CULL_FRONT,
                cv=raster.transform_clip(corner_pos, mats["light_vp"]))

    # background and ground: camera-shared geometry (and skybox) computed
    # once, the lit maps of all instances in one launch of K3
    color, ground_depth = _background(cfg, mats, shadow_maps, (n_inst,),
                                      width, height, dev, cubemap)

    clip = raster.transform_clip(verts_m, mats["mvp"])
    cv = raster.transform_clip(corner_pos, mats["mvp"])
    nocull = _nocull(cfg, static)
    sdepth = None
    with pass_scope("character"):
        if cfg.msaa >= 4:
            vis, attr_px, sdepth = rasterize_attrs_tiled_msaa_crowd(
                clip, tris, attrs, width, height, raster.CULL_BACK, cv=cv,
                va=corner_va, nocull=nocull)
        else:
            vis, attr_px = rasterize_attrs_tiled_crowd(
                clip, tris, attrs, width, height, raster.CULL_BACK, cv=cv,
                va=corner_va, nocull=nocull)
    edges = _edge_hull(static, positions_mmd, normals, cfg, mats, width,
                       height, ground_depth)
    world_px, nrm_px = _surface(cfg, mats, vis, attr_px, nocull, width,
                                height)
    albedo = None
    if part_textures is not None:
        with pass_scope("albedo"):
            if atlas is not None and atlas.n_mips > 1:
                # per-instance fused UV/placement rows [I, T, 12]: each
                # triangle's mip level from its instance's screen footprint
                screen, _, _ = raster.screen_from_clip(clip, width, height)
                rows = affine_uv_part_rows(uvs, tris, atlas, static,
                                           screen_xy=screen)
                albedo = _albedo_rows(atlas, vis.tri, vis.bary, rows)
            else:
                albedo = character_albedo(static, vis.tri,
                                          attr_px[..., 3:5], part_textures,
                                          atlas)
    return _composite(cfg, mats, static, color, vis, world_px, nrm_px,
                      albedo, sdepth, ground_depth, mmd_maps, edges,
                      part_color)
