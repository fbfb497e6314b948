"""Frame pipeline: shadow pass -> ground -> character -> shading.

Port of the single-character subset of `simple_mmd_renderer_tpu/render/
pipeline.py`: `build_matrices`, `ground_pass` (with its row0/rows halo),
`unproject_depth`, `upsample_bilinear_int`, `_tiled_e_max`, `shadow_pass`
(with the caster window) and `render_frame` for the untextured frame with
no skybox, at msaa=1 or msaa=4 (native per-sample MSAA with a coverage
resolve, or 2x2 supersampling with `msaa_supersample`). The rasterizer is
the binned tile raster (`ops/tiled_raster.py`) on every device; its
kernels (K1/K6 shadow depth, K2/K4 character) and the ground's PCF kernel
(K3) run as hand-written CUDA on the card.

`crowd_render_frame` is the multi-instance frame: one binning and one
kernel launch for all instances' shadow maps (K5c) and character rasters
(K5a, or K5b at msaa=4), K3 over the batch of shadow maps, and the
camera-shared ground computed once.

Options outside the slice raise NotImplementedError naming the option.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.profiling import pass_scope
from . import camera as cam
from . import raster
from . import shade


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def build_matrices(cfg, aspect=None, device=None):
    """Camera and light matrices (float32 on `device`)."""
    if aspect is None:
        aspect = cfg.width / cfg.height
    proj = cam.perspective(cam.deg2rad(cfg.camera_fov_deg, device), aspect,
                           cfg.near, cfg.far, device=device)
    if not (isinstance(cfg.camera_orthographic, bool)
            and not cfg.camera_orthographic):
        raise NotImplementedError("camera_orthographic")
    up = torch.zeros(3, dtype=torch.float32, device=device)
    up[1] = 1.0
    view = cam.look_at(cfg.camera_pos, cfg.camera_target, up, device=device)
    mvp = proj @ view

    hs = cfg.shadow_frustum_half
    light_proj = cam.orthographic(-hs, hs, -hs, hs, cfg.shadow_near,
                                  cfg.shadow_far, device=device)
    light_view = cam.directional_light_view(cfg.light_direction, device)
    light_vp = light_proj @ light_view
    return dict(view=view, proj=proj, mvp=mvp, light_vp=light_vp)


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


def shadow_pass(verts_m, tris_flipped, light_mvp, size, window=False,
                compact=True, corner_pos=None):
    """Depth-only character raster from the light (front-face cull).
    `window` restricts it to the casters' tile bounding box (K6) for maps
    of at least 1024^2. `corner_pos` [T,3,3] may pass pre-gathered
    per-corner world positions shared with the main pass."""
    from ..ops.tiled_raster import (rasterize_depth_tiled,
                                    rasterize_depth_tiled_window)
    clip = raster.transform_clip(verts_m, light_mvp)
    cv = (raster.transform_clip(corner_pos, light_mvp)
          if corner_pos is not None else None)
    if window and size >= 1024:
        return rasterize_depth_tiled_window(clip, tris_flipped, size, size,
                                            raster.CULL_FRONT,
                                            _tiled_e_max(size, size), 32,
                                            compact=compact, cv=cv)
    return rasterize_depth_tiled(clip, tris_flipped, size, size,
                                 raster.CULL_FRONT, _tiled_e_max(size, size),
                                 compact=compact, cv=cv)


def _background(cfg, mats, shadow_map, lead, width, height, dev):
    """Clear colour and shadowed ground -> (color [*lead, H, W, 3],
    ground_depth [H, W]). `shadow_map` is [S, S] for one frame (lead ()) or
    [I, S, S] for a crowd (lead (I,)), None with shadows off: the ground's
    geometry and light-space positions belong to the camera and are
    computed once, the lit lookup per map."""
    color = _f32(cfg.clear_color, dev).expand(lead + (height, width, 3))
    if not cfg.show_ground:
        return color, torch.ones((height, width), dtype=torch.float32,
                                 device=dev)
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
        return torch.where(ground_mask[..., None], gcolor, color), \
            ground_depth


def _composite(cfg, mats, color, vis, attr_px, sdepth, ground_depth, width,
               height):
    """Shade the character once per pixel from the visibility buffer and
    lay it over `color`: by the depth test against the ground, or with
    per-sample depths (`sdepth` [..., 4, H, W]) by coverage. Leading
    instance axes pass through."""
    dev = vis.depth.device
    char_mask = (vis.tri >= 0) & (vis.depth <= ground_depth)
    world_px = unproject_depth(vis.depth, mats["proj"] @ mats["view"],
                               width, height)
    nrm_px = attr_px[..., 0:3]
    albedo = torch.ones(vis.depth.shape + (3,), dtype=torch.float32,
                        device=dev)
    with pass_scope("shade"):
        char_color = shade.shade_character(
            albedo, nrm_px, world_px, _f32(cfg.camera_pos, dev), cfg)
    if sdepth is not None:
        # MSAA resolve: shaded once per pixel (centre attributes), coverage
        # from the 4 per-sample depths against the ground's depth
        mask_s = (sdepth < 1.0 - 1e-7) & (sdepth <= ground_depth)
        frac = mask_s.to(torch.float32).mean(-3)[..., None]
        color = color * (1.0 - frac) + char_color * frac
    else:
        color = torch.where(char_mask[..., None], char_color, color)
    return torch.clamp(color, 0.0, 1.0)


def _check_slice(cfg, part_textures, cubemap, uv_offsets, part_color,
                 mmd_maps, proj_transform):
    """Raise NotImplementedError for every option outside the ported
    slice."""
    unsupported = [
        ("part_textures", part_textures is not None),
        ("show_skybox", bool(cfg.show_skybox) and cubemap is not None),
        ("show_edges", bool(cfg.show_edges)),
        ("double_sided", bool(cfg.double_sided)),
        ("mmd_maps", mmd_maps is not None),
        ("part_color", part_color is not None),
        ("uv_offsets", uv_offsets is not None),
        ("proj_transform", proj_transform is not None),
        ('raster_mode="scan"', cfg.raster_mode == "scan"),
    ]
    for name, used in unsupported:
        if used:
            raise NotImplementedError(name)


def render_frame(static, positions_mmd, normals, cfg, part_textures=None,
                 cubemap=None, width=None, height=None, uv_offsets=None,
                 part_color=None, mmd_maps=None, proj_transform=None):
    """Full main-pass image, [H,W,3] float32 in [0,1], on the device of
    `positions_mmd`.

    static: the model's device tables (core.model.ModelTables); only
    `triangles` is read. positions_mmd/normals: deformed vertices from
    core.pose.deform (MMD units)."""
    _check_slice(cfg, part_textures, cubemap, uv_offsets, part_color,
                 mmd_maps, proj_transform)
    dev = positions_mmd.device
    width = width or cfg.width
    height = height or cfg.height
    msaa_native = cfg.msaa >= 4 and not cfg.msaa_supersample
    if cfg.msaa >= 4 and not msaa_native:
        # 2x2 supersampling at msaa=1 (the ground's lit lookup at twice the
        # downsample, so it runs at the same resolution), then a box filter
        sub = dataclasses.replace(cfg, msaa=1, shadow_lookup_downsample=max(
            2 * cfg.shadow_lookup_downsample, 2))
        big = render_frame(static, positions_mmd, normals, sub,
                           width=2 * width, height=2 * height)
        return big.reshape(height, 2, width, 2, 3).mean(dim=(1, 3))
    mats = build_matrices(cfg, aspect=width / height, device=dev)

    verts_m = positions_mmd * cfg.mmd_to_meter
    tris = static.triangles.flip(-1)              # winding flip at upload
    attrs = normals

    # per-corner vertex table shared by the shadow and character rasters:
    # one 3T-row gather of [pos | attrs], transformed per pass
    g3 = torch.cat([verts_m, attrs], -1)[tris.long()]
    corner_pos, corner_va = g3[..., :3], g3[..., 3:]

    shadow_map = None
    if cfg.shadows_enabled:
        with pass_scope("shadow"):
            shadow_map = shadow_pass(verts_m, tris, mats["light_vp"],
                                     cfg.shadow_map_size, cfg.shadow_window,
                                     compact=cfg.compact_bin,
                                     corner_pos=corner_pos)

    color, ground_depth = _background(cfg, mats, shadow_map, (), width,
                                      height, dev)

    clip = raster.transform_clip(verts_m, mats["mvp"])
    cv = raster.transform_clip(corner_pos, mats["mvp"])
    sdepth = None
    with pass_scope("character"):
        from ..ops.tiled_raster import (rasterize_attrs_tiled,
                                        rasterize_attrs_tiled_msaa)
        if msaa_native:
            vis, attr_px, sdepth = rasterize_attrs_tiled_msaa(
                clip, tris, attrs, width, height, raster.CULL_BACK,
                _tiled_e_max(width, height), cfg.compact_bin, cv=cv,
                va=corner_va)
        else:
            vis, attr_px = rasterize_attrs_tiled(
                clip, tris, attrs, width, height, raster.CULL_BACK,
                _tiled_e_max(width, height), cfg.compact_bin, cv=cv,
                va=corner_va)
    return _composite(cfg, mats, color, vis, attr_px, sdepth, ground_depth,
                      width, height)


def crowd_render_supported(cfg, part_textures=None, cubemap=None,
                           camera=None) -> bool:
    """True when `crowd_render_frame` covers the config: a shared camera,
    the tiled raster, and msaa=1 or native 4x MSAA. The supersampled MSAA
    and a per-instance camera render instance by instance instead
    (parallel.mesh.crowd_step_fn)."""
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
    instances share through the camera (ground geometry, the ground's
    light-space positions) is computed once. -> [I,H,W,3]."""
    from ..ops.tiled_raster import (rasterize_attrs_tiled_crowd,
                                    rasterize_attrs_tiled_msaa_crowd,
                                    rasterize_depth_tiled_crowd)
    _check_slice(cfg, part_textures, cubemap, uv_offsets, part_color,
                 mmd_maps, None)
    if atlas is not None:
        raise NotImplementedError("atlas")
    if not crowd_render_supported(cfg):
        raise NotImplementedError("msaa_supersample")
    dev = positions_mmd.device
    width = width or cfg.width
    height = height or cfg.height
    n_inst = positions_mmd.shape[0]
    mats = build_matrices(cfg, aspect=width / height, device=dev)
    verts_m = positions_mmd * cfg.mmd_to_meter
    tris = static.triangles.flip(-1)              # winding flip at upload
    attrs = normals

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

    # background and ground: camera-shared geometry computed once, the lit
    # maps of all instances in one launch of K3
    color, ground_depth = _background(cfg, mats, shadow_maps, (n_inst,),
                                      width, height, dev)

    clip = raster.transform_clip(verts_m, mats["mvp"])
    cv = raster.transform_clip(corner_pos, mats["mvp"])
    sdepth = None
    with pass_scope("character"):
        if cfg.msaa >= 4:
            vis, attr_px, sdepth = rasterize_attrs_tiled_msaa_crowd(
                clip, tris, attrs, width, height, raster.CULL_BACK, cv=cv,
                va=corner_va)
        else:
            vis, attr_px = rasterize_attrs_tiled_crowd(
                clip, tris, attrs, width, height, raster.CULL_BACK, cv=cv,
                va=corner_va)
    return _composite(cfg, mats, color, vis, attr_px, sdepth, ground_depth,
                      width, height)
