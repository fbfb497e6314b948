"""Deferred shading: the reference's GLSL fragment programs on torch tensors.

Port of `simple_mmd_renderer_tpu/render/shade.py`: `shade_character`
(main.glsl: albedo, rim, Blinn-Phong, weak diffuse, final srgb->linear
transfer), `srgb_to_linear` / `linear_to_srgb`, the per-pixel ground of
shader/ground.glsl (`pcf_shadow`, `shade_ground`), and the frame's ground
shadow path: `_ground_zref_plane`, `ground_lit_map` (3x3 PCF in shadow
space, kernel K3 on the card for every map size) and
`ground_shadow_lookup`.
"""

from __future__ import annotations

import torch

from ..ops import shadow_pcf


def srgb_to_linear(c):
    """SrgbToLinear (main.glsl:64-77) — applied to the *final* color."""
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow(torch.abs((c + 0.055) / 1.055), 2.4))


def linear_to_srgb(c):
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(torch.abs(c), 1.0 / 2.4) - 0.055)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def shade_character(albedo, normal, world_pos, view_pos, cfg):
    """albedo/normal/world_pos: [...,3]; view_pos [3]; cfg: RenderConfig.
    Evaluated per channel plane, in the reference's order."""
    dev = normal.device
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    nn = torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=1e-12)
    nx, ny, nz = nx / nn, ny / nn, nz / nn
    vx = view_pos[0] - world_pos[..., 0]
    vy = view_pos[1] - world_pos[..., 1]
    vz = view_pos[2] - world_pos[..., 2]
    vn = torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz), min=1e-12)
    vx, vy, vz = vx / vn, vy / vn, vz / vn
    ld = -_f32(cfg.light_direction, dev)
    l = ld / torch.clamp(torch.linalg.vector_norm(ld, dim=-1, keepdim=True),
                         min=1e-12)

    ndotv = torch.clamp(nx * vx + ny * vy + nz * vz, min=0.0)
    rim_factor = torch.pow(torch.abs(1.0 - ndotv), cfg.rim_power)

    hx, hy, hz = vx + l[0], vy + l[1], vz + l[2]
    hinv = 1.0 / torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz),
                             min=1e-12)
    ndoth = torch.clamp((nx * hx + ny * hy + nz * hz) * hinv, min=0.0)
    ndotl = torch.clamp(nx * l[0] + ny * l[1] + nz * l[2], min=0.0)
    spec_factor = torch.where(ndotl > 0.0,
                              torch.pow(torch.abs(ndoth), cfg.specular_power),
                              torch.zeros_like(ndoth))
    light_col = _f32(cfg.light_color, dev) * cfg.light_intensity
    rim_col = _f32(cfg.rim_color, dev) * cfg.rim_intensity

    chans = []
    for c in range(3):
        final = (albedo[..., c] * (0.9 + light_col[c] * 0.25 * ndotl)
                 + rim_col[c] * rim_factor
                 + light_col[c] * cfg.specular_intensity * spec_factor)
        chans.append(srgb_to_linear(final))
    return torch.stack(chans, -1)


def pcf_shadow(light_space_pos, shadow_map, enabled, bias=0.001):
    """Per-pixel 3x3 PCF (shader/ground.glsl:66-125): light_space_pos
    [..., 4] clip coordinates in the light frustum, shadow_map [S, S] depth
    (rendered y-down, so the GL-style v flips to a row index); `enabled` a
    bool or a bool tensor. -> [..., 1] shadow factor in [0, 1] (1 = lit;
    outside the frustum lit). The frame's ground uses `ground_lit_map`
    (PCF in shadow space, K3) and one lookup a pixel instead."""
    s = shadow_map.shape[0]
    w = light_space_pos[..., 3:4]
    proj = light_space_pos[..., :3] / torch.where(torch.abs(w) > 1e-9, w,
                                                  torch.ones_like(w))
    proj = proj * 0.5 + 0.5
    u = proj[..., 0]
    v_ = 1.0 - proj[..., 1]
    w0 = w[..., 0]
    zref = light_space_pos[..., 2] / torch.where(torch.abs(w0) > 1e-9, w0,
                                                 torch.ones_like(w0))
    inside = ((u >= -0.001) & (u <= 1.001) & (v_ >= -0.001) & (v_ <= 1.001)
              & (zref >= 0.0) & (zref <= 1.001))
    px = torch.clamp((torch.clamp(u, 0.0, 1.0) * s).to(torch.int32), 0, s - 1)
    py = torch.clamp((torch.clamp(v_, 0.0, 1.0) * s).to(torch.int32), 0,
                     s - 1)
    total = torch.zeros_like(zref)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx = torch.clamp(px + dx, 0, s - 1).long()
            qy = torch.clamp(py + dy, 0, s - 1).long()
            total = total + (zref - bias < shadow_map[qy, qx]).to(
                torch.float32)
    shadow = torch.clamp(total / 9.0, 0.0, 1.0)
    one = torch.ones_like(shadow)
    shadow = torch.where(inside, shadow, one)
    on = torch.as_tensor(enabled, dtype=torch.bool, device=shadow.device)
    return torch.where(on, shadow, one)[..., None]


def shade_ground(albedo, light_space_pos, shadow_map, shadows_enabled,
                 receive_shadows=True):
    """shader/ground.glsl:118-125: albedo * 0.7 times the PCF factor."""
    shadow = pcf_shadow(light_space_pos, shadow_map,
                        torch.as_tensor(shadows_enabled)
                        & torch.as_tensor(receive_shadows))
    return albedo * 0.7 * shadow


def _ground_zref_plane(s, light_vp, bias):
    """zref(row, col) = z0 + zc*col + zr*row for the y=0 ground plane seen
    through the (affine, ortho) light VP, with `bias` folded into z0.
    Returns (z0, zc, zr) as 0-d tensors on light_vp's device."""
    m = light_vp  # affine: row 3 == (0,0,0,1)
    a, b_ = m[0, 0], m[0, 2]
    c, d = m[1, 0], m[1, 2]
    det = a * d - b_ * c
    det = torch.where(torch.abs(det) > 1e-12, det,
                      torch.full_like(det, 1e-12))
    i00, i01 = d / det, -b_ / det
    i10, i11 = -c / det, a / det
    du = 2.0 / s                      # d(x_ndc)/d(col)
    dv = -2.0 / s                     # d(y_ndc)/d(row)
    rx0 = (0.5 / s) * 2.0 - 1.0 - m[0, 3]
    ry0 = 1.0 - 2.0 * (0.5 / s) - m[1, 3]
    px0 = i00 * rx0 + i01 * ry0
    pz0 = i10 * rx0 + i11 * ry0
    z0 = m[2, 0] * px0 + m[2, 2] * pz0 + m[2, 3]
    zc = (m[2, 0] * i00 + m[2, 2] * i10) * du
    zr = (m[2, 0] * i01 + m[2, 2] * i11) * dv
    return z0 - bias, zc, zr


def ground_lit_map(shadow_map, light_vp, bias=0.001):
    """3x3 PCF evaluated in SHADOW space for the y=0 ground plane, for a
    shadow map [S,S] or a batch [B,S,S]: the reference depth of each texel's
    ground point is compared against its 3x3 neighbourhood. On the card this
    launches kernel K3 (ops/shadow_pcf.py) at every map size."""
    s = shadow_map.shape[-1]
    z0, zc, zr = _ground_zref_plane(s, light_vp, bias)
    return shadow_pcf.pcf_lit_map(shadow_map, z0, zc, zr)


def ground_shadow_lookup(light_space_pos, lit_map, enabled=True):
    """Single-tap lookup into `ground_lit_map` with the reference's bounds
    fallback (outside the frustum -> fully lit). Returns [...,1]; a batch
    of lit maps [I,S,S] is looked up at the same (camera-shared) positions
    -> [I,...,1]."""
    s = lit_map.shape[-1]
    w = light_space_pos[..., 3]
    wsafe = torch.where(torch.abs(w) > 1e-9, w, torch.ones_like(w))
    u = (light_space_pos[..., 0] / wsafe) * 0.5 + 0.5
    v = 1.0 - ((light_space_pos[..., 1] / wsafe) * 0.5 + 0.5)
    zref = light_space_pos[..., 2] / wsafe
    inside = ((u >= -0.001) & (u <= 1.001) & (v >= -0.001) & (v <= 1.001)
              & (zref >= 0.0) & (zref <= 1.001))
    px = torch.clamp((torch.clamp(u, 0.0, 1.0) * s).to(torch.int32), 0, s - 1)
    py = torch.clamp((torch.clamp(v, 0.0, 1.0) * s).to(torch.int32), 0, s - 1)
    lit = lit_map[..., py.long(), px.long()]
    lit = torch.where(inside, lit, torch.ones_like(lit))
    if not enabled:
        lit = torch.ones_like(lit)
    return lit[..., None]
