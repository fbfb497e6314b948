"""Image-based lighting: equirectangular HDR -> cubemap, and the skybox.

Port of `simple_mmd_renderer_tpu/render/ibl.py` on tensors of the caller's
device. It rebuilds the original app's `LoadHDRAndCreateCubemap` /
`EquirectUVToDir` (`main.cpp:1019-1185`) as whole-tensor operations and the
skybox fragment program (`shader/ibl.glsl`): a cube sample and the ACES
filmic tonemap. The face order, the per-face direction mapping, the
write-time y flip and nearest-texel sampling with truncation to int32 are
the reference's.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device

_PI = 3.14159265359


def _as_f32(x, device=None):
    """A tensor on its own device, or an array on `device` (None: the
    card), as float32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(
        device))


def equirect_to_cubemap(equirect, size=512, device=None):
    """equirect [H,W,3+] (a tensor, or an array put on `device`) ->
    [6,size,size,3] cubemap on the same device.

    Face order and direction mapping per main.cpp:1093-1117, nearest
    sampling per main.cpp:1136-1142, rows y-flipped per
    main.cpp:1144-1147."""
    equirect = _as_f32(equirect, device)
    dev = equirect.device
    h, w = equirect.shape[:2]
    uv = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) \
        / size * 2.0 - 1.0
    u = uv[None, :].expand(size, size)
    v = uv[:, None].expand(size, size)
    one = torch.ones_like(u)
    dirs = torch.stack([
        torch.stack([-one, v, -u], -1),   # +X (main.cpp:1096)
        torch.stack([one, v, u], -1),     # -X
        torch.stack([-u, one, -v], -1),   # +Y
        torch.stack([-u, -one, v], -1),   # -Y
        torch.stack([-u, v, one], -1),    # +Z
        torch.stack([u, v, -one], -1),    # -Z
    ])                                    # [6,S,S,3]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)

    theta = torch.atan2(dirs[..., 2], dirs[..., 0])
    phi = torch.acos(torch.clamp(dirs[..., 1], -1.0, 1.0))
    eu = torch.clamp(theta / (2.0 * _PI) + 0.5, 0.0, 1.0)
    ev = torch.clamp(phi / _PI, 0.0, 1.0)
    sx = torch.clamp((eu * w).to(torch.int32), max=w - 1).long()
    sy = torch.clamp((ev * h).to(torch.int32), max=h - 1).long()
    sampled = equirect[sy, sx, :3]        # [6,S,S,3]
    return sampled.flip(1).contiguous()   # y flip at write


def sample_cubemap(cubemap, dirs):
    """Cube lookup, the exact inverse of `equirect_to_cubemap`'s storage
    mapping, so `sample(convert(E), d) == E(d)` (the original app stores
    its "+X" face looking down -X, main.cpp:1095-1097; inverting the actual
    storage shows the environment unmirrored). cubemap [6,S,S,3], dirs
    [...,3] -> [...,3]: nearest texel, one row gather."""
    s = cubemap.shape[1]
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    m = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                    min=1e-12)
    dx, dy, dz = x / m, y / m, z / m

    # storage equations (main.cpp:1093-1117): face f holds direction d(f,u,v)
    #  f0: (-1, v, -u)  f1: (1, v, u)  f2: (-u, 1, -v)
    #  f3: (-u, -1, v)  f4: (-u, v, 1) f5: (u, v, -1)
    face = torch.where(
        is_x, torch.where(dx < 0, 0, 1),
        torch.where(is_y, torch.where(dy > 0, 2, 3),
                    torch.where(dz > 0, 4, 5)))
    zero = torch.zeros_like(dx)
    u = (torch.where(face == 0, -dz, zero) + torch.where(face == 1, dz, zero)
         + torch.where((face == 2) | (face == 3) | (face == 4), -dx, zero)
         + torch.where(face == 5, dx, zero))
    v = (torch.where(face == 2, -dz, zero) + torch.where(face == 3, dz, zero)
         + torch.where((face == 0) | (face == 1) | (face == 4) | (face == 5),
                       dy, zero))

    px = torch.clamp(((u * 0.5 + 0.5) * s).to(torch.int32), 0, s - 1)
    py = torch.clamp(((v * 0.5 + 0.5) * s).to(torch.int32), 0, s - 1)
    # rows were y-flipped at write time
    idx = (face.long() * s + (s - 1 - py).long()) * s + px.long()
    flat = cubemap.reshape(-1, cubemap.shape[-1])
    return torch.index_select(flat, 0, idx.reshape(-1)).reshape(
        idx.shape + flat.shape[1:])


def aces_tonemap(x):
    """ACES filmic approximation (ibl.glsl:33-41)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def skybox_colors(cubemap, view, proj, width, height):
    """Per-pixel skybox [H,W,3]: ray directions from the inverse of proj @
    view-without-translation (the original app draws a cube with the
    translation-free view, main.cpp:2064-2089), a cube sample and ACES.
    The inverse is `inv_ex`'s (fp32, no host synchronisation on the card)
    where the reference calls `jnp.linalg.inv`."""
    dev = view.device
    v = view.clone()
    v[:3, 3] = 0.0
    inv = torch.linalg.inv_ex(proj @ v).inverse
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev)
                + 0.5) / height * 2.0
    ndc_x = xs[None, :].expand(height, width)
    ndc_y = ys[:, None].expand(height, width)
    near = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, 0.5),
                        torch.ones_like(ndc_x)], -1)
    world = near @ inv.T
    w = world[..., 3:4]
    dirs = world[..., :3] / torch.where(torch.abs(w) > 1e-12, w,
                                        torch.ones_like(w))
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    return aces_tonemap(sample_cubemap(cubemap, dirs))
