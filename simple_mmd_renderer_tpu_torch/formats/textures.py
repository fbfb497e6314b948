"""Texture loading with the reference's multi-location path resolution.

`LoadTexture` (`main.cpp:394-555`): try the path as given, relative to the
model directory, in a `tex/` subdirectory, relative to cwd, then a
case-insensitive directory scan; fall back to a white 1x1 texture on any
failure (`main.cpp:486-513`, `1370-1387`). Decoding uses Pillow, imported
only when a file is decoded (a machine without Pillow gets the white
fallback).

The port's own copy of `simple_mmd_renderer_tpu/formats/textures.py`: the
diffuse-texture loaders, `sample_bilinear` on tensors, and the MMD toon
ramps and sphere maps (`default_toon_ramp`, `load_toon_ramps`,
`load_sphere_maps`), host NumPy built on `load_texture` and `WHITE_1X1`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

WHITE_1X1 = np.ones((1, 1, 3), np.float32)


def _find_case_insensitive(directory: str, filename: str) -> str | None:
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    low = filename.lower()
    for e in entries:
        if e.lower() == low:
            return os.path.join(directory, e)
    return None


def resolve_texture_path(tex_path: str, model_dir: str) -> str | None:
    tex_path = tex_path.replace("\\", "/")
    candidates = [
        tex_path,
        os.path.join(model_dir, tex_path),
        os.path.join(model_dir, "tex", os.path.basename(tex_path)),
        os.path.join(os.getcwd(), tex_path),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    # case-insensitive scan in the model dir (reference: FindFileCaseInsensitive)
    sub = os.path.dirname(tex_path)
    base = os.path.basename(tex_path)
    for d in (os.path.join(model_dir, sub) if sub else model_dir, model_dir):
        hit = _find_case_insensitive(d, base)
        if hit:
            return hit
    return None


def load_texture(tex_path: str, model_dir: str = ".") -> np.ndarray:
    """-> float32 [H,W,3] in [0,1]; white 1x1 fallback on failure."""
    path = resolve_texture_path(tex_path, model_dir)
    if path is None:
        return WHITE_1X1
    try:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
        return arr
    except Exception:
        return WHITE_1X1


def load_material_textures(static, model_dir: str = ".") -> list[np.ndarray]:
    """Per-part diffuse textures (LoadMaterialTextures, main.cpp:581-647):
    white fallback for parts without a texture."""
    cache: dict[int, np.ndarray] = {}
    out = []
    for ti in static.part_tex:
        ti = int(ti)
        if ti < 0 or ti >= len(static.textures):
            out.append(WHITE_1X1)
            continue
        if ti not in cache:
            cache[ti] = load_texture(static.textures[ti], model_dir)
        out.append(cache[ti])
    return out


def sample_bilinear(texture, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, repeat-wrapped texture sample. texture: [H,W,3] (NumPy or
    a tensor); uv: [...,2] (v down, like PMX/GL texture coords as
    uploaded). The wrap is a floor-mod, so negative texel indices wrap
    from the far edge."""
    tex = torch.as_tensor(texture, dtype=torch.float32, device=uv.device)
    h, w = tex.shape[0], tex.shape[1]
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    c00 = tex[torch.remainder(y0, h), torch.remainder(x0, w)]
    c10 = tex[torch.remainder(y0, h), torch.remainder(x0 + 1, w)]
    c01 = tex[torch.remainder(y0 + 1, h), torch.remainder(x0, w)]
    c11 = tex[torch.remainder(y0 + 1, h), torch.remainder(x0 + 1, w)]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


# ---------------------------------------------------------------------------
# MMD extended shading maps (beyond the original app: it parses sphere and
# toon references but its shader samples only the diffuse texture)
# ---------------------------------------------------------------------------

SPHERE_OFF, SPHERE_MUL, SPHERE_ADD, SPHERE_SUB_TEX = 0, 1, 2, 3


def default_toon_ramp(k: int = 32) -> np.ndarray:
    """Procedural stand-in for the global toonXX.bmp ramps (not shipped):
    the classic MMD look, full-lit above the terminator and a soft
    cool-tinted shadow band below. [K,3] float32, row 0 = fully lit."""
    t = np.linspace(0.0, 1.0, k, dtype=np.float32)[:, None]
    lit = np.array([1.0, 1.0, 1.0], np.float32)
    shade = np.array([0.82, 0.80, 0.88], np.float32)
    w = 1.0 / (1.0 + np.exp(-(t - 0.55) * 24.0))     # soft step at 0.55
    return (lit * (1 - w) + shade * w).astype(np.float32)


def load_toon_ramps(static, model_dir: str = ".", k: int = 32) -> np.ndarray:
    """[P, K, 3] per-part toon ramps indexed by the shading coordinate
    v = 0.5 - 0.5*dot(N, L) (0 = facing the light). Model-local toon
    textures are resolved and sampled down their centre column; global
    toonXX references (and failures) use the procedural default ramp."""
    ramps = []
    for mt in static.materials:
        ramp = np.ones((k, 3), np.float32)
        if mt.toon >= 0:
            ramp = default_toon_ramp(k)
            if not mt.toon_is_global and 0 <= mt.toon < len(static.textures):
                tex = load_texture(static.textures[mt.toon], model_dir)
                if tex.shape[0] > 1 or tex.shape[1] > 1:
                    col = tex[:, tex.shape[1] // 2, :]       # centre column
                    idx = np.clip((np.arange(k) * (len(col) - 1)
                                   / max(k - 1, 1)).round().astype(int),
                                  0, len(col) - 1)
                    ramp = col[idx].astype(np.float32)
        ramps.append(ramp)
    return (np.stack(ramps) if ramps else np.ones((0, k, 3), np.float32))


def load_sphere_maps(static, model_dir: str = "."):
    """-> (textures: list [P] of [h,w,3] arrays, modes [P] i32).

    Per-part environment sphere maps (the material's sub-texture with type
    SPH = multiply or SPA = add), sampled at view-space-normal UVs. Missing
    or OFF/sub-texture-typed entries get a neutral map (white, mode 0 =
    inactive); a 1x1 fallback of an SPA map is black."""
    texs, modes = [], []
    for mt in static.materials:
        mode = int(mt.sub_texture_type)
        if mode in (SPHERE_MUL, SPHERE_ADD) and \
                0 <= mt.sub_texture < len(static.textures):
            tex = load_texture(static.textures[mt.sub_texture], model_dir)
            if tex.shape[0] == 1 and tex.shape[1] == 1 \
                    and mode == SPHERE_ADD:
                tex = np.zeros((1, 1, 3), np.float32)
            texs.append(tex)
            modes.append(mode)
        else:
            texs.append(WHITE_1X1)
            modes.append(SPHERE_OFF)
    return texs, np.asarray(modes, np.int32)
