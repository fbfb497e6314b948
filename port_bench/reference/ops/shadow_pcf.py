"""Shadow-space 3x3 PCF lit map (kernel K3).

`render.shade.ground_lit_map` evaluates, for every shadow-map texel, the
ground plane's reference depth zref(row, col) = z0 + zc*col + zr*row (affine
for the ortho light, bias folded into z0) and averages the 3x3 depth
comparison with edge-clamped taps.

`pcf_lit_map(shadow_map, z0, zc, zr)` is the dispatcher, called as the
reference's is: a CPU tensor runs `pcf_lit_map_plain`, a CUDA tensor
launches the hand-written kernel in `csrc/shadow_pcf.cu` (which replaces
the reference's Pallas `_pcf_kernel`). Both give the same bits. The plane
is shared by every map of a batch, or given per map: z0, zc and zr are
each a Python float, a 0-d tensor or a tensor of `shadow_map.shape[:-2]`
(the counterpart of `jax.vmap(pcf_lit_map)` over batched planes, the
reference's `_pcf_lit_map_vmap`). `pcf_lit_map_tiled` is the same
function: the reference's launcher of the same name asserts S % 128 == 0,
a TPU tile constraint that the card's kernel does not have.
"""

from __future__ import annotations

import math

import torch




def _planes(shadow_map, z0, zc, zr):
    """The plane as three f32 tensors on the map's device, all 0-d (a
    shared plane: nothing is copied or launched when they are 0-d f32
    tensors there already, as `shade.ground_lit_map` gives them) or all
    [B] (per-map planes, B the number of maps; a scalar among them is
    expanded). No value is read on the host."""
    lead = tuple(shadow_map.shape[:-2])
    dev = shadow_map.device
    vals = [v if (isinstance(v, torch.Tensor) and v.dtype == torch.float32
                  and v.device == dev)
            else torch.as_tensor(v, dtype=torch.float32, device=dev)
            for v in (z0, zc, zr)]
    for name, v in zip(("z0", "zc", "zr"), vals):
        if v.dim() and tuple(v.shape) != lead:
            raise ValueError(f"pcf_lit_map: {name} must be a scalar or of "
                             f"shape {lead} (the maps' batch), got "
                             f"{tuple(v.shape)}")
    if all(v.dim() == 0 for v in vals):
        return vals
    b = math.prod(lead)
    return [v.expand(lead).reshape(b).contiguous() for v in vals]


def pcf_lit_map_plain(shadow_map, z0, zc, zr):
    """Plain PyTorch PCF lit map. shadow_map: [..., S, S] f32; z0, zc, zr:
    the plane, shared or per map (see the module). Returns [..., S, S] in
    [0, 1]."""
    s = shadow_map.shape[-1]
    dev = shadow_map.device
    z0, zc, zr = (v.reshape(-1, 1, 1) for v in _planes(shadow_map, z0, zc,
                                                        zr))
    col = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    row = torch.arange(s, dtype=torch.float32, device=dev)[:, None]
    zref = z0 + zc * col + zr * row
    maps = shadow_map.reshape((-1, s, s))
    # edge pre-pad (replicate) == the kernel's clamped tap indices
    idx = torch.clamp(torch.arange(-1, s + 1, device=dev), 0, s - 1)
    pad = maps[:, idx][:, :, idx]
    total = torch.zeros_like(maps)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            total = total + (zref < pad[:, dy:dy + s, dx:dx + s]).to(
                torch.float32)
    lit = torch.clamp(total * (1.0 / 9.0), 0.0, 1.0)
    return lit.reshape(shadow_map.shape)




def pcf_lit_map(shadow_map, z0, zc, zr):
    """3x3 PCF lit map from shadow map(s) [..., S, S] and the reference-depth
    plane zref(row, col) = z0 + zc*col + zr*row (bias already folded into
    z0), shared or per map: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    return pcf_lit_map_plain(shadow_map, z0, zc, zr)


def pcf_lit_map_tiled(shadow_map, z0, zc, zr):
    """`pcf_lit_map` under the reference's launcher's name. The reference
    requires S % 128 == 0 here (its TPU tiles); the card's kernel takes any
    S, so the port does not."""
    return pcf_lit_map(shadow_map, z0, zc, zr)
