"""Camera/projection math (HandmadeMath's RH_ZO helpers): right-handed view
space, zero-to-one clip depth, column-vector convention.

Port of `simple_mmd_renderer_tpu/render/camera.py`. Scalars may be Python
numbers or 0-d tensors; matrices are float32 on `device`, built by fills
and device copies (a host scalar assigned into a device tensor would be
copied from the host and synchronise).
"""

from __future__ import annotations

import math

import torch


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _put(m, idx, value):
    """m[idx] = value: a device copy for a tensor, a fill for a number."""
    if isinstance(value, torch.Tensor):
        m[idx] = value
    else:
        m[idx].fill_(value)


def perspective(fov_y_rad, aspect, near, far, device=None):
    """HMM_Perspective_RH_ZO."""
    f = 1.0 / torch.tan(_f32(fov_y_rad, device) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    _put(m, (0, 0), f / aspect)
    _put(m, (1, 1), f)
    _put(m, (2, 2), far / (near - far))
    _put(m, (2, 3), near * far / (near - far))
    _put(m, (3, 2), -1.0)
    return m


def orthographic(left, right, bottom, top, near, far, device=None):
    """HMM_Orthographic_RH_ZO."""
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    _put(m, (0, 0), 2.0 / (right - left))
    _put(m, (1, 1), 2.0 / (top - bottom))
    _put(m, (2, 2), 1.0 / (near - far))
    _put(m, (0, 3), (left + right) / (left - right))
    _put(m, (1, 3), (bottom + top) / (bottom - top))
    _put(m, (2, 3), near / (near - far))
    _put(m, (3, 3), 1.0)
    return m


def look_at(eye, target, up, device=None):
    """HMM_LookAt_RH."""
    eye = _f32(eye, device)
    target = _f32(target, device)
    up = _f32(up, device)
    f = target - eye
    f = f / torch.clamp(torch.linalg.vector_norm(f), min=1e-12)
    s = torch.linalg.cross(f, up)
    s = s / torch.clamp(torch.linalg.vector_norm(s), min=1e-12)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -torch.dot(s, eye)
    m[1, 3] = -torch.dot(u, eye)
    m[2, 3] = torch.dot(f, eye)
    return m


def orbit_camera(target, distance, rotation_x, rotation_y, device=None):
    """The app's orbit camera: offset from `target` by spherical angles;
    `distance` is negative (the camera behind the target)."""
    target = _f32(target, device)
    rx = _f32(rotation_x, target.device)
    ry = _f32(rotation_y, target.device)
    cos_y, sin_y = torch.cos(ry), torch.sin(ry)
    cos_x, sin_x = torch.cos(rx), torch.sin(rx)
    offset = distance * torch.stack([cos_y * sin_x, sin_y, cos_y * cos_x])
    return target + offset


def directional_light_view(light_dir, device=None):
    """The shadow pass light frame: light placed 50 m against its direction,
    looking at the origin, with the robust up-vector chain."""
    d = _f32(light_dir, device)
    d = d / torch.clamp(torch.linalg.vector_norm(d), min=1e-6)
    world_up = torch.zeros(3, dtype=torch.float32, device=d.device)
    world_up[1].fill_(1.0)
    alt_up = torch.zeros(3, dtype=torch.float32, device=d.device)
    alt_up[2].fill_(1.0)
    right = torch.linalg.cross(d, world_up)
    use_alt = torch.linalg.vector_norm(right) < 1e-3
    right = torch.where(use_alt, torch.linalg.cross(d, alt_up), right)
    right = right / torch.clamp(torch.linalg.vector_norm(right), min=1e-6)
    up = torch.linalg.cross(right, d)
    up = up / torch.clamp(torch.linalg.vector_norm(up), min=1e-6)
    pos = -50.0 * d
    return look_at(pos, torch.zeros(3, dtype=torch.float32, device=d.device),
                   up)


def deg2rad(x, device=None):
    """Degrees -> radians in float32 (jnp.deg2rad rounds the same way)."""
    return _f32(x, device) * (math.pi / 180.0)
