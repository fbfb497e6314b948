"""VMD camera and light tracks, sampled on the device.

Port of `simple_mmd_renderer_tpu/render/camera_anim.py`. The camera track
is the standard MMD orbit camera: `position` is the look-at target (MMD
units), `focal_length` the (negative) orbit distance, `rotation` the
orbit's euler angles, `fov` the vertical field of view in degrees, the
"perspective off" flag the orthographic camera, and per channel a Bezier
easing (6 channels x 4 control bytes: x, y, z, rotation, distance, fov).
The light track's keys carry no Bezier bytes; MMD lerps them.

`bind_camera` / `bind_light` pack a track into a small `nn.Module` whose
buffers live on a device (moved with the Scene by `.to()`);
`sample_camera` / `sample_light` take the frame as a tensor of any shape
(a crowd's [I] clocks give [I] samples) and run on its device with
`torch.searchsorted` and `torch.where`: nothing is read on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..formats.vmd import CameraTrack, LightTrack
from ..utils import bezier
from ..utils import math3d as m3
from ..utils.device import resolve_device


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _vec3(x, y, z, device):
    """A float32 [3] constant made by fills (a host value copied to the
    card would synchronise)."""
    v = torch.zeros(3, dtype=torch.float32, device=device)
    for i, c in enumerate((x, y, z)):
        if c:
            v[i].fill_(c)
    return v


class CameraArrays(nn.Module):
    """A camera track's keys as buffers: frames [K], targets [K,3],
    rotations [K,3] (euler), distances [K], fovs [K], ortho [K] (0/1) and
    the easing LUTs [K,6,32] (x, y, z, rotation, distance, fov)."""

    def __init__(self, frames, targets, rotations, distances, fovs, ortho,
                 luts, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        for name, value in (("frames", frames), ("targets", targets),
                            ("rotations", rotations),
                            ("distances", distances), ("fovs", fovs),
                            ("ortho", ortho), ("luts", luts)):
            self.register_buffer(name, _f32(value, device))


class LightArrays(nn.Module):
    """A light track's keys as buffers: frames [K], colors [K,3] and
    directions [K,3] (the direction the light travels)."""

    def __init__(self, frames, colors, directions, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        for name, value in (("frames", frames), ("colors", colors),
                            ("directions", directions)):
            self.register_buffer(name, _f32(value, device))


def bind_camera(track: CameraTrack, device="cuda") -> CameraArrays:
    k = len(track.frames)
    interp = track.interp.astype(np.float32).reshape(k, 24) / 127.0
    # channel c's control points are bytes [c*4 .. c*4+3] = (c0.x, c1.x,
    # c0.y, c1.y), the VMD camera section's byte order (MMD's default
    # curve, bytes (20, 107, 20, 107), presamples to the identity ramp)
    c = interp.reshape(k, 6, 4)
    lut, _ = bezier.presample(c[..., [0, 2]], c[..., [1, 3]])  # [K,6,32]
    return CameraArrays(track.frames, track.positions, track.rotations,
                        track.focal_lengths, track.fovs, track.orthographic,
                        lut, device=device)


def bind_light(track: LightTrack, device="cuda") -> LightArrays:
    return LightArrays(track.frames, track.colors, track.directions,
                       device=device)


def _bracket(frames, frame):
    """The keys around each frame of `frame` [N]: (left, right, fl, fr,
    use_left), left moved to the first (last) key before (after) the
    track, as the reference's `sample_camera` does."""
    k = frames.shape[0]
    pos = torch.searchsorted(frames, torch.floor(frame), right=True)
    right = torch.clamp(pos, 1, k - 1)
    left = right - 1
    fl, fr = frames[left], frames[right]
    before, after = frames[0] >= frame, frames[k - 1] <= frame
    use_left = before | after | (fl == frame)
    left = torch.where(before, torch.zeros_like(left), left)
    left = torch.where(after, torch.full_like(left, k - 1), left)
    return left, right, fl, fr, use_left


def sample_camera(cam: CameraArrays, frame):
    """-> dict(eye [...,3], target [...,3], fov_deg [...], ortho [...]
    bool) at `frame` (a tensor of any shape on the track's device; MMD
    units)."""
    frame = torch.as_tensor(frame, dtype=torch.float32,
                            device=cam.frames.device)
    shape = frame.shape
    frame = frame.reshape(-1)
    left, right, fl, fr, use_left = _bracket(cam.frames, frame)
    bary = (frame - fl) / torch.clamp(fr - fl, min=1.0)
    lam = bezier.lut_eval(cam.luts[left], bary[:, None])      # [N,6]

    def ch(vals, i):
        lo, hi = vals[left], vals[right]
        out = lo * (1.0 - lam[:, i]) + hi * lam[:, i]
        return torch.where(use_left, lo, out)

    target = torch.stack([ch(cam.targets[:, 0], 0),
                          ch(cam.targets[:, 1], 1),
                          ch(cam.targets[:, 2], 2)], -1)
    rot = torch.stack([ch(cam.rotations[:, 0], 3),
                       ch(cam.rotations[:, 1], 3),
                       ch(cam.rotations[:, 2], 3)], -1)
    dist = ch(cam.distances, 4)
    fov = ch(cam.fovs, 5)

    # orbit: eye = target + R(euler_yxz) @ (0, 0, distance); MMD's camera
    # rotation x is pitch (negated), y yaw, z roll
    dev = frame.device
    q = m3.euler_to_quat(rot * _vec3(-1.0, 1.0, 1.0, dev), "yxz")
    eye = target + m3.quat_rotate(q, _vec3(0.0, 0.0, 1.0, dev)
                                  * dist[:, None])
    return dict(eye=eye.reshape(shape + (3,)),
                target=target.reshape(shape + (3,)),
                fov_deg=fov.reshape(shape),
                ortho=(cam.ortho[left] > 0.5).reshape(shape))


def sample_light(light: LightArrays, frame):
    """-> dict(color [...,3], direction [...,3]) linearly interpolated at
    `frame` (a tensor of any shape on the track's device); a direction of
    norm 1e-6 or less falls back to (0, -1, 0)."""
    frame = torch.as_tensor(frame, dtype=torch.float32,
                            device=light.frames.device)
    shape = frame.shape
    frame = frame.reshape(-1)
    left, right, fl, fr, use_left = _bracket(light.frames, frame)
    t = torch.clamp((frame - fl) / torch.clamp(fr - fl, min=1.0), 0.0,
                    1.0)[:, None]

    def ch(vals):
        lo, hi = vals[left], vals[right]
        return torch.where(use_left[:, None], lo, lo * (1.0 - t) + hi * t)

    direction = ch(light.directions)
    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    direction = torch.where(norm > 1e-6,
                            direction / torch.clamp(norm, min=1e-6),
                            _vec3(0.0, -1.0, 0.0, frame.device))
    return dict(color=ch(light.colors).reshape(shape + (3,)),
                direction=direction.reshape(shape + (3,)))
