"""Motion binding + keyframe sampling.

Port of `simple_mmd_renderer_tpu/core/anim.py`. `bind_motion` is the
reference's NumPy build code, copied; it packs every bound track's keys into
flat arrays sorted by (track, frame).
`MotionTables` holds them on the device, and `sample_bones` /
`sample_morphs` bracket all tracks at once with one `searchsorted` over the
fused int32 key, with the reference's clamp rules: frame <= first key ->
first key, frame >= last key -> last key, exact hit -> left key, otherwise
a Bezier-eased lerp (translation) and NLerp (rotation).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..formats.vmd import VmdMotion
from ..utils import bezier
from ..utils import math3d as m3
from ..utils.device import resolve_device
from .model import ModelStatic, register_arrays

_FRAME_BITS = 18
_FRAME_SPAN = 1 << _FRAME_BITS  # supports motions up to ~2.4h at 30fps
_MAX_TRACKS = (1 << 30) // _FRAME_SPAN


@dataclass
class MotionArrays:
    # bone tracks (K total keys over T tracks)
    b_key: np.ndarray     # [K] int32 fused (track << 18 | frame), ascending
    b_frame: np.ndarray   # [K] int32
    b_trans: np.ndarray   # [K,3] f32
    b_quat: np.ndarray    # [K,4] f32
    b_lut: np.ndarray     # [K,4,32] f32 easing LUTs (x,y,z,r)
    b_off: np.ndarray     # [T+1] int32 track key offsets
    b_bone: np.ndarray    # [T] int32 target bone index
    # morph tracks
    m_key: np.ndarray     # [Km] int32
    m_frame: np.ndarray   # [Km] int32
    m_weight: np.ndarray  # [Km] f32
    m_lut: np.ndarray     # [Km,32] f32
    m_off: np.ndarray     # [Tm+1] int32
    m_morph: np.ndarray   # [Tm] int32
    n_bones: int
    n_morphs: int
    length: int


def bind_motion(static: ModelStatic, motion: VmdMotion) -> MotionArrays:
    """Intersect motion track names with model bone/morph names (MotionPlayer
    ctor) and pack the key arrays."""
    bone_ids = {}
    for i, name in enumerate(static.bone_names):
        bone_ids.setdefault(name, i)  # first bone wins on duplicate names
    morph_ids = {}
    for i, name in enumerate(static.morph_names):
        morph_ids.setdefault(name, i)

    b_frames, b_trans, b_quat, b_lut, b_bone = [], [], [], [], []
    for name, track in motion.bone_tracks.items():
        if name not in bone_ids or track.frames.size == 0:
            continue
        b_bone.append(bone_ids[name])
        b_frames.append(track.frames.astype(np.int32))
        b_trans.append(track.translations)
        b_quat.append(track.rotations)
        lut, _ = bezier.presample(track.c0, track.c1)  # [K,4,32]
        b_lut.append(lut)

    m_frames, m_weight, m_lut, m_morph = [], [], [], []
    for name, track in motion.morph_tracks.items():
        if name not in morph_ids or track.frames.size == 0:
            continue
        m_morph.append(morph_ids[name])
        m_frames.append(track.frames.astype(np.int32))
        m_weight.append(track.weights)
        lut, _ = bezier.presample(track.c0, track.c1)  # [K,32]
        m_lut.append(lut)

    if len(b_bone) >= _MAX_TRACKS or len(m_morph) >= _MAX_TRACKS:
        raise ValueError("too many motion tracks for fused int32 keys")

    def pack(frames_list, track_count):
        if track_count == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(1, np.int32))
        counts = np.array([len(f) for f in frames_list], np.int32)
        off = np.zeros(track_count + 1, np.int32)
        np.cumsum(counts, out=off[1:])
        frames = np.concatenate(frames_list).astype(np.int32)
        track_of = np.repeat(np.arange(track_count, dtype=np.int32), counts)
        key = (track_of << _FRAME_BITS) | np.minimum(frames, _FRAME_SPAN - 1)
        return key, frames, off

    bk, bf, boff = pack(b_frames, len(b_bone))
    mk, mf, moff = pack(m_frames, len(m_morph))

    j = np.asarray
    return MotionArrays(
        b_key=j(bk), b_frame=j(bf),
        b_trans=j(np.concatenate(b_trans) if b_trans
                  else np.zeros((0, 3), np.float32)),
        b_quat=j(np.concatenate(b_quat) if b_quat
                 else np.zeros((0, 4), np.float32)),
        b_lut=j(np.concatenate(b_lut) if b_lut
                else np.zeros((0, 4, 32), np.float32)),
        b_off=j(boff), b_bone=j(np.asarray(b_bone, np.int32)),
        m_key=j(mk), m_frame=j(mf),
        m_weight=j(np.concatenate(m_weight) if m_weight
                   else np.zeros(0, np.float32)),
        m_lut=j(np.concatenate(m_lut) if m_lut
                else np.zeros((0, 32), np.float32)),
        m_off=j(moff), m_morph=j(np.asarray(m_morph, np.int32)),
        n_bones=static.n_bones, n_morphs=static.n_morphs,
        length=motion.length,
    )


class MotionTables(nn.Module):
    """Device tables of a MotionArrays (keys as int64, values float32)."""

    ARRAYS = ("b_key", "b_frame", "b_trans", "b_quat", "b_lut", "b_off",
              "b_bone", "m_key", "m_frame", "m_weight", "m_lut", "m_off",
              "m_morph")

    def __init__(self, mo: MotionArrays, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.host = mo
        self.n_bones = mo.n_bones
        self.n_morphs = mo.n_morphs
        register_arrays(self, mo, self.ARRAYS, device)


def _bracket(key, frame_arr, off, frame):
    """For every track: (left_idx, right_idx, use_left_only), each [T]; a
    vector of frames arrives as [I, 1] and gives [I, T]."""
    t = torch.arange(off.shape[0] - 1, device=key.device)
    k0 = off[:-1]
    kn = off[1:]
    iframe = torch.floor(frame).to(torch.int64)
    fused = (t << _FRAME_BITS) | torch.clamp(iframe, 0, _FRAME_SPAN - 1)
    pos = torch.searchsorted(key, fused, right=True)

    first_f = frame_arr[k0]
    last_f = frame_arr[torch.clamp(kn - 1, min=0)]
    right = torch.minimum(torch.maximum(pos, k0 + 1), kn - 1)
    left = right - 1

    before = first_f.to(torch.float32) >= frame
    after = last_f.to(torch.float32) <= frame
    exact = frame_arr[left].to(torch.float32) == frame

    left = torch.where(before, k0, torch.where(after, kn - 1, left))
    use_left = before | after | exact
    return left, right, use_left


def sample_bones(mo: MotionTables, frame):
    """-> (anim_rot [B,4], anim_trans [B,3]) for all model bones (identity
    for unbound bones), at the (0-d tensor) `frame`; a vector of frames [I]
    (a crowd's staggered clocks) gives [I,B,4] and [I,B,3]."""
    dev = mo.b_key.device
    frame = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    lead = frame.shape
    anim_rot = m3.quat_identity(lead + (mo.n_bones,), device=dev)
    anim_trans = torch.zeros(lead + (mo.n_bones, 3), dtype=torch.float32,
                             device=dev)
    if mo.b_bone.shape[0] == 0:
        return anim_rot, anim_trans

    frame = frame[..., None]                        # against the track axis
    left, right, use_left = _bracket(mo.b_key, mo.b_frame, mo.b_off, frame)
    fl = mo.b_frame[left].to(torch.float32)
    fr = mo.b_frame[right].to(torch.float32)
    bary = (frame - fl) / torch.clamp(fr - fl, min=1.0)

    lut = mo.b_lut[left]                            # [T,4,32]
    lam = bezier.lut_eval(lut, bary[..., None])     # [T,4]

    tl, tr = mo.b_trans[left], mo.b_trans[right]
    trans = tl * (1.0 - lam[..., :3]) + tr * lam[..., :3]
    rot = m3.quat_nlerp(mo.b_quat[left], mo.b_quat[right], lam[..., 3])

    trans = torch.where(use_left[..., None], tl, trans)
    rot = torch.where(use_left[..., None], mo.b_quat[left], rot)

    anim_rot[..., mo.b_bone, :] = rot
    anim_trans[..., mo.b_bone, :] = trans
    return anim_rot, anim_trans


def sample_morphs(mo: MotionTables, frame):
    """-> morph_rates [M] (zero for unbound morphs); [I,M] for frames [I]."""
    dev = mo.b_key.device
    frame = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    rates = torch.zeros(frame.shape + (mo.n_morphs,), dtype=torch.float32,
                        device=dev)
    if mo.m_morph.shape[0] == 0:
        return rates
    frame = frame[..., None]
    left, right, use_left = _bracket(mo.m_key, mo.m_frame, mo.m_off, frame)
    fl = mo.m_frame[left].to(torch.float32)
    fr = mo.m_frame[right].to(torch.float32)
    bary = (frame - fl) / torch.clamp(fr - fl, min=1.0)
    lam = bezier.lut_eval(mo.m_lut[left], bary)
    wl, wr = mo.m_weight[left], mo.m_weight[right]
    w = torch.where(use_left, wl, wl * (1.0 - lam) + wr * lam)
    rates[..., mo.m_morph] = w
    return rates


def sample_motion(mo: MotionTables, frame):
    anim_rot, anim_trans = sample_bones(mo, frame)
    return anim_rot, anim_trans, sample_morphs(mo, frame)
