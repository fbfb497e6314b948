"""VMD motion parser ("Vocaloid Motion Data 0002").

Rebuild of libmmd's VmdReader (`reader/vmd_reader_impl.inl:9-108`,
`reader/interprete/vmd_types.inl:17-59`): bone keyframes (ShiftJIS 15-byte
names, frame, vec3 translation, xyzw quaternion, 4 x 16-byte interpolator
blocks with control points at byte offsets 0/4/8/12 scaled by 1/127), morph
keyframes, and the camera track that follows. Record layout is fixed-size so
parsing is bulk NumPy.

The port's own copy of `simple_mmd_renderer_tpu/formats/vmd.py`."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.io import ParseError, decode_shift_jis

MAGIC = b"Vocaloid Motion Data 0002"

_BONE_DT = np.dtype([
    ("name", "S15"),
    ("frame", "<u4"),
    ("translation", "<f4", 3),
    ("rotation", "<f4", 4),
    ("x_interp", "i1", 16),
    ("y_interp", "i1", 16),
    ("z_interp", "i1", 16),
    ("r_interp", "i1", 16),
])

_MORPH_DT = np.dtype([
    ("name", "S15"),
    ("frame", "<u4"),
    ("weight", "<f4"),
])

_CAMERA_DT = np.dtype([
    ("frame", "<u4"),
    ("focal_length", "<f4"),
    ("position", "<f4", 3),
    ("rotation", "<f4", 3),
    ("interp", "i1", 24),
    ("fov", "<f4"),
    ("orthographic", "u1"),
])

_LIGHT_DT = np.dtype([
    ("frame", "<u4"),
    ("color", "<f4", 3),
    ("direction", "<f4", 3),
])


@dataclass
class BoneTrack:
    """Sorted keyframes for one bone name."""
    frames: np.ndarray        # [K] int64, ascending
    translations: np.ndarray  # [K,3] f32
    rotations: np.ndarray     # [K,4] f32 (x,y,z,w)
    # control points per channel (x,y,z,r): c0/c1 in [0,1] after /127
    c0: np.ndarray            # [K,4,2] f32
    c1: np.ndarray            # [K,4,2] f32


@dataclass
class MorphTrack:
    frames: np.ndarray   # [K]
    weights: np.ndarray  # [K]
    c0: np.ndarray       # [K,2] — VMD morph keys are linear; kept for parity
    c1: np.ndarray       # [K,2]


@dataclass
class CameraTrack:
    frames: np.ndarray         # [K]
    focal_lengths: np.ndarray  # [K]
    positions: np.ndarray      # [K,3]
    rotations: np.ndarray      # [K,3]
    fovs: np.ndarray           # [K]
    orthographic: np.ndarray   # [K] bool
    interp: np.ndarray         # [K,24] i8 raw


@dataclass
class LightTrack:
    """VMD directional-light keyframes (section after the camera track).

    The reference declares `LightMotionReader` but never implements it
    (`reader/light_motion_reader.inl:14-16` is an empty interface with the
    one virtual commented out); this completes that declared capability.
    MMD interpolates light keys linearly (the records carry no Bezier
    bytes)."""
    frames: np.ndarray      # [K] int64, ascending
    colors: np.ndarray      # [K,3] f32 rgb
    directions: np.ndarray  # [K,3] f32 (direction the light travels)


@dataclass
class VmdMotion:
    name: str = ""
    bone_tracks: dict[str, BoneTrack] = field(default_factory=dict)
    morph_tracks: dict[str, MorphTrack] = field(default_factory=dict)
    camera: CameraTrack | None = None
    light: LightTrack | None = None

    @property
    def length(self) -> int:
        last = 0
        for t in self.bone_tracks.values():
            if t.frames.size:
                last = max(last, int(t.frames[-1]))
        for t in self.morph_tracks.values():
            if t.frames.size:
                last = max(last, int(t.frames[-1]))
        return last


def _group_sorted(names_raw, recs):
    """Group structured records by bone/morph NAME; yields (str_name, rows
    sorted by frame).

    Names canonicalize to their pre-NUL prefix before grouping: real
    exporters leave uninitialized junk bytes after the terminator in the
    fixed 15-byte field (numpy S-strings strip only TRAILING nulls, so two
    records of the same bone can carry different raw bytes), while the
    reference keys its maps on the NUL-truncated ShiftJIS string
    (`util/dwarf_impl.inl:216-229`). Without this, a junk-bearing track
    splits into one group per record and all but the last are dropped."""
    if len(recs) == 0:
        return
    width = names_raw.dtype.itemsize
    a = np.frombuffer(names_raw.tobytes(), np.uint8).reshape(-1, width).copy()
    a[np.cumsum(a == 0, axis=1) > 0] = 0    # zero at/after the first NUL
    canon = a.reshape(-1).view(f"S{width}")
    order = np.argsort(canon, kind="stable")
    recs = recs[order]
    names_sorted = canon[order]
    bounds = np.flatnonzero(
        np.concatenate([[True], names_sorted[1:] != names_sorted[:-1]]))
    bounds = np.append(bounds, len(recs))
    for i in range(len(bounds) - 1):
        rows = recs[bounds[i]:bounds[i + 1]]
        rows = rows[np.argsort(rows["frame"], kind="stable")]
        yield decode_shift_jis(names_sorted[bounds[i]].tobytes()), rows


def _read_u32(data: bytes, pos: int, field: str) -> int:
    if pos + 4 > len(data):
        raise ParseError("truncated: need 4 bytes for count", pos, field)
    return int(np.frombuffer(data, "<u4", 1, pos)[0])


def _read_records(data: bytes, dt: np.dtype, count: int, pos: int,
                  field: str) -> np.ndarray:
    """Bounds-checked bulk record read — a forged count raises ParseError
    instead of numpy's untyped ValueError (or a giant allocation)."""
    if pos + dt.itemsize * count > len(data):
        raise ParseError(
            f"truncated: need {dt.itemsize * count} bytes for {count} "
            f"records, {len(data) - pos} left", pos, field)
    return np.frombuffer(data, dt, count, pos)


def parse_vmd(data: bytes) -> VmdMotion:
    """Parse VMD bytes. Mandatory sections (header, bone, morph) raise
    utils.io.ParseError on truncation/forged counts; the optional
    camera/light tails degrade to "keep what parsed" like the reference's
    reader, which stops wherever the stream ends
    (`reader/vmd_reader_impl.inl:9-108`)."""
    if data[:25] != MAGIC:
        raise ParseError("not a VMD file", 0, "magic")
    motion = VmdMotion()
    motion.name = decode_shift_jis(data[30:50])
    pos = 50

    n_bone = _read_u32(data, pos, "bone keyframe count"); pos += 4
    bone_recs = _read_records(data, _BONE_DT, n_bone, pos, "bone keyframes")
    pos += _BONE_DT.itemsize * n_bone

    inv127 = np.float32(1.0 / 127.0)
    for name, rows in _group_sorted(bone_recs["name"], bone_recs):
        interp = np.stack(
            [rows["x_interp"], rows["y_interp"], rows["z_interp"], rows["r_interp"]],
            axis=1).astype(np.float32) * inv127  # [K,4,16]
        c0 = interp[:, :, [0, 4]]   # (c0.x, c0.y) per channel
        c1 = interp[:, :, [8, 12]]  # (c1.x, c1.y)
        motion.bone_tracks[name] = BoneTrack(
            frames=rows["frame"].astype(np.int64),
            translations=rows["translation"].copy(),
            rotations=rows["rotation"].copy(),
            c0=c0, c1=c1)

    n_morph = _read_u32(data, pos, "morph keyframe count"); pos += 4
    morph_recs = _read_records(data, _MORPH_DT, n_morph, pos,
                               "morph keyframes")
    pos += _MORPH_DT.itemsize * n_morph
    for name, rows in _group_sorted(morph_recs["name"], morph_recs):
        k = len(rows)
        # Morph keyframes carry no interpolator bytes in VMD; libmmd leaves the
        # default (linear) Bezier on them (motion.inl MorphKeyframe default).
        lin = np.tile(np.array([[0.0, 0.0]], np.float32), (k, 1))
        lin1 = np.tile(np.array([[1.0, 1.0]], np.float32), (k, 1))
        motion.morph_tracks[name] = MorphTrack(
            frames=rows["frame"].astype(np.int64),
            weights=rows["weight"].copy(),
            c0=lin, c1=lin1)

    # camera section (optional tail)
    if len(data) - pos >= 4:
        n_cam = int(np.frombuffer(data, "<u4", 1, pos)[0]); pos += 4
        if n_cam and len(data) - pos < _CAMERA_DT.itemsize * n_cam:
            return motion  # truncated tail — keep what parsed
        if n_cam:
            cam = np.frombuffer(data, _CAMERA_DT, n_cam, pos)
            order = np.argsort(cam["frame"], kind="stable")
            cam = cam[order]
            motion.camera = CameraTrack(
                frames=cam["frame"].astype(np.int64),
                focal_lengths=cam["focal_length"].copy(),
                positions=cam["position"].copy(),
                rotations=cam["rotation"].copy(),
                fovs=cam["fov"].copy(),
                orthographic=cam["orthographic"].astype(bool),
                interp=cam["interp"].copy())
        pos += _CAMERA_DT.itemsize * n_cam

    # light section (optional tail after camera; reference stops at camera —
    # `VmdReader::ReadCameraMotion` never reads further)
    if len(data) - pos >= 4:
        n_light = int(np.frombuffer(data, "<u4", 1, pos)[0]); pos += 4
        if n_light and len(data) - pos >= _LIGHT_DT.itemsize * n_light:
            rec = np.frombuffer(data, _LIGHT_DT, n_light, pos)
            rec = rec[np.argsort(rec["frame"], kind="stable")]
            motion.light = LightTrack(
                frames=rec["frame"].astype(np.int64),
                colors=rec["color"].copy(),
                directions=rec["direction"].copy())
    return motion


def load_vmd(path: str) -> VmdMotion:
    with open(path, "rb") as f:
        return parse_vmd(f.read())
