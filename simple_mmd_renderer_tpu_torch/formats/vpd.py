"""VPD pose parser ("Vocaloid Pose Data file").

The reference declares an abstract ``PoseReader``
(`reader/pose_reader.inl:14-17`) but never implements a concrete reader;
this module completes that declared capability with the standard VPD text
format MikuMikuDance writes (ShiftJIS/cp932, ``;``-terminated values,
``//`` comments):

    Vocaloid Pose Data file

    miku.osm;       // parent file
    2;              // bone count

    Bone0{右腕
      0.0,0.0,0.0;              // translation x,y,z
      -0.40,0.0,0.0,0.91;       // quaternion x,y,z,w
    }

    Morph0{まばたき              // newer MMD also exports morph blocks
      1.0;
    }

``load_vpd`` returns a :class:`~.vmd.VmdMotion` whose tracks hold ONE
keyframe at frame 0 (linear interpolators), so a pose binds and plays
through the exact same ``bind_motion`` -> pose pipeline as a VMD — sampling
clamps to the single key at every time (`motion_impl.inl:262-268` clamp
semantics), i.e. the model holds the pose.

The port's own copy of `simple_mmd_renderer_tpu/formats/vpd.py`, giving the
port's `VmdMotion`.
"""

from __future__ import annotations

import re

import numpy as np

from ..utils.io import ParseError
from .vmd import BoneTrack, MorphTrack, VmdMotion

MAGIC = "Vocaloid Pose Data file"

# linear easing: c0.x == c0.y and c1.x == c1.y hits the Bezier linear
# fast path (utils/bezier.py; math_impl.inl:1398-1408)
_LIN_C0 = (0.25, 0.25)
_LIN_C1 = (0.75, 0.75)

_BLOCK_RE = re.compile(
    r"(Bone|Morph|Expression)\d*\s*\{([^{}]*)\}", re.DOTALL)


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)


def _floats(chunk: str, n: int, what: str) -> np.ndarray:
    vals = [v.strip() for v in chunk.split(",")]
    if len(vals) != n:
        raise ParseError(
            f"VPD {what}: expected {n} comma-separated values, got "
            f"{len(vals)} in {chunk!r}")
    try:
        return np.asarray([float(v) for v in vals], np.float32)
    except ValueError as e:
        raise ParseError(f"VPD {what}: non-numeric value ({e})") from e


def parse_vpd(data: bytes, name: str = "") -> VmdMotion:
    """Parse VPD file bytes into a single-keyframe VmdMotion."""
    try:
        text = data.decode("cp932", errors="replace")
    except Exception as e:  # pragma: no cover - replace never raises
        raise ParseError(f"VPD: undecodable bytes ({e})") from e
    if MAGIC not in text.split("\n", 1)[0]:
        raise ParseError(
            f"VPD: bad magic (expected first line to contain {MAGIC!r})")
    text = _strip_comments(text)

    motion = VmdMotion(name=name)
    f0 = np.zeros(1, np.int64)
    for kind, body in _BLOCK_RE.findall(text):
        # first line of the block body is the bone/morph name; the rest
        # are ';'-terminated value lines
        head, _, rest = body.partition("\n")
        bname = head.strip()
        if not bname:
            raise ParseError(f"VPD: {kind} block with empty name")
        stmts = [s.strip() for s in rest.split(";") if s.strip()]
        if kind == "Bone":
            if len(stmts) < 2:
                raise ParseError(
                    f"VPD bone {bname!r}: expected translation and "
                    f"quaternion statements, got {len(stmts)}")
            trans = _floats(stmts[0], 3, f"bone {bname!r} translation")
            quat = _floats(stmts[1], 4, f"bone {bname!r} quaternion")
            motion.bone_tracks[bname] = BoneTrack(
                frames=f0,
                translations=trans[None, :],
                rotations=quat[None, :],
                c0=np.tile(np.asarray(_LIN_C0, np.float32), (1, 4, 1)),
                c1=np.tile(np.asarray(_LIN_C1, np.float32), (1, 4, 1)),
            )
        else:  # Morph / Expression
            if len(stmts) < 1:
                raise ParseError(
                    f"VPD morph {bname!r}: expected a weight statement")
            w = _floats(stmts[0], 1, f"morph {bname!r} weight")
            motion.morph_tracks[bname] = MorphTrack(
                frames=f0,
                weights=w.astype(np.float32),
                c0=np.asarray(_LIN_C0, np.float32)[None, :],
                c1=np.asarray(_LIN_C1, np.float32)[None, :],
            )
    if not motion.bone_tracks and not motion.morph_tracks:
        raise ParseError("VPD: no Bone or Morph blocks found")
    return motion


def load_vpd(path: str) -> VmdMotion:
    """Load a .vpd pose file -> single-keyframe VmdMotion (see module doc)."""
    with open(path, "rb") as f:
        data = f.read()
    return parse_vpd(data, name=str(path))
