"""Radiance .hdr (RGBE) reader and writer: the host NumPy equivalent of the
stb_image `stbi_loadf` path the original app uses for its environment map
(`main.cpp:1034`).

The port's own copy of `simple_mmd_renderer_tpu/formats/hdr.py`. Reads the
common 32-bit_rle_rgbe encoding (adaptive RLE scanlines) and flat RGBE
data; returns float32 [H,W,3] linear radiance. `write_hdr` writes flat
RGBE.
"""

from __future__ import annotations

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """[...,4] uint8 RGBE -> [...,3] float32 (ldexp decode, like stb)."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def parse_hdr(data: bytes) -> np.ndarray:
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = 0
    # header: lines until a blank one
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    dims = data[pos:nl].split()
    pos = nl + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims!r}")
    height, width = int(dims[1]), int(dims[3])

    buf = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    out = np.empty((height, width, 4), np.uint8)

    # new-style RLE scanlines start with 0x02 0x02 and a 2-byte width
    if (width >= 8 and width < 32768 and len(buf) >= 4 and
            buf[0] == 2 and buf[1] == 2 and
            (int(buf[2]) << 8 | int(buf[3])) == width):
        p = 0
        for y in range(height):
            if not (buf[p] == 2 and buf[p + 1] == 2):
                raise ValueError("corrupt HDR RLE scanline header")
            p += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[p])
                    if count > 128:  # run
                        out[y, x:x + count - 128, c] = buf[p + 1]
                        x += count - 128
                        p += 2
                    else:  # literal
                        out[y, x:x + count, c] = buf[p + 1:p + 1 + count]
                        x += count
                        p += 1 + count
    else:
        flat = buf[: height * width * 4]
        out = flat.reshape(height, width, 4)

    return _decode_rgbe(out)


def load_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return parse_hdr(f.read())


def write_hdr(path: str, image: np.ndarray) -> None:
    """Minimal flat-RGBE writer (tests and synthetic environment maps)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    maxc = np.maximum(img.max(axis=-1), 1e-32)
    exp = np.ceil(np.log2(maxc)).astype(np.int32) + 1
    scale = np.ldexp(1.0, -exp + 8).astype(np.float32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(
        np.uint8)
    rgbe[..., 3] = np.where(maxc < 1e-30, 0, exp + 128).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
