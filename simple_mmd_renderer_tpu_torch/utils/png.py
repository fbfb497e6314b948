"""A PNG writer with no dependency beyond the standard library and NumPy.

`encode_png` writes an 8-bit RGB image as one IDAT chunk of
zlib-compressed rows, each with filter type 0 (none): any PNG reader
decodes it to the same array. The command-line renderer writes its frames
with it, so `--out` needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H,W,3] uint8 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes [H,W,3] uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
