"""Binary cursor reader for MMD file formats.

Equivalent in role to libmmd's FileReader (`util/dwarf.inl`): whole-buffer
reads of packed little-endian records, variable-width indices, and
UTF-16LE/UTF-8 length-prefixed strings. Index semantics match
`FileReader::ReadIndex` (`util/dwarf_impl.inl:84-105`): 1 byte -> uint8,
2 bytes -> uint16, 4 bytes -> int32 (so "none" is 255/65535/-1 and callers
range-check against the entity count).

Every failure mode — truncated buffer, negative/overlong count, invalid
index width — raises `ParseError` (a ValueError subclass) naming the byte
offset and field, so callers can catch one typed error per load and keep
running, like the reference's per-load exception guard
(`main.cpp:692-698`; the reader throws at `reader/pmx_reader_impl.inl:96-99`).

The port's own copy of `simple_mmd_renderer_tpu/utils/io.py`.
"""

from __future__ import annotations

import struct

import numpy as np


class ParseError(ValueError):
    """Malformed/truncated MMD file data. Carries the byte offset and the
    field being read so hostile inputs fail loud but typed."""

    def __init__(self, message: str, offset: int | None = None,
                 field: str | None = None):
        at = f" at byte {offset}" if offset is not None else ""
        of = f" (reading {field})" if field else ""
        super().__init__(f"{message}{at}{of}")
        self.offset = offset
        self.field = field


class BinReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def read(self, fmt: str, field: str | None = None):
        full = "<" + fmt
        size = struct.calcsize(full)
        if self.pos + size > len(self.buf):
            raise ParseError(
                f"truncated: need {size} bytes, {self.remaining()} left",
                self.pos, field or fmt)
        vals = struct.unpack_from(full, self.buf, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n: int, field: str | None = None) -> bytes:
        if n < 0:
            raise ParseError(f"negative byte count {n}", self.pos, field)
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ParseError(
                f"truncated: need {n} bytes, {self.remaining()} left",
                self.pos, field)
        self.pos += n
        return out

    def read_array(self, dtype, count: int,
                   field: str | None = None) -> np.ndarray:
        dt = np.dtype(dtype).newbyteorder("<")
        if count < 0:
            raise ParseError(f"negative count {count}", self.pos, field)
        nbytes = dt.itemsize * count
        if self.pos + nbytes > len(self.buf):
            raise ParseError(
                f"truncated: need {nbytes} bytes for {count} records, "
                f"{self.remaining()} left", self.pos, field)
        out = np.frombuffer(self.buf, dt, count, self.pos).copy()
        self.pos += nbytes
        return out

    _INDEX_FMT = {1: "B", 2: "H", 4: "i"}

    def read_index(self, size: int, field: str | None = None) -> int:
        fmt = self._INDEX_FMT.get(size)
        if fmt is None:
            raise ParseError(f"invalid index width {size} (must be 1/2/4)",
                             self.pos, field)
        return self.read(fmt, field)

    def read_count(self, min_record: int, field: str) -> int:
        """Read an i32 element count and validate it against the bytes
        actually left: count >= 0 and count * min_record <= remaining.
        Rejects hostile counts BEFORE any allocation is sized from them
        (a forged 2^31 vertex count must not drive a 24 GB np.empty)."""
        n = self.read("i", field)
        if n < 0:
            raise ParseError(f"negative count {n}", self.pos - 4, field)
        if min_record > 0 and n * min_record > self.remaining():
            raise ParseError(
                f"count {n} x >= {min_record} B/record exceeds the "
                f"{self.remaining()} bytes left", self.pos - 4, field)
        return n

    def read_text(self, utf8: bool, field: str | None = None) -> str:
        length = self.read("i", field)
        if length < 0:
            raise ParseError(f"negative string length {length}",
                             self.pos - 4, field)
        raw = self.read_bytes(length, field)
        return raw.decode("utf-8" if utf8 else "utf-16-le", errors="replace")


def decode_shift_jis(raw: bytes) -> str:
    """ShiftJIS fixed-width name field -> str, stopping at the first NUL.

    Mirrors ShiftJISToUTF16String over mmd_string<N>
    (`util/dwarf_impl.inl:216-229`).
    """
    nul = raw.find(b"\x00")
    if nul >= 0:
        raw = raw[:nul]
    return raw.decode("cp932", errors="replace")


def encode_shift_jis(text: str, width: int) -> bytes:
    raw = text.encode("cp932", errors="replace")[:width]
    return raw + b"\x00" * (width - len(raw))
