"""Hostile-input fuzzing for the port's three binary parsers: the 15 cases
of tests/test_fuzz.py (which holds the reference's readers) against
`simple_mmd_renderer_tpu_torch.formats.{pmx,pmd,vmd}` and `utils.io`.

The contract is the reference's: every malformed input (truncated
anywhere, byte-corrupted, forged counts, invalid index widths) either
parses (corruption can land on benign payload bytes) or raises exactly
`utils.io.ParseError`, never a bare struct.error, IndexError, NumPy
ValueError, MemoryError or a hang. The inputs are the reference's own:
tests/wild_assets.py's wild PMX, PMD and VMD, the same seeds, cuts and
corruption sites.

One case is adapted: the reference's Python-fallback truncation makes its
`native.get_lib` raise, where the port's `get_lib` gives None when it has
no library; the copy patches the port's way, and checks that the reader
asked for the library, so the Python loop runs the same 60 cuts.
"""

import numpy as np
import pytest

from simple_mmd_renderer_tpu_torch import native
from simple_mmd_renderer_tpu_torch.formats.pmd import parse_pmd
from simple_mmd_renderer_tpu_torch.formats.pmx import parse_pmx
from simple_mmd_renderer_tpu_torch.formats.vmd import parse_vmd
from simple_mmd_renderer_tpu_torch.utils.io import BinReader, ParseError

from wild_assets import build_wild_pmd, build_wild_pmx, build_wild_vmd

import torch_threads  # noqa: F401  (the port's tests' thread cap)

PARSERS = {
    "pmx": (parse_pmx, build_wild_pmx(seed=0)),
    "pmd": (parse_pmd, build_wild_pmd(seed=1)),
    "vmd": (parse_vmd, build_wild_vmd(seed=2)),
}


def _must_be_typed(parse, data):
    """Parse `data`; success and ParseError are the only legal outcomes."""
    try:
        parse(data)
    except ParseError:
        pass
    # anything else (struct.error, IndexError, np ValueError...) propagates
    # and fails the test with the offending exception as the message


@pytest.fixture
def python_loop(monkeypatch):
    """The PMX reader without the native library: the port's get_lib gives
    None (no compiler, or a failed build), and the reader then takes its
    Python vertex loop. -> the number of times the reader asked."""
    asked = []

    def no_lib():
        asked.append(1)
        return None

    monkeypatch.setattr(native, "get_lib", no_lib)
    return asked


# (format, Python vertex loop?, seed, cuts): the reference's
# test_truncation_at_every_region for each format, and its
# test_pmx_truncation_python_fallback
TRUNCATIONS = {"pmx": ("pmx", False, 1234, 200),
               "pmd": ("pmd", False, 1234, 200),
               "vmd": ("vmd", False, 1234, 200),
               "pmx-python-loop": ("pmx", True, 77, 60)}


@pytest.mark.parametrize("case", list(TRUNCATIONS))
def test_truncation_at_every_region(case, request):
    """Slicing the file at deterministic offsets never escapes the
    typed-error contract (VMD's optional camera/light tails may succeed
    with partial data, as the reference reader stops at end-of-stream).
    The native vertex parser and the Python loop hold the same contract."""
    fmt, loop, seed, n = TRUNCATIONS[case]
    asked = request.getfixturevalue("python_loop") if loop else None
    parse, data = PARSERS[fmt]
    parse(data)  # the full image must parse
    rng = np.random.default_rng(seed)
    cuts = set(rng.integers(0, len(data), n).tolist())
    if not loop:
        cuts |= {0, 1, 2, 3, 4, len(data) // 2, len(data) - 1}
    for cut in sorted(cuts):
        _must_be_typed(parse, data[:cut])
    if loop:
        assert asked, "the reader never asked for the native library"


@pytest.mark.parametrize("fmt", list(PARSERS))
def test_byte_corruption(fmt):
    """Random single/multi-byte corruption at 200 deterministic sites:
    either parses (corruption on benign payload) or raises ParseError."""
    parse, data = PARSERS[fmt]
    rng = np.random.default_rng(4321)
    buf = bytearray(data)
    for _ in range(200):
        k = int(rng.integers(1, 5))
        sites = rng.integers(0, len(buf), k)
        olds = [(int(s), buf[int(s)]) for s in sites]
        for s, _ in olds:
            buf[s] = int(rng.integers(0, 256))
        _must_be_typed(parse, bytes(buf))
        for s, old in olds:  # restore: each round corrupts fresh
            buf[s] = old


def _pmx_header(sz=2):
    """Minimal valid PMX header + globals + 4 empty text fields."""
    return (b"PMX " + np.float32(2.0).tobytes() + bytes([8, 0, 0])
            + bytes([sz] * 6) + b"\x00\x00\x00\x00" * 4)


def _invalid_index_size():
    data = bytearray(_pmx_header())
    data[11] = 3  # vertex index size 3 (must be 1/2/4)
    return bytes(data)


def _vmd_forged_bone_count():
    data = bytes(PARSERS["vmd"][1])
    return data[:50] + np.uint32(1 << 31).tobytes() + data[54:]


def _pmd_forged_face_vertex_count():
    # header + 0 verts + 0 idx + 0 mats + 0 bones + 0 iks + 1 face morph
    # whose vnum (2^30) is far beyond the remaining bytes: must raise
    # before sizing the allocation
    return (b"Pmd" + np.float32(1.0).tobytes()
            + b"\x00" * 20 + b"\x00" * 256
            + np.uint32(0).tobytes()      # vertices
            + np.uint32(0).tobytes()      # indices
            + np.uint32(0).tobytes()      # materials
            + np.uint16(0).tobytes()      # bones
            + np.uint16(0).tobytes()      # iks
            + np.uint16(1).tobytes()      # 1 face morph
            + b"\x00" * 20                # name
            + np.uint32(1 << 30).tobytes()  # forged vnum
            + b"\x00")                    # ftype


# the reference's TestForgedCounts cases that forge one input:
# (parser, bytes builder, the ParseError's message or None)
FORGED = {
    # a forged 2^30 vertex count must raise, not drive a ~100 GB np.empty
    "huge_vertex_count_rejected_before_allocation": (
        parse_pmx, lambda: _pmx_header() + np.int32(1 << 30).tobytes(),
        "vertex count"),
    "negative_vertex_count": (
        parse_pmx, lambda: _pmx_header() + np.int32(-5).tobytes(),
        "negative"),
    "invalid_index_size": (parse_pmx, _invalid_index_size, "index size"),
    # 0 vertices, 3 indices
    "triangle_index_past_vertex_count": (
        parse_pmx, lambda: (_pmx_header() + np.int32(0).tobytes()
                            + np.int32(3).tobytes()
                            + np.array([0, 1, 2], "<u2").tobytes()),
        "triangle index"),
    "vmd_forged_bone_count": (parse_vmd, _vmd_forged_bone_count,
                              "truncated"),
    "pmd_forged_face_vertex_count": (parse_pmd,
                                     _pmd_forged_face_vertex_count, None),
}


@pytest.mark.parametrize("case", list(FORGED))
def test_forged_input_raises_typed(case):
    parse, build, match = FORGED[case]
    with pytest.raises(ParseError, match=match):
        parse(build())
    if case == "triangle_index_past_vertex_count":
        # sanity: the wild asset has real faces
        assert parse_pmx(PARSERS["pmx"][1]).triangles.size


def test_binreader_typed_errors():
    r = BinReader(b"\x01\x02")
    with pytest.raises(ParseError, match="truncated"):
        r.read("i", "field")
    with pytest.raises(ParseError, match="negative"):
        r.read_bytes(-1, "field")
    with pytest.raises(ParseError, match="invalid index width"):
        r.read_index(3, "field")
    with pytest.raises(ParseError, match="truncated"):
        r.read_array(np.float32, 10, "field")
    err = None
    try:
        BinReader(b"").read("f", "position")
    except ParseError as e:
        err = e
    assert err.offset == 0 and err.field == "position"


def test_native_rc_overrun():
    """The C parser's rc=-1 (overrun) surfaces as ParseError: a valid
    header claiming 4 vertices over 10 bytes of vertex data."""
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    data = (_pmx_header() + np.int32(4).tobytes() + b"\x00" * 10
            + b"\xff" * 160)  # plausible remaining-byte budget
    with pytest.raises(ParseError):
        parse_pmx(data)
