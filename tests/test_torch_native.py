"""The PMX reader's native vertex parser (`native/`, `formats/pmx.py`) and
the kernel cache (`utils/cache.enable_compilation_cache`), on the CPU.

The port's parse through its native library and through its Python loop
against the reference's parse through its own two routes (as
tests/test_golden_bytes.py parametrizes them), every field equal
(`_assert_same`: arrays by value and dtype), on the bytes `write_pmx`
writes for tests/fixtures.py's `two_bone_arm` (BDEF1, BDEF2, BDEF4 and
SDEF vertices), for a copy of it with `extra_uv_count = 2` (seeded random
extra UVs), and for the sample character at density 0.5. Malformed bytes
raise the same ParseError (message, offset, field) as the reference's on
each route: truncated inside the vertex records, and a skinning type of 7.
"""

from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401  (the port's tests' thread cap)

import simple_mmd_renderer_tpu.native as ref_native
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.utils.io import ParseError as RefParseError
from simple_mmd_renderer_tpu_torch import native
from simple_mmd_renderer_tpu_torch.app.sample import sample_character
from simple_mmd_renderer_tpu_torch.formats import pmx
from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx
from simple_mmd_renderer_tpu_torch.ops import _build
from simple_mmd_renderer_tpu_torch.utils.cache import enable_compilation_cache
from simple_mmd_renderer_tpu_torch.utils.io import BinReader, ParseError

from fixtures import two_bone_arm
from test_torch_builders import _assert_same

ROOT = Path(__file__).resolve().parent.parent
ROUTES = ["native", "python"]


def _extra_uv_arm():
    pm = two_bone_arm()
    pm.extra_uv_count = 2
    pm.extra_uvs = np.random.default_rng(14).standard_normal(
        (len(pm.positions), 2, 4)).astype(np.float32)
    return pm


MODELS = {"two_bone_arm": two_bone_arm, "extra_uv_2": _extra_uv_arm,
          "sample_d0.5": lambda: sample_character(density=0.5)}


def _route(monkeypatch, port: str, ref: str) -> None:
    """The vertex routes of both readers for the test: "python" disables
    the native library (the reference's reader falls back when its
    get_lib raises, the port's when get_lib gives None)."""
    if port == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    if ref == "python":
        def no_native():
            raise RuntimeError("native disabled for test")
        monkeypatch.setattr(ref_native, "get_lib", no_native)


def test_native_library_builds_under_build_native():
    lib = native.get_lib()
    assert lib is not None, "g++ is on the PATH: the library must load"
    path = Path(lib._name)
    assert path == native.library_path()
    assert path.parent == ROOT / "build" / "native"
    assert path.exists() and path.name.startswith("libpmx_fast_")
    src_dir = Path(native.__file__).parent
    assert not list(src_dir.glob("*.so")), "nothing is built beside the source"


def test_a_failed_build_warns_and_takes_the_python_loop(monkeypatch):
    """A build that fails (here: a compiler error) is not hidden: get_lib
    warns, gives None, and the reader takes the Python loop."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)

    def broken(cxx="g++"):
        raise RuntimeError("g++ failed on pmx_fast.cpp")
    monkeypatch.setattr(native, "build", broken)
    with pytest.warns(RuntimeWarning, match="Python loop"):
        assert native.get_lib() is None
    assert native.get_lib() is None
    data = write_pmx(two_bone_arm())
    _assert_same(pmx.parse_pmx(data), ref_pmx.parse_pmx(data))


@pytest.mark.parametrize("ref_route", ROUTES)
@pytest.mark.parametrize("port_route", ROUTES)
@pytest.mark.parametrize("model", list(MODELS))
def test_vertex_routes_match_the_reference(monkeypatch, model, port_route,
                                           ref_route):
    data = write_pmx(MODELS[model]())
    _route(monkeypatch, port_route, ref_route)
    got = pmx.parse_pmx(data)
    want = ref_pmx.parse_pmx(data)
    if model != "sample_d0.5":
        assert got.skin_type.tolist() == [0, 1, 2, 3]
    assert got.extra_uvs.shape[1] == (2 if model == "extra_uv_2" else 0)
    _assert_same(got, want)


def _first_skin_type_offset(data: bytes) -> tuple[int, int]:
    """(offset of vertex 0's skinning-type byte, start of the vertex
    records) in PMX bytes."""
    r = BinReader(data)
    r.read_bytes(4, "magic")
    r.read("f")
    r.read("B")
    utf8 = r.read("B") > 0
    extra_uv = r.read("B")
    for _ in range(6):
        r.read("B")
    for _ in range(4):
        r.read_text(utf8)
    r.read("i")
    return r.pos + 32 + 16 * extra_uv, r.pos


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bad", ["truncated", "skin_type"])
def test_malformed_vertices_raise_like_the_reference(monkeypatch, route,
                                                     bad):
    pm = two_bone_arm()
    data = bytearray(write_pmx(pm))
    skin, start = _first_skin_type_offset(bytes(data))
    if bad == "skin_type":
        data[skin] = 7
    else:
        # as many bytes as 4 of the smallest records (BDEF1, bone index 4):
        # the count passes its check, the BDEF4 and SDEF records overrun
        del data[start + 4 * (32 + 1 + 4 + 4):]
    data = bytes(data)
    _route(monkeypatch, route, route)
    with pytest.raises(RefParseError) as want:
        ref_pmx.parse_pmx(data)
    with pytest.raises(ParseError) as got:
        pmx.parse_pmx(data)
    assert str(got.value) == str(want.value)
    assert (got.value.offset, got.value.field) == (want.value.offset,
                                                  want.value.field)
    if route == "native":
        rc = -2 if bad == "skin_type" else -1
        assert f"rc={rc}" in str(got.value)


def test_compilation_cache_sends_the_next_build_to_path(monkeypatch,
                                                        tmp_path):
    """`enable_compilation_cache(path)` points the kernel build at `path`:
    every library's path lies there, and a library already there is taken
    as it is, without running nvcc (patched here to fail the test if it
    runs). No argument gives back the default."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    enable_compilation_cache(tmp_path / "kernels")
    srcs = _build._sources()
    assert [_build.library_path(s).parent for s in srcs] == \
        [tmp_path / "kernels"] * len(srcs)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc ran"))
    (tmp_path / "kernels").mkdir()
    for s in srcs:
        _build.library_path(s).write_bytes(b"")
    assert _build.build() == [_build.library_path(s) for s in srcs]
    enable_compilation_cache()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR == \
        ROOT / "build" / "kernels"
    assert _build.library_path(srcs[0]).parent == ROOT / "build" / "kernels"



def test_an_entry_point_builds_only_the_source_that_defines_it(monkeypatch):
    """`_build.entry(name)` asks nvcc for the one csrc/*.cu that defines
    `name` (patched here to stop there): the step's stage clock does not
    wait for the raster kernels' build. Every entry point of SIGNATURES is
    defined by exactly one source."""
    asked = []

    def stop(srcs=None):
        asked.append([s.name for s in srcs])
        raise RuntimeError("stopped before nvcc")

    monkeypatch.setattr(_build, "build", stop)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_entries", {})
    with pytest.raises(RuntimeError, match="stopped before nvcc"):
        _build.entry("smr_stamp")
    with pytest.raises(RuntimeError, match="stopped before nvcc"):
        _build.entry("smr_pcf_lit_map")
    assert asked == [["stamp.cu"], ["shadow_pcf.cu"]]
    texts = [s.read_text() for s in _build._sources()]
    for name in _build.SIGNATURES:
        assert sum(f'extern "C" int {name}(' in t for t in texts) == 1, name
