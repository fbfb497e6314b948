"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` of this package is compiled by its own `nvcc` into a
shared library with a plain C interface, all sources at once in parallel,
at first use (`lib()`; `entry(name)` builds only the source that defines
`name`), and loaded with `ctypes` (no PyTorch headers: the build takes
seconds, not minutes). Each library is named after a hash of its source and
the flags, so an edited source is rebuilt and never served stale. They land
in `BUILD_DIR`, by default `build/kernels/` at the repository root, which
`.gitignore` lists; `utils.cache.enable_compilation_cache(path)` points it
elsewhere.

Flags: sm_90a (Hopper), -O3, no fast math, and --fmad=false so no multiply
and add is contracted into an FMA: the kernels' plane and reference-depth
arithmetic then rounds exactly like their plain PyTorch versions, and the
kernel-vs-plain checks on the card can demand bit equality.

Each C entry point returns `cudaGetLastError()` after its launch;
`check(rc, name)` raises when it is not 0 (a refused launch never runs, and
no later synchronise would report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
                     / "kernels")
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (pointers and the stream as c_void_p)
SIGNATURES = {
    "smr_pcf_lit_map": [_P, _P, _P, _P, _I, _P, _I, _I, _P],
    "smr_depth_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
    "smr_raster_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _I, _I, _P],
    "smr_raster_tiles_ms": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                            _P, _P, _P, _I, _I, _P],
    "smr_depth_tiles_win": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                            _P],
    "smr_depth_tiles_multi": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                              _I, _P],
    "smr_raster_tiles_multi": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                               _P, _P, _P, _P, _I, _I, _P],
    "smr_raster_tiles_ms_multi": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                                  _P, _P, _P, _P, _P, _I, _I, _P],
    "smr_scan_bins": [_P, _I, _I, _I, _I, _I, _P, _P],
    "smr_scan_raster": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "smr_stamp": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "smr_ccd": [_P] * 25 + [_I, _I, _I] + [_P] * 5,
    "smr_ccd_orders": [_P, _P, _P, _P, _P, _I, _P, _P],
    "smr_ccd_primitive": [_P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: SimpleNamespace | None = None
_entries: dict = {}     # name -> a C entry point bound alone (`entry`)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in csrc/")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libsmr_{src.stem}_{h.hexdigest()[:16]}.so"


def build(srcs: list[Path] | None = None) -> list[Path]:
    """Compile every csrc/*.cu (or those of `srcs`) that has no library
    yet, one nvcc process per source, all started together; -> the
    libraries' paths."""
    srcs = _sources() if srcs is None else srcs
    outs = [library_path(src) for src in srcs]
    jobs = []
    for src, out in zip(srcs, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for cmd, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(" ".join(cmd) + "\n" + log)
        else:
            os.replace(tmp, out)   # atomic: a concurrent builder sees all
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return outs


def lib() -> SimpleNamespace:
    """The kernels' C entry points (SIGNATURES), each bound from the
    library that exports it (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handles = [ctypes.CDLL(str(path)) for path in build()]
            fns = {}
            for name in SIGNATURES:
                owners = [h for h in handles if hasattr(h, name)]
                if len(owners) != 1:
                    raise RuntimeError(f"{name}: exported by {len(owners)} "
                                       "kernel libraries, expected 1")
                fns[name] = _bind(owners[0], name)
            _lib = SimpleNamespace(**fns)
        return _lib


def entry(name: str):
    """The C entry point `name` (SIGNATURES) alone, from the library of the
    one source that defines it: only that source is built, so a caller of
    one kernel (the step's stage clock) does not wait for the others."""
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            if _lib is not None:
                fn = getattr(_lib, name)
            else:
                defines = re.compile(rf'extern "C" int {re.escape(name)}\(')
                srcs = [s for s in _sources()
                        if defines.search(s.read_text())]
                if len(srcs) != 1:
                    raise RuntimeError(f"{name}: defined by {len(srcs)} "
                                       "kernel sources, expected 1")
                (path,) = build(srcs)
                fn = _bind(ctypes.CDLL(str(path)), name)
            _entries[name] = fn
        return fn


def _bind(handle, name: str):
    fn = getattr(handle, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
