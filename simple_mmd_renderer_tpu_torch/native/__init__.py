"""The PMX reader's native vertex parser, loaded through ctypes.

The port's copy of `simple_mmd_renderer_tpu/native/`: `pmx_fast.cpp` reads
the PMX vertex section (variable-size records, the skinning type choosing
each one's layout) with the reference's C ABI, `pmx_parse_vertices`.
`formats/pmx.py` reads the vertices through it when it is available and
through its Python loop, the semantic reference, when it is not.

The library is built with `g++ -O2 -shared -fPIC` at the first
`get_lib()` into `build/native/` at the repository root (ignored by git),
named after a hash of the source and the flags, as `ops/_build.py` names
the kernel libraries: an edited source is rebuilt and never served stale,
and nothing is written beside the source. Without a host compiler, or
when the build fails (a RuntimeWarning then says why), `get_lib()` gives
None and the reader takes the Python loop, as the reference's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

SRC = Path(__file__).resolve().parent / "pmx_fast.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libpmx_fast_{h.hexdigest()[:16]}.so"


def build(cxx: str = "g++") -> Path:
    """Compile the source unless its library exists; -> its path."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SRC.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all
    return out


def get_lib():
    """ctypes handle to the native library (built at the first call), or
    None when there is no host compiler or the build fails."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        try:
            lib = ctypes.CDLL(str(build(cxx)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            warnings.warn(f"the native PMX vertex parser is not available, "
                          f"the Python loop reads the vertices: {e}",
                          RuntimeWarning)
            return None
        lib.pmx_parse_vertices.restype = ctypes.c_int
        lib.pmx_parse_vertices.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _lib = lib
        return _lib
