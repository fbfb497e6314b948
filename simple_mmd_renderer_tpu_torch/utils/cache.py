"""The persistent on-disk cache of what the device runs.

Port of `simple_mmd_renderer_tpu/utils/cache.py`. The reference points
JAX's persistent compilation cache at a directory, so that a repeat process
skips the XLA compile and starts in seconds. What the port builds before
the card can run a frame is its hand kernels: `ops/_build` compiles each
`csrc/*.cu` once into a library named after a hash of its source and
flags, and a later process that finds the library loads it without running
nvcc. `enable_compilation_cache` chooses the directory those libraries are
kept in.
"""

from __future__ import annotations

import os
from pathlib import Path


def enable_compilation_cache(path: str | os.PathLike | None = None) -> None:
    """Keep the kernel libraries in `path` (default: `<repo>/build/kernels`,
    where they go without a call): the next build writes there and the
    next process that points here loads them without compiling. Libraries
    this process has already loaded stay loaded; nothing else changes."""
    from ..ops import _build

    _build.BUILD_DIR = (_build.DEFAULT_BUILD_DIR if path is None
                        else Path(path))
