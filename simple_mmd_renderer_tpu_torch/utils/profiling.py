"""Profiler labels for the sim and render passes, traces, frame statistics
and launch counts.

`pass_scope(name)` is the reference's `utils/profiling.pass_scope` (a
`jax.named_scope`) as a `torch.profiler.record_function` range with the same
name, so a `torch.profiler` trace groups the device work per pass.
`trace(logdir)` (the reference's `jax.profiler.trace`) records a profile of
its body over the host and the card and writes it into `logdir` as a
Chrome trace, where the `pass_scope` labels show. `FrameStats` is the
reference's rolling frame timing, as it is. `launch_counts` reads a trace's
host launch calls and device kernels (used by `chip_smoke.py` and
`scripts/profile_torch_frame.py`)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch
from torch.profiler import record_function


def pass_scope(name: str):
    """Label a render/sim pass in profiler traces."""
    return record_function(name)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body (host and, where there is a card, device activity)
    into `logdir`/trace.json, a Chrome trace (chrome://tracing, Perfetto):
    no TensorBoard plugin needed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class FrameStats:
    """Rolling frame timing + counters (the sokol-gfx stats window analog)."""

    def __init__(self, window: int = 120):
        self.times = deque(maxlen=window)
        self.counters: dict[str, float] = {}
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def frame_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1000.0 * sum(self.times) / len(self.times)

    def summary(self) -> dict:
        return {"fps": round(self.fps, 2),
                "frame_ms": round(self.frame_ms, 3),
                **self.counters}


# the sim and render passes' labels, in frame order
PASSES = ("anim", "pre_physics", "physics", "post_physics", "deform",
          "morphs", "shadow", "skybox", "ground", "edges", "character",
          "albedo", "mmd", "shade")

# the host calls that put work on the card: kernel launches (the runtime's
# and the driver's), graph launches, copies and fills
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def launch_counts(events) -> tuple[dict, int, float]:
    """From a `torch.profiler` run's `events()`: (host launch calls by
    name, device kernels, device busy microseconds). A kernel replayed from
    a CUDA graph counts as a device kernel with no host launch of its own;
    the busy time sums kernels, copies and fills (one stream: no overlap),
    not the device-side ranges of `pass_scope` labels."""
    from torch.autograd import DeviceType

    host = dict.fromkeys(HOST_LAUNCH_CALLS, 0)
    kernels, busy_us = 0, 0.0
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name in host:
                host[e.name] += 1
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False) and e.name not in PASSES:
            busy_us += e.time_range.elapsed_us()
            kernels += not e.name.startswith(("Memcpy", "Memset"))
    return {k: n for k, n in host.items() if n}, kernels, busy_us
