"""Profiler labels for the sim and render passes, and launch counts.

`pass_scope(name)` is the reference's `utils/profiling.pass_scope` (a
`jax.named_scope`) as a `torch.profiler.record_function` range with the same
name, so a `torch.profiler` trace groups the device work per pass.
`launch_counts` reads a trace's host launch calls and device kernels (used
by `chip_smoke.py` and `scripts/profile_torch_frame.py`)."""

from __future__ import annotations

from torch.profiler import record_function


def pass_scope(name: str):
    """Label a render/sim pass in profiler traces."""
    return record_function(name)


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
