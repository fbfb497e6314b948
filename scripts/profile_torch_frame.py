"""Where a frame's time goes in the PyTorch + CUDA port, eager and compiled.

    python3 scripts/profile_torch_frame.py [--frames N] [--out DIR]
                                           [--msaa 4 --shadow-window]
                                           [--crowd I [--density D]]

Builds the flagship scene (sample character at density 2.0, 1920x1080,
2048^2 shadow map, physics on; msaa=1, or with `--msaa 4 --shadow-window`
the frame the reference app renders) on the first CUDA device. With
`--crowd I` the frame is the crowd's: I instances of the character
(density 2.0 unless `--density` says otherwise, `sample_motion(120,
fps_keys=5)`, clocks 7 frames apart) at 256x144 with a 256^2 shadow map.

The frame is profiled twice, each time after 3 warm-up frames, over N
frames with torch.profiler (CPU + CUDA activities):
- eager: `Scene.step_pose` (the CCD loop's early exit) and the render;
- compiled: the step as one CUDA-graph replay (`Scene.rollout`, or
  `parallel.mesh.crowd_step_fn` for a crowd) and the eager render. Its
  capture's seconds are printed first.
Prints for each, per pass label (the `pass_scope` ranges: anim,
pre_physics, physics, post_physics, deform, shadow, ground, character,
shade; the compiled frame's pose and physics passes run inside the graph,
so only its render passes have host ranges), the host time, the device
kernel time and the kernel launches per frame; then the frame's host
launch calls (kernel launches, `cudaGraphLaunch`, `cudaMemcpyAsync`, ...),
its device kernels (those a graph replays included) and the device busy
share of the profiled window. The full `key_averages()` tables go to
DIR/profile_frame_eager.txt and DIR/profile_frame_compiled.txt.
"""

from __future__ import annotations

import argparse
import bisect
import os
import sys
import time

import torch


def profile_frames(label, rollout, state, n, out_dir):
    """Warm up 3 frames, time n, profile n more -> state'."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.utils.profiling import (PASSES,
                                                               launch_counts)

    state = rollout(state, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = rollout(state, n)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.perf_counter() - t0) / n

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = rollout(state, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_frame_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=80))
        f.write("\n\n")
        f.write(events.table(sort_by="device_time_total", row_limit=40))

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    def self_dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    print(f"{label}: frame (no profiler): {plain_ms:.3f} ms; profiled: "
          f"{1000 * wall / n:.3f} ms/frame over {n} frames")
    # the kernel launches inside each pass's host ranges
    raw = prof.events()
    starts = sorted(e.time_range.start for e in raw
                    if e.name == "cudaLaunchKernel")
    in_pass = dict.fromkeys(PASSES, 0)
    cpu = torch.autograd.DeviceType.CPU
    for e in raw:
        if e.name in in_pass and e.device_type == cpu:
            in_pass[e.name] += (
                bisect.bisect_right(starts, e.time_range.end)
                - bisect.bisect_left(starts, e.time_range.start))
    # a pass label appears twice (its host range and its device
    # annotation); the host range carries both the host time and the
    # device time of the kernels launched inside it
    for name in PASSES:
        rows = [e for e in events if e.key == name]
        if not rows:
            print(f"{label}: pass {name}: not seen")
            continue
        e = max(rows, key=lambda r: r.cpu_time_total)
        print(f"{label}: pass {name}: host {e.cpu_time_total / 1000 / n:.3f} "
              f"ms/frame, device kernels {dev_us(e) / 1000 / n:.3f} "
              f"ms/frame, {in_pass[name] / n:.0f} kernel launches/frame")
    host, kernels, busy_us = launch_counts(raw)
    calls = ", ".join(f"{k} {v / n:.0f}" for k, v in host.items())
    print(f"{label}: per frame: host launch calls {sum(host.values()) / n:.0f}"
          f" ({calls}); device kernels {kernels / n:.0f}; device busy "
          f"{busy_us / 1000 / n:.3f} ms = {100 * busy_us / (wall * 1e6):.1f}% "
          f"of the profiled wall time")
    top = sorted((e for e in events if self_dev_us(e) > 0
                  and e.key not in PASSES), key=self_dev_us, reverse=True)
    for e in top[:10]:
        print(f"{label}: device op {e.key[:60]}: "
              f"{self_dev_us(e) / 1000 / n:.3f} ms/frame, "
              f"{e.count / n:.0f} calls/frame")
    return state


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--msaa", type=int, default=1, choices=(1, 4))
    ap.add_argument("--shadow-window", action="store_true")
    ap.add_argument("--crowd", type=int, default=0, metavar="I")
    ap.add_argument("--density", type=float, default=2.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene

    if args.crowd:
        from simple_mmd_renderer_tpu_torch.parallel.mesh import (
            crowd_init, crowd_step_fn)
        from simple_mmd_renderer_tpu_torch.render.pipeline import (
            crowd_render_frame)

        scene = build_sample_scene(args.density, 256, 144, 256, "cuda",
                                   n_frames=120, fps_keys=5, msaa=args.msaa)
        state = crowd_init(scene, args.crowd)
        step = crowd_step_fn(scene)

        def eager(state, n_frames):
            for _ in range(n_frames):
                state, _, positions, normals = scene.step_pose(state)
                crowd_render_frame(scene.rig, positions, normals,
                                   scene.config.render, None, None)
            return state

        def compiled(state, n_frames):
            for _ in range(n_frames):
                state, _ = step(state)
            return state
        print(f"crowd of {args.crowd} instances, density {args.density}, "
              f"msaa={args.msaa}")
    else:
        scene = build_sample_scene(args.density, 1920, 1080, 2048, "cuda",
                                   msaa=args.msaa,
                                   shadow_window=args.shadow_window)
        state = scene.init_state()

        def eager(state, n_frames):
            for _ in range(n_frames):
                state, _ = scene.step_and_render(state)
            return state

        def compiled(state, n_frames):
            return scene.rollout(state, n_frames)[0]

    os.makedirs(args.out, exist_ok=True)
    state = profile_frames("eager", eager, state, args.frames, args.out)
    t0 = time.perf_counter()
    scene.captured_step(state)
    torch.cuda.synchronize()
    print(f"compiled: capture (warm-up and capture of the step) "
          f"{time.perf_counter() - t0:.3f} s")
    profile_frames("compiled", compiled, state, args.frames, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
