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
frames with torch.profiler (CPU + CUDA activities), which switches on the
program's recorder (`utils/profiling`):
- eager: `Scene.step_pose` (the CCD loop's early exit) and the render,
  each frame inside a `profiling.frame()` span;
- compiled: `Scene.jit_step(render=True)`, the step as one CUDA-graph
  replay and the eager render (for a crowd, `parallel.mesh.crowd_step_fn`,
  whose recorded frame is the step alone). Its capture's seconds are
  printed first.
Prints for each the recorder's table, per frame: the frame and
`step.launch` host ms; each stage of the step (anim, pre_physics, physics,
post_physics, deform, write_back), host ms in the eager frame and device ms
in the compiled one (stamped inside the graph; under the profiler a replay
runs at the traced host's pace, so the compiled frame also prints the
stages of the N unprofiled replays before the profiled ones); the
render's host ms outside its host reads, its paced ms (after the first
host read returns, outside later ones) and its host reads by site; the CCD
chain-iterations run and still active. Then the frame's host launch
calls (kernel launches, `cudaGraphLaunch`, `cudaMemcpyAsync`, ...), its
device kernels (those a graph replays included), the device busy share of
the profiled window and the top device operations by name (the hand
kernels, launched through `ctypes`, among them). The full
`key_averages()` tables go to DIR/profile_frame_eager.txt and
DIR/profile_frame_compiled.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def recorder_table(label, frames, untraced):
    """Print the recorder's per-frame means over `frames`
    (`profiling.recorded()`), and the stages of the `untraced` replays
    (`profiling.untraced_replays`): under the profiler a replay runs at the
    traced host's pace, so its own stamps read that pace."""
    n = len(frames)
    if not n:
        print(f"{label}: the recorder holds no frame")
        return

    def mean_ms(pick):
        return sum((s.end - s.start) for f in frames for s in f.spans
                   if pick(s)) / 1e6 / n

    print(f"{label}: recorder, per frame over {n}: frame "
          f"{mean_ms(lambda s: s.name == 'frame' and s.parent is None):.3f}"
          f" ms, step.launch {mean_ms(lambda s: s.name == 'step.launch'):.3f}"
          " ms")
    from simple_mmd_renderer_tpu_torch.utils.profiling import STAGES
    clock = ("device" if any(s.device for f in frames for s in f.spans)
             else "host")
    print(f"{label}: stages ({clock} ms): " + ", ".join(
        f"{name} {mean_ms(lambda s, m=name: s.name == m):.3f}"
        for name in STAGES))
    if untraced:        # the same stages at the card's own pace
        k = len(untraced)
        ms = {}
        for s in (s for r in untraced for s in r):
            ms[s.name] = ms.get(s.name, 0.0) + s.ms / k
        print(f"{label}: stages of the {k} replays before the profiled "
              "ones (device ms): " + ", ".join(
                  f"{name} {v:.3f}" for name, v in ms.items()))
    host = paced = 0
    reads = {}
    for f in frames:
        for r in (s for s in f.spans if s.name == "render"):
            inside = sorted((s for s in f.spans
                             if s.name.startswith("host_read.")
                             and r.start <= s.start and s.end <= r.end),
                            key=lambda s: s.start)
            waits = [s.end - s.start for s in inside]
            host += (r.end - r.start) - sum(waits)
            if inside:
                paced += (r.end - inside[0].end) - sum(waits[1:])
        for site, k in f.host_reads.items():
            reads[site] = reads.get(site, 0) + k
    if any(s.name == "render" for f in frames for s in f.spans):
        print(f"{label}: render host {host / 1e6 / n:.3f} ms (host reads "
              f"left out), paced {paced / 1e6 / n:.3f} ms, host reads "
              f"{sum(reads.values()) / n:.1f} "
              f"({', '.join(f'{k} {v / n:.1f}' for k, v in reads.items())})")
    ccd = {}
    for f in frames:
        for p, (run, useful) in f.ccd_iterations.items():
            got = ccd.get(p, (0, 0))
            ccd[p] = (got[0] + run, got[1] + useful)
    if ccd:
        print(f"{label}: CCD chain-iterations run / active per frame: "
              + ", ".join(f"{p} {r / n:.0f} / {u / n:.0f}"
                          for p, (r, u) in ccd.items()))


def profile_frames(label, run, state, n, out_dir):
    """Warm up 3 frames, time n, profile n more -> state'."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.utils import profiling

    state = run(state, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, n)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.perf_counter() - t0) / n

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = run(state, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_frame_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=80))
        f.write("\n\n")
        f.write(events.table(sort_by="device_time_total", row_limit=40))

    def self_dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    print(f"{label}: frame (no profiler): {plain_ms:.3f} ms; profiled: "
          f"{1000 * wall / n:.3f} ms/frame over {n} frames")
    recorder_table(label, profiling.recorded(),
                   profiling.untraced_replays(n))
    host, kernels, busy_us = profiling.launch_counts(prof.events())
    calls = ", ".join(f"{k} {v / n:.0f}" for k, v in host.items())
    print(f"{label}: per frame: host launch calls {sum(host.values()) / n:.0f}"
          f" ({calls}); device kernels {kernels / n:.0f}; device busy "
          f"{busy_us / 1000 / n:.3f} ms = {100 * busy_us / (wall * 1e6):.1f}% "
          f"of the profiled wall time")
    top = sorted((e for e in events if self_dev_us(e) > 0 and not getattr(
        e, "is_user_annotation", False) and e.key not in profiling.PASSES),
                 key=self_dev_us, reverse=True)
    for e in top[:10]:
        print(f"{label}: device op {e.key[:60]}: "
              f"{self_dev_us(e) / 1000 / n:.3f} ms/frame, "
              f"{e.count / n:.0f} calls/frame")
    profiling.reset()
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
    from simple_mmd_renderer_tpu_torch.utils.profiling import frame

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
                with frame():
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
        step = scene.jit_step(render=True)

        def eager(state, n_frames):
            for _ in range(n_frames):
                with frame():
                    state, _ = scene.step_and_render(state)
            return state

        def compiled(state, n_frames):
            for _ in range(n_frames):
                state, _ = step(state)
            return state

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
