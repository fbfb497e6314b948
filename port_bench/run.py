"""Run one cell of `BENCHMARK.json` once and print its result.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for; without them it prints no result and exits with 2. The run:

1. makes its inputs from the seed (`inputs.py`) and builds the program's
   scene from them through the program's own readers (`scenes.py`);
2. warms up the cell's shapes: the step's CUDA graph is captured, every
   kernel is built (under `build/` in the checkout) and loaded; `setup_s`
   runs from the process's start to here;
3. runs the cell's traffic (`loops.py`) closed-loop for `--seconds` on the
   host clock and takes the end-to-end metrics over the whole window;
4. with `--trace 1`, traces a few more frames with `torch.profiler` and
   reports the per-layer metrics (`metrics/<name>.py`) instead, with the
   device's busy and traced seconds and a breakdown;
5. frees the program and replays sampled frames of the window with the
   plain reference (`check.py`): `correct` and each number beside its
   limit, also as the last lines on standard error.

The last line on standard output is the result as one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .cells import ROOT, load_cell, metric_reader  # noqa: E402

# top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "simple_mmd_renderer_tpu")


def _fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(cache / sub))


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names that `sys.modules` holds, compared
    whole (the part before the first dot)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_error(chips: int) -> str | None:
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are available")
    return None


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _traced(kind, state, frames: int):
    """Profile `frames` frames from `state` after one untraced warm frame
    under the profiler -> (TraceSummary, the traced frames' start
    states)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .yardstick import trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    starts = []
    with profile(activities=acts) as prof:
        state = kind.run_frames(state, 1)
        with record_function(trace.FRAMES):
            kind.run_frames(state, frames, starts)
    host, device = trace.collect(prof)
    return trace.summarize(host, device, kind.kind, frames), starts


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False, t_start: float = T_START) -> dict:
    """One run of `cell`: the result's dict (see the module docstring),
    with the check's raw numbers under "_check"."""
    import torch

    from . import check
    from .inputs import make_inputs
    from .loops import kind_class
    from .scenes import PROGRAM, build_scene

    marks = [("start", t_start), ("imports", time.perf_counter())]
    inputs = make_inputs(cell.config, cell.traffic, seed)
    try:
        marks.append(("inputs", time.perf_counter()))
        scene = build_scene(PROGRAM, inputs, cell.config, device)
        marks.append(("scene", time.perf_counter()))
        kind = kind_class(cell.traffic["kind"])(scene, cell, inputs,
                                                 device)
        marks.append(("start state", time.perf_counter()))
        kind.warm()
        marks.append(("warm-up", time.perf_counter()))
        setup_s = marks[-1][1] - t_start
        print("set-up: " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])),
            file=sys.stderr)
        gc_before = [g["collections"] for g in gc.get_stats()]
        window = kind.window(seconds)
        print("window: %d frames in %.3f s; garbage collections by "
              "generation %s" % (window.frames, window.seconds, [
                  g["collections"] - b
                  for g, b in zip(gc.get_stats(), gc_before)]),
              file=sys.stderr)
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        metrics, summary = {}, None
        if trace:
            summary, starts = _traced(kind, window.states[-1],
                                      int(cell.traffic["trace_frames"]))
            bound = getattr(kind, "raster_bound_s", None)
            if bound is not None:
                summary.raster_bound_s = bound(starts)
            for m in cell.per_layer:
                value = metric_reader(m["name"])(summary)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            e2e = dict(kind.end_to_end(window), setup_s=setup_s)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end}
        sampled = check.keep_samples(window, cell.traffic, seed)
        kind_cls, frames = type(kind), window.frames
        del kind, scene, window
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        result = check.run_check(inputs, cell, kind_cls, sampled, device,
                                 control)
    finally:
        inputs.remove()
    correct, failed, table = check.judge(result["numbers"],
                                         result["per_frame"], cell.limits)
    out = {"correct": correct, "attempted": frames, "failed": failed,
           "metrics": metrics, "device": {
               "platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
        out["_trace"] = {k: v for k, v in vars(summary).items()
                         if k not in ("device_ops", "idle_gaps")}
    out["checks"] = table
    out["_check"] = result
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _fixed_caches()
    cell = load_cell(args.workload)
    err = card_error(cell.chips)
    if err:
        print(f"port_bench: {err}; nothing is measured", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"port_bench: the process loaded {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 3
    out.pop("_check")
    out.pop("_trace", None)
    power = _power_limit_w()
    if power is not None:
        out["device"]["power_limit_w"] = power
    for name, e in out["checks"].items():
        print(f"check {name}: {e['value']!r} (limit {e['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
