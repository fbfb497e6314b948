"""A profiler trace of some frames reduced to what the per-layer metrics
read.

The events come from `torch.profiler` (`prof.profiler.kineto_results
.events()`): host events (the program's pass labels and the benchmark's
own spans, operators, and the CUDA runtime calls that put work on the
card) and device events (kernels, copies, fills). A device event belongs to
the host call that launched it by the profiler's correlation id; a kernel
replayed from a CUDA graph carries its `cudaGraphLaunch`'s id, and a hand
kernel launched through `ctypes` carries its own launch call's id, so
attribution by correlation reaches both, where attribution by operator
misses the second. A launch belongs to the innermost pass label open on
the host when it was made.

Only the traced frames count: the window runs from the start of the first
span named FRAMES to the later of the last one's end and the end of the
last device event that began inside it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

FRAMES = "bench.traced"

# the host calls that put work on the card: kernel launches (cudaLaunch*
# and cuLaunch*), graph launches, copies and fills (the program's list,
# `utils/profiling.HOST_LAUNCH_CALLS`, as it stood when the benchmark was
# defined)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")
GRAPH_LAUNCH = "cudaGraphLaunch"

# the program's pass labels (`utils/profiling.PASSES`)
PASSES = ("anim", "pre_physics", "physics", "post_physics", "deform",
          "morphs", "shadow", "skybox", "ground", "edges", "character",
          "albedo", "mmd", "shade")


@dataclass
class Event:
    name: str
    start: int      # ns
    end: int        # ns
    corr: int = 0
    label: bool = False     # a record_function range


@dataclass
class TraceSummary:
    """One traced segment of `frames` frames of one kind of cell."""
    kind: str
    frames: int
    window_s: float
    busy_s: float
    graph_device_s: float = 0.0      # device time launched by graph replays
    graph_kernels: int = 0
    graph_launches: int = 0
    other_device_s: float = 0.0      # device time launched otherwise
    other_launches: int = 0          # host launch calls but graph launches
    label_device_s: dict = field(default_factory=dict)   # pass -> s
    unmatched: int = 0               # device events with no launch found
    device_ops: list = field(default_factory=list)       # [[name, s]]
    idle_gaps: list = field(default_factory=list)        # [[name, s]]
    raster_bound_s: float | None = None   # set by the harness


def collect(prof) -> tuple[list, list]:
    """(host events, device events) of a finished profiler run."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + max(e.duration_ns(), 0)
        if e.device_type() == DeviceType.CPU:
            host.append(Event(e.name(), start, end, e.correlation_id(),
                              bool(e.is_user_annotation())))
        elif e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() in PASSES \
                    or e.name().startswith("bench."):
                continue        # a host range drawn on the device's row
            device.append(Event(e.name(), start, end, e.correlation_id()))
    return host, device


def _innermost(ranges, t):
    """The innermost of `ranges` (Events sorted by start, properly nested)
    that holds time t, or None."""
    best = None
    i = bisect.bisect_right([r.start for r in ranges], t)
    for r in ranges[:i]:
        if r.end >= t and (best is None or r.start >= best.start):
            best = r
    return best


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(host, device, kind: str, frames: int,
              top: int = 10) -> TraceSummary:
    spans = [e for e in host if e.label and e.name == FRAMES]
    if not spans:
        raise ValueError(f"no {FRAMES!r} span in the trace")
    t0 = min(e.start for e in spans)
    t1 = max(e.end for e in spans)
    device = [d for d in device if d.start >= t0 and d.start <= t1]
    t1 = max([t1] + [d.end for d in device])
    host = [h for h in host if h.start >= t0 and h.start <= t1]

    calls = {h.corr: h for h in host
             if not h.label and h.name in HOST_LAUNCH_CALLS}
    passes = sorted((h for h in host if h.label and h.name in PASSES),
                    key=lambda h: h.start)
    s = TraceSummary(kind=kind, frames=frames, window_s=(t1 - t0) / 1e9,
                     busy_s=0.0)
    s.graph_launches = sum(c.name == GRAPH_LAUNCH for c in calls.values())
    s.other_launches = sum(c.name != GRAPH_LAUNCH for c in calls.values())
    by_label = defaultdict(float)
    by_name = defaultdict(float)
    for d in device:
        dur = (d.end - d.start) / 1e9
        by_name[d.name] += dur
        call = calls.get(d.corr)
        if call is None:
            s.unmatched += 1
            s.other_device_s += dur
            continue
        if call.name == GRAPH_LAUNCH:
            s.graph_device_s += dur
            s.graph_kernels += not d.name.startswith(("Memcpy", "Memset"))
        else:
            s.other_device_s += dur
            label = _innermost(passes, call.start)
            if label is not None:
                by_label[label.name] += dur
    s.label_device_s = dict(by_label)
    busy = _union([(max(d.start, t0), min(d.end, t1)) for d in device])
    s.busy_s = sum(e - b for b, e in busy) / 1e9
    s.device_ops = [[n, v] for n, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:top]]

    # idle gaps, each named by the innermost host range open at its middle
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    ranges = sorted(host, key=lambda h: h.start)
    labels = [h for h in ranges if h.label]
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        lab = _innermost(labels, mid)
        op = _innermost(ranges, mid)
        name = "/".join(dict.fromkeys(
            x.name for x in (lab, op) if x is not None)) or "host"
        s.idle_gaps.append([name, (b - a) / 1e9])
    return s
