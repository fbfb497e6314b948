"""The program's own record of the traced frames, read by the per-layer
metrics whose source is `program_span` or `program_counter`.

The program keeps, while a `torch.profiler` session is active, a record of
every frame of `Scene.jit_step` (`utils/profiling.recorded()`): host spans
(`frame`, `step.launch`, `render`, `host_read.<site>`, the pass labels),
the step graph's stages timed on the card (spans with `device=True`) and
the counters `host_reads` and `ccd_iterations`. The traced segment's frames
are the last `t.frames` of it (the warm frame before them is left out).
The stage times are read from the replays just before the traced segment
(`utils/profiling.untraced_replays`), which no profiler paced. A program
without the recorder gives nothing, and so does a record with fewer
frames than were traced.
"""

from __future__ import annotations

import importlib

from ..scenes import PROGRAM


def traced_frames(t):
    """The program's recorded frames of the traced segment `t`, or None."""
    try:
        profiling = importlib.import_module(f"{PROGRAM}.utils.profiling")
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None or t.frames <= 0:
        return None
    frames = recorded()
    if len(frames) < t.frames:
        return None
    return frames[-t.frames:]


# untraced replays the stage readers average: the window's last ones, past
# the slow first seconds that some runs show (PERF.md §2)
UNTRACED_REPLAYS = 64


def stage_device_ms(t, stage: str):
    """Mean device milliseconds of the step graph's `stage` in a replay,
    over the UNTRACED_REPLAYS replays just before the traced segment
    (`utils/profiling.untraced_replays`): under the profiler the graph's
    launch paces a replay at the traced host's speed, so the traced
    frames' stages read the profiler, not the card."""
    if traced_frames(t) is None:
        return None
    profiling = importlib.import_module(f"{PROGRAM}.utils.profiling")
    untraced = getattr(profiling, "untraced_replays", None)
    if untraced is None:
        return None
    spans = [s for replay in untraced(UNTRACED_REPLAYS) for s in replay
             if s.name == stage and s.device]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / len(spans)


def _render_and_reads(f):
    """(the frame's `render` span, its host reads by start) or None."""
    render = [s for s in f.spans if s.name == "render"]
    if len(render) != 1:
        return None
    r = render[0]
    reads = sorted((s for s in f.spans if s.name.startswith("host_read.")
                    and r.start <= s.start and s.end <= r.end),
                   key=lambda s: s.start)
    return r, reads


def render_host_ms(t):
    """Mean host milliseconds a frame in `render` outside its host reads."""
    frames = traced_frames(t)
    if frames is None:
        return None
    total = 0
    for f in frames:
        got = _render_and_reads(f)
        if got is None:
            return None
        r, reads = got
        total += (r.end - r.start) - sum(s.end - s.start for s in reads)
    return total / 1e6 / len(frames)


def render_paced_ms(t):
    """Mean host milliseconds a frame in `render` after its first host read
    returns, outside later host reads: the render's host time that follows
    a wait for the card (0 in a frame with no host read)."""
    frames = traced_frames(t)
    if frames is None:
        return None
    total = 0
    for f in frames:
        got = _render_and_reads(f)
        if got is None:
            return None
        r, reads = got
        if reads:
            total += (r.end - reads[0].end) - sum(
                s.end - s.start for s in reads[1:])
    return total / 1e6 / len(frames)


def render_host_reads(t):
    """Mean host reads a frame in the render (the `host_reads` counter)."""
    frames = traced_frames(t)
    if frames is None or not any(
            s.name == "render" for f in frames for s in f.spans):
        return None
    return sum(sum(f.host_reads.values()) for f in frames) / len(frames)


def ccd_useful_pct(t):
    """100 x the CCD chain-iterations in which the chain was still active
    over those the step ran, both posing passes, over the traced frames."""
    frames = traced_frames(t)
    if frames is None:
        return None
    run = sum(r for f in frames for r, _ in f.ccd_iterations.values())
    useful = sum(u for f in frames for _, u in f.ccd_iterations.values())
    if run <= 0:
        return None
    return 100.0 * useful / run
