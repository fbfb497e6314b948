"""The port's tracer: profiler labels and recorded spans for the sim and
render passes, the step's stage clock, traces, frame statistics and launch
counts.

`pass_scope(name)` is the reference's `utils/profiling.pass_scope` (a
`jax.named_scope`) as a `torch.profiler.record_function` range with the same
name, so a `torch.profiler` trace groups the device work per pass.
`trace(logdir)` (the reference's `jax.profiler.trace`) records a profile of
its body over the host and the card and writes it into `logdir` as a
Chrome trace, where the `pass_scope` labels show. `FrameStats` is the
reference's rolling frame timing, as it is. `launch_counts` reads a trace's
host launch calls and device kernels (used by `chip_smoke.py` and
`scripts/profile_torch_frame.py`).

The recorder. It is on exactly while a `torch.profiler` session is active
(`trace()`, the CLI's `--trace`, any `torch.profiler.profile`); nothing
switches it otherwise. Off, a span costs one flag check and enters nothing.
On, every span is still a `record_function` range, and inside a frame it
is also kept in memory as a `Span` (name, parent, frame ordinal, start,
end), stamped with `time.time_ns()`, the CLOCK_REALTIME clock of the
profiler's host events, so the program's spans and the device trace share
one timeline. The spans:

- `frame` (`frame()`): one call of the function `Scene.jit_step` returns;
  whether it is recorded is decided once, at its start. Its children:
  `step.launch` (loading the state and replaying the step) and `render`
  (`Scene._render`, whose children are the render passes' labels).
- `host_read.<site>` (`host_read(site)`): a read of the card on the host
  in the render, each counted in the frame's `host_reads[site]`: `bin`
  (the compaction count of a tiled raster's binning), `big` (its count of
  oversized triangles), `resident` (the resident mini-atlas's fit).
- the step's stages (`stage(name)`): `anim`, `pre_physics`, `physics`,
  `post_physics` and `deform` in `Scene.step_pose`, then `write_back`
  (the state copied into the step's buffers) in `graph.CapturedStep`
  (`STAGES` names them in that order for the readers). On the card the
  step is one CUDA-graph replay with no host code, so each stage boundary
  is a device timestamp written inside the graph (`StepClock`,
  `csrc/stamp.cu`, columns in the order the body reaches them), and the
  stages come back as spans with `device=True`: durations on the card's
  clock, their alignment with the trace carried by the host spans around
  them. On the CPU the same stages are host spans of the eager
  capturable step.
- the counter `ccd_iterations[pass] = (run, useful)` for the posing passes
  (`ccd_actives(pass, ...)`, `pre_physics` and `post_physics`): the
  chain-iterations the capturable CCD loop runs (a fixed count) and those
  in which the chain was still active, summed at the next stage end
  inside the step (on the card, inside the graph).

`recorded()` returns the recorded frames, with the step's device spans and
counters copied off the card then and only then: a recorded frame adds no
host read and no copy. Read it after the profiler session ends. It keeps
the last `KEPT` frames (1,024, as many as a clock's ring keeps replays),
so a long traced run holds no more; `reset()` forgets them. Under the
profiler the graph's launch paces its replay on the card (the device spans
of a recorded frame follow the traced host's submission), so
`untraced_replays(n)` gives the stage spans of the replays just before
the recorded ones, which ran at the card's own pace: every replay writes
its row, recorded or not. One host thread drives the program, and the
stage code deep in the step reaches the recorder without a parameter
(the step's public signatures are the reference's): the recorder is a
module-level state.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_NOTHING = contextlib.nullcontext()


@dataclass(frozen=True)
class Span:
    """A recorded span: host times from `time.time_ns()`, device times from
    the card's `%globaltimer` (`device=True`), in nanoseconds."""
    name: str
    parent: str | None
    frame: int
    start: int
    end: int
    device: bool = False

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


@dataclass
class Frame:
    """One recorded frame: its spans in the order they ended, and its
    counters."""
    ordinal: int
    spans: list = field(default_factory=list)
    host_reads: dict = field(default_factory=dict)      # site -> reads
    ccd_iterations: dict = field(default_factory=dict)  # pass -> (run, useful)


class _Recording:
    """The frame being recorded: its spans, counters, the names of the
    spans open now, and the step replays it made as (clock, ordinal)."""

    def __init__(self, ordinal):
        self.frame = Frame(ordinal)
        self.open: list[str] = []
        self.replays: list = []


# the recorded frames, oldest first: the last KEPT of them (a frame's step
# row is kept for RING replays of its clock, so no more can be resolved)
KEPT = 1024
_frames: deque[_Recording] = deque(maxlen=KEPT)
_ordinal = 0                       # the next recorded frame's ordinal
_now: _Recording | None = None     # the frame being recorded


class _Span:
    """A `record_function` range, recorded as a Span inside a frame."""

    __slots__ = ("name", "_range", "_rec", "_start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._rec = rec = _now
        if rec is not None:
            rec.open.append(self.name)
            self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            end = time.time_ns()
            rec.open.pop()
            rec.frame.spans.append(Span(
                self.name, rec.open[-1] if rec.open else None,
                rec.frame.ordinal, self._start, end))
        self._range.__exit__(*exc)
        return False


def pass_scope(name: str):
    """Label a render/sim pass in profiler traces (a recorded span inside
    a frame); with no profiler session, nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOTHING
    return _Span(name)


class _Frame(_Span):
    __slots__ = ()

    def __enter__(self):
        global _now, _ordinal
        if _now is None:
            _now = _Recording(_ordinal)
            _ordinal += 1
            _frames.append(_now)
        return super().__enter__()

    def __exit__(self, *exc):
        global _now
        super().__exit__(*exc)
        if self._rec is not None and not self._rec.open:
            _now = None
        return False


def frame():
    """The `frame` span around one frame of the program (see the module
    docstring); recorded when a profiler session is active at its
    start."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOTHING
    return _Frame("frame")


class _HostRead(_Span):
    __slots__ = ("site",)

    def __init__(self, site):
        super().__init__("host_read." + site)
        self.site = site

    def __enter__(self):
        super().__enter__()
        if self._rec is not None:
            reads = self._rec.frame.host_reads
            reads[self.site] = reads.get(self.site, 0) + 1
        return self


def host_read(site: str):
    """The `host_read.<site>` span around a read of the card on the host,
    counted in the frame's `host_reads[site]`."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOTHING
    return _HostRead(site)


def reset() -> None:
    """Forget every recorded frame; the next is frame 0."""
    global _now, _ordinal
    _frames.clear()
    _now = None
    _ordinal = 0


# ---------------------------------------------------------------------------
# The step's stage clock
# ---------------------------------------------------------------------------

# the step's stages in the order `Scene.step_pose` and `CapturedStep` enter
# them: the readers' naming (a clock takes its stages from the body it runs)
STAGES = ("anim", "pre_physics", "physics", "post_physics", "deform",
          "write_back")
# the posing passes whose CCD loop is counted, `ccd_actives(pass, ...)`
CCD_PASSES = ("pre_physics", "post_physics")
# a row of a clock's ring: the replay's start stamp in column 0, then, in
# the order the body first reaches them, a stamp at the end of each stage
# and a (run, useful) pair for each CCD count
COLUMNS = 16
# replays a clock keeps: a recorded frame's row is overwritten after this
# many later replays
RING = 1024

_stepping = None    # the StepClock of the step body running now, or None


class StepClock:
    """The stage timestamps and CCD counts of one compiled step, a row per
    replay in a ring of `rows` rows (int64 [rows, COLUMNS], on the step's
    device). On the card the row is picked by a device counter that the
    replay's first stamp advances, so the graph needs no host input; the
    host counts the replays (`replays`) in step with it, and a recorded
    frame keeps its replay's ordinal. On the CPU the row is the host's
    count and only the CCD counts are written (the stages are host spans
    there).

    The body gives the columns: the k-th stage it ends stamps column
    `stages[k - 1][1]`, and each posing pass's CCD count has the pair at
    `ccd[pass]`, both assigned when the body first reaches them (the
    capture's warm-up, on the card); every later run must end the same
    stages in the same order, as a graph replays them. `stamps` is the
    stamp kernels one run of the body launches, so a replay's, and
    `actives[pass]` the last run's CCD flags of the pass (on the card, the
    buffers the graph writes in every replay)."""

    def __init__(self, device):
        self.rows = RING
        self.ring = torch.zeros((self.rows, COLUMNS), dtype=torch.int64,
                                device=device)
        self.count = torch.zeros((1,), dtype=torch.int64, device=device)
        self.replays = 0
        self.on_card = self.ring.is_cuda
        self.stages: list[tuple[str, int]] = []   # (stage, its end column)
        self.ccd: dict[str, int] = {}             # pass -> its (run, useful)
        self.actives: dict[str, torch.Tensor] = {}
        self.stamps = 0
        self._width = 1         # the columns assigned so far
        self._ended = 0         # stages the running body has ended
        self._launched = 0      # stamps the running body has launched
        self._pending = None    # (pass, flags) for the next stage end

    def _column(self, width: int) -> int:
        col = self._width
        if col + width > COLUMNS:
            raise ValueError(f"a step clock holds {COLUMNS - 1} stage ends "
                             "and CCD counts")
        self._width += width
        return col

    @contextlib.contextmanager
    def running(self):
        """The step body runs with this clock: its stages and CCD loops
        write into the replay's row."""
        global _stepping
        prev, _stepping = _stepping, self
        self._ended = self._launched = 0
        self._pending = None
        try:
            if self.on_card:
                self._stamp(0, advance=True)
            yield
        finally:
            _stepping = prev
            self.stamps = self._launched

    def restart(self) -> None:
        """Row 0 for the next replay (after the capture's warm-up ran)."""
        self.count.zero_()
        self.replays = 0

    def _stamp(self, col, active=None, ccd_col=-1, advance=False):
        from ..ops import _build
        n = 0 if active is None else active.numel()
        rc = _build.entry("smr_stamp")(
            self.ring.data_ptr(), self.count.data_ptr(), self.rows, COLUMNS,
            col, None if active is None else active.data_ptr(), n, ccd_col,
            int(advance), _build.stream_ptr(self.ring.device))
        _build.check(rc, "smr_stamp")
        self._launched += 1

    def actives_for(self, name: str, n: int) -> torch.Tensor:
        """A bool [n] buffer for the CCD flags of posing pass `name`, which
        the next stage end counts."""
        if self._pending is not None:
            raise ValueError(f"the CCD count of {self._pending[0]!r} has no "
                             f"stage end before {name!r}'s")
        buf = torch.empty((n,), dtype=torch.bool, device=self.ring.device)
        self._pending = (name, buf)
        self.actives[name] = buf
        return buf

    @contextlib.contextmanager
    def stage(self, name):
        with pass_scope(name):
            yield
            k, self._ended = self._ended, self._ended + 1
            if k == len(self.stages):
                self.stages.append((name, self._column(1)))
            elif self.stages[k][0] != name:
                raise ValueError(f"stage {k} of the step is "
                                 f"{self.stages[k][0]!r}, not {name!r}")
            col = self.stages[k][1]
            ccd_col, active = -1, None
            if self._pending is not None:
                p, active = self._pending
                self._pending = None
                if p not in self.ccd:
                    self.ccd[p] = self._column(2)
                ccd_col = self.ccd[p]
            if self.on_card:
                self._stamp(col, active, ccd_col)
            elif ccd_col >= 0:
                row = self.ring[self.replays % self.rows]
                row[ccd_col].fill_(active.numel())
                row[ccd_col + 1].copy_(active.sum())

    def kept(self, ordinal) -> bool:
        """Whether replay `ordinal`'s row is still in the ring."""
        return 0 <= ordinal and self.replays - ordinal <= self.rows

    def device_spans(self, row, frame: int) -> list[Span]:
        """A ring row's stages as device spans, in the body's order."""
        out, prev = [], 0
        for name, col in self.stages:
            out.append(Span(name, "step.launch", frame, row[prev], row[col],
                            device=True))
            prev = col
        return out


def stage(name: str):
    """A stage of the step: on the card inside a compiled step, a device
    timestamp at its end (`StepClock`); otherwise a host span."""
    clock = _stepping
    if clock is None:
        return pass_scope(name)
    return clock.stage(name)


def ccd_actives(name: str, n: int, device):
    """A bool [n] buffer for the active flags of posing pass `name`'s
    capturable CCD loops in a compiled step (counted at the next stage
    end; n may be 0: a pass with no IK counts (0, 0)), or None outside
    one."""
    clock = _stepping
    if clock is None:
        return None
    return clock.actives_for(name, n)


def note_replay(clock: StepClock, ordinal: int) -> None:
    """A compiled step replayed: the recorded frame keeps the replay's
    ordinal, to find its row of `clock` in `recorded()`."""
    if _now is not None:
        _now.replays.append((clock, ordinal))


def recorded() -> list[Frame]:
    """The recorded frames, oldest first, each with its host spans, its
    step's device stage spans (on the card) and its counters. Copies each
    clock's ring off the card here, once."""
    rings = {}
    out = []
    for rec in _frames:
        f = rec.frame
        frame = Frame(f.ordinal, list(f.spans), dict(f.host_reads), {})
        for clock, ordinal in rec.replays:
            if id(clock) not in rings:
                rings[id(clock)] = clock.ring.cpu().tolist()
            if not clock.kept(ordinal):
                continue
            row = rings[id(clock)][ordinal % clock.rows]
            if clock.on_card:
                frame.spans.extend(clock.device_spans(row, f.ordinal))
            for p, col in clock.ccd.items():
                run, useful = frame.ccd_iterations.get(p, (0, 0))
                frame.ccd_iterations[p] = (run + row[col],
                                           useful + row[col + 1])
        out.append(frame)
    return out


def untraced_replays(n: int) -> list[list[Span]]:
    """The step's device stage spans (on the card) of the last `n`
    replays made before the first recorded frame's, oldest first, each a
    list in the body's order with frame ordinal -1: replays no profiler
    paced. Under a profiler session the graph's launch submits its kernels
    at the traced host's pace and the card follows it, so a recorded
    frame's stages read that pace; these read the card's own. Copies the
    clock's ring off the card, once."""
    first = next((rec.replays[0] for rec in _frames if rec.replays), None)
    if first is None or not first[0].on_card:
        return []
    clock, ordinal = first
    rows = clock.ring.cpu().tolist()
    return [clock.device_spans(rows[k % clock.rows], -1)
            for k in range(max(0, ordinal - n), ordinal) if clock.kept(k)]


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body (host and, where there is a card, device activity)
    into `logdir`/trace.json, a Chrome trace (chrome://tracing, Perfetto):
    no TensorBoard plugin needed. The frames run inside it are recorded
    (`recorded()`)."""
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
