"""The readers of the program's own spans and counters
(`yardstick/program.py`, `metrics/*` of source `program_span` and
`program_counter`) on a synthetic record of `utils/profiling.recorded()`
and `untraced_replays()`: the arithmetic, nothing for the other kind of
cell, nothing where the program recorded nothing or has no recorder, and
the warm frame left out."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from port_bench.cells import metric_reader
from port_bench.scenes import PROGRAM
from port_bench.yardstick.trace import TraceSummary

MS = 1_000_000      # ns

STAGE_METRICS = ("anim", "pre_physics", "physics", "post_physics", "deform")
BAKE = [f"{s}_device_ms.bake" for s in STAGE_METRICS] + ["ccd_useful_pct.bake"]
PLAY = ["render_host_ms.play", "render_paced_ms.play",
        "render_host_reads.play"]


def span(name, start, end, device=False, parent=None):
    return SimpleNamespace(name=name, parent=parent, frame=0, start=start,
                           end=end, device=device)


def frame(spans, host_reads=None, ccd=None):
    return SimpleNamespace(ordinal=0, spans=spans,
                           host_reads=host_reads or {},
                           ccd_iterations=ccd or {})


def stages(base, ms):
    """Device spans of the five stages and the write-back, `ms` each."""
    out, t = [], base
    for name, d in zip(STAGE_METRICS + ("write_back",), ms):
        out.append(span(name, t, t + d * MS, device=True))
        t += d * MS
    return out


# the warm frame: large numbers that would move every mean if it counted
WARM = frame([span("frame", 0, 500 * MS), span("render", 0, 400 * MS),
              span("host_read.bin", 10 * MS, 20 * MS)]
             + stages(0, (50, 50, 50, 50, 50, 50)),
             {"bin": 9}, {"pre_physics": (80, 80), "post_physics": (80, 80)})
PLAY_FRAMES = [
    # render 10 ms; reads [2, 3] and [5, 5.5]: host 8.5, paced 7 - 0.5
    frame([span("frame", 0, 12 * MS), span("render", 0, 10 * MS),
           span("host_read.bin", 2 * MS, 3 * MS),
           span("host_read.big", 5 * MS, int(5.5 * MS))],
          {"bin": 1, "big": 1}),
    # no host read: host 4, paced 0
    frame([span("frame", 20 * MS, 25 * MS), span("render", 20 * MS,
                                                 24 * MS)]),
]
# the traced frames' own stages ran at the profiled host's pace: the
# stage readers read the untraced replays before them instead
BAKE_FRAMES = [
    frame([span("frame", 0, 170 * MS), span("step.launch", 0, 160 * MS)]
          + stages(0, (9, 90, 40, 12, 2, 0.5)),
          ccd={"pre_physics": (80, 20), "post_physics": (80, 10)}),
    frame([span("frame", 0, 170 * MS), span("step.launch", 0, 160 * MS)]
          + stages(5, (9, 90, 44, 10, 1, 0.5)),
          ccd={"pre_physics": (80, 30), "post_physics": (80, 0)}),
]
UNTRACED = [stages(0, (1, 10, 40, 12, 2, 0.5)),
            stages(100 * MS, (3, 14, 44, 10, 1, 0.5))]


@pytest.fixture
def record(monkeypatch):
    profiling = importlib.import_module(f"{PROGRAM}.utils.profiling")

    def use(frames, untraced=()):
        monkeypatch.setattr(profiling, "recorded", lambda: list(frames))
        monkeypatch.setattr(profiling, "untraced_replays",
                            lambda n: [list(r) for r in untraced][-n:])
    return use


def summary(kind, frames=2):
    return TraceSummary(kind=kind, frames=frames, window_s=1.0, busy_s=0.5)


def read(name, t):
    return metric_reader(name)(t)


def test_stage_and_ccd_readers(record):
    # host spans of a stage's name (the CPU's) are no device time
    record([WARM] + BAKE_FRAMES, UNTRACED + [[span("anim", 0, 99 * MS)]])
    t = summary("bake")
    want = {"anim": 2.0, "pre_physics": 12.0, "physics": 42.0,
            "post_physics": 11.0, "deform": 1.5}
    for stage, ms in want.items():
        assert read(f"{stage}_device_ms.bake", t) == pytest.approx(ms)
    # (20 + 10 + 30 + 0) useful of 4 x 80 run
    assert read("ccd_useful_pct.bake", t) == pytest.approx(18.75)


def test_render_readers(record):
    record([WARM] + PLAY_FRAMES)
    t = summary("play")
    assert read("render_host_ms.play", t) == pytest.approx((8.5 + 4) / 2)
    assert read("render_paced_ms.play", t) == pytest.approx(6.5 / 2)
    assert read("render_host_reads.play", t) == pytest.approx(1.0)


@pytest.mark.parametrize("name", BAKE + PLAY)
def test_nothing_for_the_other_kind(record, name):
    record([WARM] + BAKE_FRAMES + PLAY_FRAMES, UNTRACED)
    other = "play" if name.endswith(".bake") else "bake"
    assert read(name, summary(other)) is None


@pytest.mark.parametrize("name", BAKE + PLAY)
def test_nothing_recorded_reads_nothing(record, monkeypatch, name):
    t = summary(name.rsplit(".", 1)[1])
    record([])
    assert read(name, t) is None
    # fewer frames than were traced
    record(PLAY_FRAMES[:1] if t.kind == "play" else BAKE_FRAMES[:1],
           UNTRACED)
    assert read(name, t) is None
    # a program without the recorder (the parent of the recorder's PR)
    profiling = importlib.import_module(f"{PROGRAM}.utils.profiling")
    monkeypatch.delattr(profiling, "recorded")
    monkeypatch.delattr(profiling, "untraced_replays")
    assert read(name, t) is None


@pytest.mark.parametrize("stage", STAGE_METRICS)
def test_stage_readers_need_untraced_replays(record, stage):
    """Traced frames but no untraced replay (the CPU, or a step replayed
    only under the profiler): nothing, not the traced frames' stages."""
    record([WARM] + BAKE_FRAMES, [])
    assert read(f"{stage}_device_ms.bake", summary("bake")) is None


def test_the_warm_frame_is_left_out(record):
    record([WARM] + BAKE_FRAMES, UNTRACED)
    assert read("ccd_useful_pct.bake", summary("bake", 2)) == \
        pytest.approx(18.75)
    # counted with it, the share would move
    assert read("ccd_useful_pct.bake", summary("bake", 3)) == \
        pytest.approx(100 * (60 + 160) / (320 + 160))
    record([WARM] + PLAY_FRAMES)
    assert read("render_host_reads.play", summary("play", 2)) == 1.0
    assert read("render_host_reads.play", summary("play", 3)) == \
        pytest.approx(11 / 3)
