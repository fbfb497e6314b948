"""The port's tracer (`utils/profiling.py`) on the CPU.

- Off (no profiler session), `pass_scope`, `frame`, `host_read` and the
  step's stages enter no `record_function` range and record nothing, a
  whole frame of `Scene.jit_step` included.
- Under `torch.profiler.profile`, spans nest with the right parents and
  frame ordinals, and each lies inside its own profiler range (one clock:
  the profiler's host events and `time.time_ns()`).
- A play frame and a bake frame of a tiny CPU scene record the step's
  stages (host spans of the eager capturable step), `step.launch`, `render`
  (play only) and `host_reads` equal to the sites the frame passes (the
  tiled rasters' compaction forced on, so that `_bin` reads).
- The CCD counter equals a recount of the masked loop's active chains
  (`pose._still_active` wrapped), and the stamped step's outputs are bit
  for bit those of the capturable step without a clock and of the eager
  step.
- A clock's ring: a recorded frame keeps its replay's row through later
  replays, until the ring has wrapped past it.

The scene: the sample character at density 0.5, 64x48, 64^2 shadow map,
`sample_motion(60, fps_keys=10)`, on the CPU.
"""

import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from simple_mmd_renderer_tpu_torch.core import pose as pose_mod
from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.utils import profiling
from simple_mmd_renderer_tpu_torch.utils.graph import (CapturedStep,
                                                       tree_leaves)

import torch_threads  # noqa: F401  (the port's tests' thread cap)

STAGES = ("anim", "pre_physics", "physics", "post_physics", "deform",
          "write_back")


@pytest.fixture(scope="module")
def scene():
    return build_sample_scene(density=0.5, width=64, height=48, shadow=64,
                              device="cpu", n_frames=60, fps_keys=10)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def test_recorder_off_enters_nothing_and_records_nothing(scene,
                                                         monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.frame(), profiling.pass_scope("render"), \
            profiling.host_read("bin"), profiling.stage("anim"):
        pass
    state, image = scene.jit_step(render=True, donate=False)(
        scene.init_state())
    scene.jit_step(render=False)(state)
    assert image.shape == (48, 64, 3)
    assert profiling.recorded() == []


def _host_ranges(prof):
    """name -> the profiler's host ranges of that name, by start."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.is_user_annotation():
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_spans_nest_with_parents_and_ordinals_on_the_profiler_clock():
    with profile() as prof:
        for _ in range(2):
            with profiling.frame():
                with profiling.pass_scope("step.launch"):
                    time.sleep(0.002)
                with profiling.pass_scope("render"):
                    with profiling.host_read("bin"):
                        time.sleep(0.001)
                    with profiling.pass_scope("shadow"):
                        torch.ones(64).sum()
                    with profiling.host_read("bin"), \
                            profiling.pass_scope("inner"):
                        pass
        with profiling.pass_scope("outside"):     # in no frame
            pass
    frames = profiling.recorded()
    assert [f.ordinal for f in frames] == [0, 1]
    parents = {"frame": None, "step.launch": "frame", "render": "frame",
               "host_read.bin": "render", "shadow": "render",
               "inner": "host_read.bin"}
    ranges = _host_ranges(prof)
    seen = {}
    for f in frames:
        assert f.host_reads == {"bin": 2}
        assert sorted(s.name for s in f.spans) == sorted(
            list(parents) + ["host_read.bin"])
        for s in sorted(f.spans, key=lambda s: s.start):
            assert s.parent == parents[s.name] and s.frame == f.ordinal
            assert not s.device and s.end >= s.start
            # the span lies inside its own profiler range; the profiler
            # converts its cycle counter to the same wall clock by a
            # calibration, so tens of microseconds of slack
            lo, hi = ranges[s.name][seen.get(s.name, 0)]
            seen[s.name] = seen.get(s.name, 0) + 1
            assert lo - 50_000 <= s.start and s.end <= hi + 50_000, s
        by_name = {s.name: s for s in f.spans}
        assert by_name["frame"].start <= by_name["step.launch"].start
        assert by_name["render"].end <= by_name["frame"].end
    assert "outside" in ranges


def _sites_passed(monkeypatch):
    """Count the read sites the render passes: `_bin` with compaction and
    `_big_subset` (single and crowd)."""
    passed = {"bin": 0, "big": 0}
    for fn, site in (("_bin", "bin"), ("_bin_crowd", "bin"),
                     ("_big_subset", "big"), ("_big_subset_crowd", "big")):
        orig = getattr(tr, fn)

        def counted(*args, _orig=orig, _site=site, _fn=fn, **kw):
            compact = args[5] if _fn == "_bin" and len(args) > 5 else \
                kw.get("compact", True)
            passed[_site] += bool(compact)
            return _orig(*args, **kw)

        monkeypatch.setattr(tr, fn, counted)
    return passed


@pytest.mark.parametrize("render", [True, False], ids=["play", "bake"])
def test_frame_records_stages_launch_render_and_host_reads(scene, render,
                                                           monkeypatch):
    monkeypatch.setattr(tr, "COMPACT_MIN_T", 0)
    step = scene.jit_step(render=render, donate=False)
    state = step(scene.init_state())[0]       # captured, not recorded
    passed = _sites_passed(monkeypatch)
    with profile():
        step(state)
    (frame,) = profiling.recorded()
    names = [s.name for s in frame.spans]
    for name in STAGES:
        assert names.count(name) == 1
        (s,) = [s for s in frame.spans if s.name == name]
        assert s.parent == "step.launch" and not s.device
    assert names.count("step.launch") == 1 and names.count("frame") == 1
    assert names.count("render") == int(render)
    want = {k: v for k, v in passed.items() if v}
    assert frame.host_reads == want
    if render:
        assert want.get("bin", 0) >= 2     # the shadow map and the frame
        assert sum(n.startswith("host_read.") for n in names) == \
            sum(want.values())
        for s in frame.spans:       # the reads lie in the raster passes
            if s.name.startswith("host_read."):
                assert s.parent in ("shadow", "character")
            if s.name in ("shadow", "character"):
                assert s.parent == "render"
    else:
        assert want == {}
    # the stages lie inside the launch, in order
    launch = next(s for s in frame.spans if s.name == "step.launch")
    stages = [next(s for s in frame.spans if s.name == n) for n in STAGES]
    assert launch.start <= stages[0].start and stages[-1].end <= launch.end
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))


def test_ccd_counter_equals_a_recount_of_the_active_chains(scene,
                                                           monkeypatch):
    state = scene.init_state()
    for _ in range(2):
        state = scene.step_pose(state)[0]
    # the stamped step's bits: the capturable step without a clock, and
    # the eager one
    want = scene.step_pose(state, capturable=True)
    eager = scene.step_pose(state)

    counts = []
    still = pose_mod._still_active

    def recount(done, out=None):
        counts.append((done.numel(), int((~done).sum())))
        return still(done, out)

    monkeypatch.setattr(pose_mod, "_still_active", recount)
    step = CapturedStep(lambda s: scene.step_pose(s, capturable=True),
                        state)
    with profile():
        with profiling.frame():
            step.load(state)
            got = step.replay()
    for a, b, c in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(eager)):
        assert torch.equal(a, b) and torch.equal(a, c)
    (frame,) = profiling.recorded()
    run = sum(n for n, _ in counts)
    useful = sum(u for _, u in counts)
    got_run = sum(r for r, _ in frame.ccd_iterations.values())
    got_useful = sum(u for _, u in frame.ccd_iterations.values())
    assert set(frame.ccd_iterations) == {"pre_physics", "post_physics"}
    assert run > 0 and (got_run, got_useful) == (run, useful)
    # the sample's IK (legs and toes) runs in the first posing pass
    pre = scene.rig.pre_segments
    assert frame.ccd_iterations["pre_physics"][0] == sum(
        s.loop * s.links.shape[0] for s in pre if s.kind != "fk")


def _toy_step(state):
    """A step with the five stages and a CCD-like count in each posing
    pass: state.sum() % 7 flags of 10 set."""
    for name in STAGES[:-1]:
        with profiling.stage(name):
            if name in ("pre_physics", "post_physics"):
                flags = profiling.ccd_actives(name, 10, state.device)
                torch.lt(torch.arange(10), state.sum() % 7, out=flags)
    return state + 1, state * 2


def test_a_frame_keeps_its_row_until_the_ring_wraps(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    step = CapturedStep(_toy_step, torch.zeros(3, dtype=torch.int64))
    step.replay()                               # before the session
    with profile():
        with profiling.frame():
            step.replay()                       # state 1, 1, 1: 3 % 7
    assert profiling.recorded()[0].ccd_iterations == {
        "pre_physics": (10, 3), "post_physics": (10, 3)}
    for _ in range(3):                          # the ring still holds it
        step.replay()
    assert profiling.recorded()[0].ccd_iterations["pre_physics"] == (10, 3)
    step.replay()                               # wrapped: overwritten
    assert profiling.recorded()[0].ccd_iterations == {}
    assert step.clock.replays == 6
    # no stage is timed on the CPU's clock: no untraced replay to give
    assert profiling.untraced_replays(8) == []


def test_clock_columns_follow_the_body_and_refuse_another_order():
    step = CapturedStep(_toy_step, torch.zeros(3, dtype=torch.int64))
    step.replay()
    clock = step.clock
    assert [name for name, _ in clock.stages] == list(STAGES)
    assert list(clock.ccd) == list(profiling.CCD_PASSES)
    cols = [c for _, c in clock.stages] + [
        c + i for c in clock.ccd.values() for i in (0, 1)]
    assert sorted(cols) == list(range(1, len(cols) + 1))
    assert len(cols) < profiling.COLUMNS
    assert clock.stamps == 0                    # no card: no stamp kernel
    assert {p: tuple(f.shape) for p, f in clock.actives.items()} == {
        "pre_physics": (10,), "post_physics": (10,)}

    def swapped(state):
        with profiling.stage("pre_physics"):
            pass
        return _toy_step(state)

    step.step = swapped
    with pytest.raises(ValueError, match="'anim', not 'pre_physics'"):
        step.replay()

    def two_counts(state):
        profiling.ccd_actives("pre_physics", 4, state.device)
        profiling.ccd_actives("post_physics", 4, state.device)
        return state, state

    with pytest.raises(ValueError, match="no stage end"):
        CapturedStep(two_counts, torch.zeros(3)).replay()
    assert profiling.ccd_actives("pre_physics", 4, "cpu") is None


def test_the_recorder_keeps_the_last_frames_only(monkeypatch):
    from collections import deque

    monkeypatch.setattr(profiling, "_frames", deque(maxlen=3))
    with profile():
        for _ in range(5):
            with profiling.frame():
                pass
    assert [f.ordinal for f in profiling.recorded()] == [2, 3, 4]
    profiling.reset()
    with profile():
        with profiling.frame():
            pass
    assert [f.ordinal for f in profiling.recorded()] == [0]
