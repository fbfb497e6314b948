"""What decides `correct`: frames the timed window produced, replayed by
the plain reference and compared number by number against each number's
limit (`limits/<cell>.json`, which names the numbers the cell compares).

The reference (`port_bench.reference`) builds its own scene from the same
input files (its own PMX, VMD and HDR readers, its own rig, motion and
physics tables, atlas and cubemap). It checks the window twice:

- on its own: it seeks the start state from the inputs and holds it
  against the program's, then steps it `stretch_frames` frames (the
  traffic's) from there and holds where it ends against the state the
  program ended that frame with, so that an error too small for one frame
  that builds up over many is seen;
- frame by frame: for a sampled frame i it steps the state the program
  started frame i from, and its answer (the traffic kind's
  `reference_output`) is held against the program's frame i and the state
  the program ended frame i with.

The numbers:

- `clock`: the largest gap between the program's clocks and the
  reference's, at the start, after the stretch and at the end of every
  sampled frame (exact arithmetic: limit 0);
- `start_bodies`: the largest gap of a rigid body's position between the
  program's start state and the reference's (MMD units);
- `stretch_bodies`: the same after the reference's own `stretch_frames`
  frames;
- `bodies`: the same over the sampled frames' end states;
- the traffic kind's numbers of the frames' results (`output_numbers`):
  `pose` (bake), the largest gap of an entry of a baked world matrix;
  `px_share` (images), the share of pixels, over every sampled image, with
  a channel more than PX_LEVELS 8-bit levels away from the reference's;
  `px_mean` (images), the mean gap over every channel, in 8-bit levels.
"""

from __future__ import annotations

import dataclasses
import time
from importlib import import_module

import numpy as np
import torch

from .inputs import rng_of
from .scenes import REFERENCE, build_scene

PX_LEVELS = 2


def sample_frames(frames: int, count: int, seed: int) -> list[int]:
    """`count` frames of a window of `frames`, drawn from the seed: the
    first, and the rest at random among the others."""
    rest = rng_of(seed, 1).permutation(np.arange(1, frames))
    return sorted([0] + [int(i) for i in rest[:max(count - 1, 0)]])


def _map_state(state, fn, mod=None):
    """`state` with fn applied to every tensor, as `mod`'s SimState (by
    default the state's own classes)."""
    sim = mod.SimState if mod is not None else type(state)
    phys = mod.PhysicsState if mod is not None else type(state.physics)
    return sim(time=fn(state.time), physics=phys(**{
        f.name: fn(getattr(state.physics, f.name))
        for f in dataclasses.fields(state.physics)}))


def _gap(a, b) -> float:
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max()) if a.numel() else 0.0


class Images:
    """Pixel gaps summed over every image compared."""

    def __init__(self):
        self.off = self.total = self.channels = 0
        self.level_sum = 0.0

    def add(self, got, want):
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        self.off += int((d.amax(-1) > PX_LEVELS).sum())
        self.total += d[..., 0].numel()
        self.level_sum += float(d.sum(dtype=torch.float64))
        self.channels += d.numel()

    def numbers(self) -> dict:
        return {"px_share": self.off / max(self.total, 1),
                "px_mean": self.level_sum / max(self.channels, 1)}


@dataclasses.dataclass
class Sampled:
    """What the check keeps of a window: the start state, for each sampled
    frame the state it started from, the state it ended with and its host
    result, and the stretch: (its frames, the state the program ended its
    last frame with), or None (states on the host)."""
    start: object
    frames: list            # [(i, state_in, state_out, output)]
    stretch: tuple | None = None


def keep_samples(window, traffic: dict, seed: int) -> Sampled:
    """The window's start, its stretch (the first `stretch_frames` frames
    of the traffic, or as many as the window made) and its sampled frames
    (`sample_frames` of the traffic, drawn from the seed)."""
    def cpu(state):
        return _map_state(state, lambda t: t.detach().cpu())
    idx = sample_frames(window.frames, int(traffic["sample_frames"]), seed)
    frames = [(i, cpu(window.states[i]), cpu(window.states[i + 1]),
               window.outputs[i]) for i in idx]
    k = min(int(traffic.get("stretch_frames", 0)), window.frames)
    return Sampled(cpu(window.states[0]), frames,
                   (k, cpu(window.states[k])) if k else None)


class Reference:
    """The reference's scene of a run's inputs, on `device`, answering as
    the traffic kind `kind` (`kinds/<kind>.py`'s `Kind`) says."""

    def __init__(self, inputs, config, kind, device):
        self.mod = import_module(f"{REFERENCE}.core.scene")
        self.scene = build_scene(REFERENCE, inputs, config, device)
        self.kind, self.device = kind, device
        self.inputs, self.config = inputs, config

    def start(self):
        """The start state, seeked from the inputs (or as the kind's
        `reference_start` makes it)."""
        own = getattr(self.kind, "reference_start", None)
        if own is not None:
            return own(self)
        sc = self.scene
        t0 = torch.full((), np.float32(self.inputs.start_frame
                                       / sc.config.fps),
                        dtype=torch.float32, device=self.device)
        return sc._seek_state(t0)

    def run_free(self, frames: int):
        """The state after `frames` frames stepped from the reference's own
        start."""
        state = self.start()
        for _ in range(frames):
            state = self.scene.step_pose(state)[0]
        return state

    def frame(self, state_in):
        """(state', result) of one frame from a program state: the kind's
        `reference_output` (an image as 8-bit RGB on the host, a baked
        pose)."""
        sc = self.scene
        state, pose, pos, nrm = sc.step_pose(_map_state(
            state_in, lambda t: t.detach().clone().to(self.device),
            self.mod))
        return state, self.kind.reference_output(sc, state, pose, pos, nrm)


def answers(ref: Reference, sampled: Sampled) -> list:
    """The reference's (state', result) of every sampled frame."""
    return [ref.frame(s_in) for _, s_in, _, _ in sampled.frames]


def numbers(ref: Reference, sampled: Sampled, frames=None, free=None):
    """(numbers, per-frame numbers) of `sampled` against `ref`: the run's
    numbers (the start's, the stretch's, each frame number's worst over the
    sampled frames, the kind's output numbers over every sampled result)
    and each sampled frame's own. `frames` may pass the reference's answers
    ([(state', result)]) and `free` its state after the stretch, computed
    once for several comparisons."""
    start = ref.start()
    out = {"clock": _gap(sampled.start.time, start.time),
           "start_bodies": _gap(sampled.start.physics.pos,
                                start.physics.pos),
           "bodies": 0.0}
    if sampled.stretch is not None:
        k, s_k = sampled.stretch
        r_k = free if free is not None else ref.run_free(k)
        out["clock"] = max(out["clock"], _gap(s_k.time, r_k.time))
        out["stretch_bodies"] = _gap(s_k.physics.pos, r_k.physics.pos)
    if frames is None:
        frames = answers(ref, sampled)
    per_frame = []
    for (_, _, s_out, got), (r_state, want) in zip(sampled.frames, frames):
        f = {"clock": _gap(s_out.time, r_state.time),
             "bodies": _gap(s_out.physics.pos, r_state.physics.pos)}
        f.update(ref.kind.output_numbers([(got, want)]))
        per_frame.append(f)
        out["clock"] = max(out["clock"], f["clock"])
        out["bodies"] = max(out["bodies"], f["bodies"])
    out.update(ref.kind.output_numbers(
        [(got, want) for (_, _, _, got), (_, want)
         in zip(sampled.frames, frames)]))
    return out, per_frame


def within(nums: dict, limits: dict) -> bool:
    """Every number that has a limit at or under it."""
    return all(nums[k] <= lim for k, lim in limits.items() if k in nums)


def judge(nums: dict, per_frame: list, limits: dict):
    """(correct, failed frames, {name: {"value", "limit"}}) over the
    numbers the cell's limits name (each of them has to be read)."""
    missing = sorted(set(limits) - set(nums))
    if missing:
        raise KeyError(f"limits name numbers the check does not read: "
                       f"{missing}")
    table = {k: {"value": nums[k], "limit": lim} for k, lim in limits.items()}
    failed = sum(not within(f, limits) for f in per_frame)
    return within(nums, limits), failed, table


def run_check(inputs, cell, kind, sampled: Sampled, device,
              control: bool = False) -> dict:
    """The numbers of a run, per frame too, and with `control` the
    control's (the reference in TF32 put in the program's place: its own
    start and stretch, and its answers on the program's sampled states,
    held against the reference in float32), with the seconds the check
    took. `kind` is the traffic kind's `Kind`."""
    from .reference import tf32
    t = time.perf_counter()
    ref = Reference(inputs, cell.config, kind, device)
    want = answers(ref, sampled)
    free = (ref.run_free(sampled.stretch[0])
            if sampled.stretch is not None else None)
    result = dict(zip(("numbers", "per_frame"),
                      numbers(ref, sampled, want, free)))
    if control:
        with tf32(True):
            low = answers(ref, sampled)
            start = ref.start()
            stretch = (None if sampled.stretch is None else
                       (sampled.stretch[0], ref.run_free(sampled.stretch[0])))
        as_program = Sampled(start, [
            (i, s_in, r_state, r_out) for (i, s_in, _, _), (r_state, r_out)
            in zip(sampled.frames, low)], stretch)
        result["control"] = numbers(ref, as_program, want, free)[0]
    result["seconds"] = time.perf_counter() - t
    return result
