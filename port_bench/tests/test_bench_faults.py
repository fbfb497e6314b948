"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (inputs, the program's scene, the
window, the check against the reference, the cell's own limits) on the CPU
at a tiny size, with one fault planted in the program: a step that returns
its state unchanged; an answer altered where it is produced (a block of an
image, a bone of a baked pose); a drift of the bodies too small for one
frame's limit that builds up frame after frame. The cells run on one chip
and one batch, so no exchange between chips and no part of a batch can be
left out.
"""

from __future__ import annotations

import json
import math

import pytest
import torch

from port_bench import run
from port_bench.cells import HERE, manifest
from port_bench.tests.tiny import tiny_cell
from simple_mmd_renderer_tpu_torch.core import scene as scene_mod
from simple_mmd_renderer_tpu_torch.utils.graph import tree_map

SEED = 2 ** 31 + 777
WORKLOADS = [w["name"] for w in manifest()["workloads"]]
KINDS = {w["name"]: json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                               .read_text(encoding="utf-8"))["kind"]
         for w in manifest()["workloads"]}


def _run(name):
    torch.set_num_threads(2)
    return run.run_cell(tiny_cell(name), SEED, 0.5, trace=False,
                        device="cpu")


@pytest.mark.parametrize("name", WORKLOADS)
def test_state_left_unchanged(monkeypatch, name):
    real = scene_mod.Scene.replay_step

    def unchanged(self, state):
        before = tree_map(torch.clone, state)
        return (before,) + tuple(real(self, state)[1:])
    monkeypatch.setattr(scene_mod.Scene, "replay_step", unchanged)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["clock"]["value"] > out["checks"]["clock"]["limit"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_slow_drift_is_seen(monkeypatch, name):
    # each frame moves every body by 0.9 of one frame's limit: each sampled
    # frame passes, a stretch long enough to add up past the stretch's
    # limit does not (on the tiny cell, in a window long enough to hold it)
    cell = tiny_cell(name)
    step = 0.9 * cell.limits["bodies"]
    frames = math.ceil(cell.limits["stretch_bodies"] / step) + 2
    cell.traffic["stretch_frames"] = frames
    real = scene_mod.Scene.replay_step

    def drifting(self, state):
        state, *rest = real(self, state)
        state.physics.pos.add_(step)
        return (state, *rest)
    monkeypatch.setattr(scene_mod.Scene, "replay_step", drifting)
    torch.set_num_threads(2)
    out = run.run_cell(cell, SEED, 1.0 + 1.5 * frames, trace=False,
                       device="cpu")
    assert out["attempted"] >= frames
    assert out["_check"]["numbers"]["bodies"] <= cell.limits["bodies"]
    assert not out["correct"]
    stretch = out["checks"]["stretch_bodies"]
    assert stretch["value"] > stretch["limit"]


def _alter(image):
    h, w = image.shape[-3:-1]
    image = image.clone()
    image[..., : h // 3, : w // 3, :] = 1.0 - image[..., : h // 3, : w // 3, :]
    return image


@pytest.mark.parametrize(
    "name", [n for n in WORKLOADS if KINDS[n] == "play"])
def test_image_altered_where_produced(monkeypatch, name):
    real = scene_mod.render_frame
    monkeypatch.setattr(scene_mod, "render_frame",
                        lambda *a, **k: _alter(real(*a, **k)))
    assert not _run(name)["correct"]


@pytest.mark.parametrize(
    "name", [n for n in WORKLOADS if KINDS[n] == "bake"])
def test_baked_pose_altered_where_produced(monkeypatch, name):
    real = scene_mod.Scene.replay_step

    def altered(self, state):
        state, pose, pos, nrm = real(self, state)
        world = pose.world.clone()
        world[..., 0, :3, 3] += 1.0     # the first bone moved by one unit
        return state, pose.replace(world=world), pos, nrm
    monkeypatch.setattr(scene_mod.Scene, "replay_step", altered)
    assert not _run(name)["correct"]
