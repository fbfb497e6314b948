"""`bake`: `Scene.jit_step(render=False)`, a physics bake; a frame's result
is its bone pose (the world matrices), copied to the host in blocks of
`block_frames` with one synchronisation a block. The check holds each
sampled pose against the reference's pose of the same frame."""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import record_function

from ..check import _gap
from ..loops import Window, _sync, clone_state


class Kind:
    kind = "bake"

    def __init__(self, scene, cell, inputs, device):
        self.scene, self.device = scene, device
        self.traffic = cell.traffic
        self.block = int(self.traffic["block_frames"])
        self.step = scene.jit_step(render=False, donate=True)
        t0 = inputs.start_frame / scene.config.fps
        self.start = scene.seek(scene.init_state(), t0, compiled=False)
        b = scene.rig.n_bones
        self.poses = torch.empty((self.block, b, 4, 4), dtype=torch.float32,
                                 device=device)

    def frame(self, state, slot):
        with record_function("bench.jit_step"):
            state, pose, _, _ = self.step(state)
        with record_function("bench.pose_copy"):
            self.poses[slot].copy_(pose.world)
        return state

    def blocks(self, state, n_blocks, keep=None):
        """n_blocks blocks of frames from `state` (a copy is stepped);
        `keep` (a Window) gathers the states and the host blocks."""
        state = clone_state(state)
        for _ in range(n_blocks):
            t0 = time.perf_counter()
            for j in range(self.block):
                state = self.frame(state, j)
                if keep is not None:
                    keep.states.append(clone_state(state))
            self.issue_s = time.perf_counter() - t0
            with record_function("bench.to_host"):
                host = self.poses.to("cpu", copy=True)
            if keep is not None:
                keep.outputs.extend(host.unbind(0))
        return state

    def warm(self):
        self.blocks(self.start, max(1, -(-self.traffic["warmup_frames"]
                                         // self.block)))
        _sync(self.device)

    def window(self, seconds) -> Window:
        w = Window(0, 0.0, states=[self.start])
        state = self.start
        _sync(self.device)
        begin = prev = time.perf_counter()
        rates, issue = [], []
        while True:
            state = self.blocks(state, 1, keep=w)
            now = time.perf_counter()
            rates.append(self.block / (now - prev))
            issue.append(1e3 * self.issue_s / self.block)
            prev = now
            if now - begin >= seconds:
                break
        w.frames, w.seconds = len(w.outputs), now - begin
        # by tenth of the window, each block's rate and the host's ms a frame
        # to issue its frames (about 1e3 / rate where the host paces the
        # card): where a slow stretch falls, and who paces it
        for name, xs in (("frames/s", rates), ("issue ms/frame", issue)):
            tenths = [sum(r) / len(r) for r in (
                xs[i * len(xs) // 10:(i + 1) * len(xs) // 10]
                for i in range(10)) if r]
            print(f"bake blocks: {name} by tenth of the window " + " ".join(
                f"{r:.2f}" for r in tenths), file=sys.stderr)
        return w

    def run_frames(self, state, n, starts=None):
        """n frames from `state` with one copy to the host at the end."""
        state = clone_state(state)
        for j in range(n):
            if starts is not None:
                starts.append(clone_state(state))
            with record_function("bench.frame"):
                state = self.frame(state, j % self.block)
        with record_function("bench.to_host"):
            self.poses.cpu()
        return state

    @staticmethod
    def end_to_end(w: Window) -> dict:
        from ..yardstick.stats import per_second
        return {"bake_frames_per_s": per_second(w.frames, w.seconds)}

    @staticmethod
    def reference_output(sc, state, pose, pos, nrm):
        """The reference's baked pose of a frame, on the host."""
        return pose.world.cpu()

    @staticmethod
    def output_numbers(pairs) -> dict:
        """`pose`: the largest gap of an entry of a world matrix."""
        return {"pose": max(_gap(got, want) for got, want in pairs)}
