"""`play`: `Scene.jit_step(render=True)`, playback or an offline render from
a seeded start time; a frame is done when its image is on the host as
8-bit RGB, and is timed on the host clock from the previous frame's
completion to its own. The check holds each sampled image against the
reference's render of the same frame."""

from __future__ import annotations

import time

from torch.profiler import record_function

from ..check import Images
from ..loops import Window, _sync, to_host_u8


class Kind:
    kind = "play"

    def __init__(self, scene, cell, inputs, device):
        self.scene, self.device = scene, device
        self.traffic, self.inputs = cell.traffic, inputs
        self.step = scene.jit_step(render=True, donate=False)
        t0 = inputs.start_frame / scene.config.fps
        self.start = scene.seek(scene.init_state(), t0, compiled=False)

    def frame(self, state):
        with record_function("bench.jit_step"):
            state, image = self.step(state)
        with record_function("bench.to_host"):
            return state, to_host_u8(image)

    def warm(self):
        state = self.start
        for _ in range(self.traffic["warmup_frames"]):
            state, _ = self.frame(state)
        _sync(self.device)

    def window(self, seconds) -> Window:
        w = Window(0, 0.0, states=[self.start])
        state = self.start
        _sync(self.device)
        begin = prev = time.perf_counter()
        while True:
            state, image = self.frame(state)
            now = time.perf_counter()
            w.frame_times.append(now - prev)
            w.outputs.append(image)
            w.states.append(state)
            prev = now
            if now - begin >= seconds:
                break
        w.frames, w.seconds = len(w.outputs), now - begin
        return w

    def run_frames(self, state, n, starts=None):
        """n frames from `state`, each in a `bench.frame` span; `starts`
        gathers each frame's start state."""
        for _ in range(n):
            if starts is not None:
                starts.append(state)
            with record_function("bench.frame"):
                state, _ = self.frame(state)
        _sync(self.device)
        return state

    @staticmethod
    def end_to_end(w: Window) -> dict:
        from ..yardstick.stats import per_item_ms, percentile
        return {"frame_ms": per_item_ms(w.seconds, w.frames),
                "frame_ms_p95": 1e3 * percentile(w.frame_times, 95.0)}

    def raster_bound_s(self, starts) -> float:
        """The raster bound of the traced frames, from their deformed
        vertices (the program's step replayed from each frame's start
        state): normals ride the raster, and the UVs too where the frame is
        textured without the albedo window."""
        import torch

        from ..yardstick.raster_bound import frame_bound_s

        rcfg = self.scene.config.render
        uv = self.inputs.textures is not None and not rcfg.albedo_window
        tris = self.scene.rig.triangles
        total = 0.0
        with torch.no_grad():
            for s in starts:
                positions = self.scene.replay_step(s)[2]
                total += sum(frame_bound_s(positions, tris, rcfg,
                                           5 if uv else 3).values())
        return total

    @staticmethod
    def reference_output(sc, state, pose, pos, nrm):
        """The reference's image of a frame, as 8-bit RGB on the host."""
        return to_host_u8(sc._render(state.time, pose, pos, nrm, None, None))

    @staticmethod
    def output_numbers(pairs) -> dict:
        """`px_share` and `px_mean` over every (program, reference) image."""
        images = Images()
        for got, want in pairs:
            images.add(got, want)
        return images.numbers()
