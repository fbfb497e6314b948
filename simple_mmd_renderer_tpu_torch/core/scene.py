"""Scene: model + motion + physics + renderer, stepped frame by frame.

Port of `simple_mmd_renderer_tpu/core/scene.py`. The per-frame order is the
reference app's `frame()`:

    time += dt; frame = floor(time * fps)
    SeekFrame -> PrePhysicsPosing -> React(1/30) -> PostPhysicsPosing
    -> Deform -> render

`Scene` is an `nn.Module` whose buffers are the static rig, motion and
physics tables (sub-modules `rig`, `motion`, `phys`); every per-frame stage
is a plain function on tensors. The scene runs on the device it was built
for (`device=`, the card unless the caller asks for another), or wherever
`.to()` moves it.

A crowd state (`parallel.mesh.crowd_init`: every leaf with a leading
instance axis, `time` [I]) goes through the same `step_pose`: the stages
run once, on the instance-major views of the rig and physics tables, so a
crowd step makes about the launches of a single step, whatever I.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import AppConfig, RenderConfig
from ..render.pipeline import render_frame
from ..utils.device import resolve_device
from ..utils.profiling import pass_scope
from . import anim as anim_mod
from . import physics as phys_mod
from . import pose as pose_mod
from .anim import MotionArrays, MotionTables
from .model import ModelStatic, ModelTables
from .physics import PhysicsState, PhysicsStatic, PhysicsTables


@dataclass
class SimState:
    time: torch.Tensor           # f32 scalar, seconds ([I] for a crowd)
    physics: PhysicsState        # leaves [R,...] ([I,R,...] for a crowd)


def _flat(x):
    """[I, K, ...] -> [I*K, ...] (instance-major rows)."""
    return x.reshape((-1,) + x.shape[2:])


def _per_instance(obj, n_inst):
    """A dataclass of [I*K, ...] tensors -> the same with [I, K, ...]."""
    return type(obj)(**{
        f.name: getattr(obj, f.name).reshape(
            (n_inst, -1) + getattr(obj, f.name).shape[1:])
        for f in dataclasses.fields(obj)})


class Scene(nn.Module):
    def __init__(self, static: ModelStatic, phys_static: PhysicsStatic,
                 motion: MotionArrays | None = None,
                 config: AppConfig | None = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config if config is not None else AppConfig()
        self.rig = ModelTables(static, device)
        self.phys = PhysicsTables(phys_static, device)
        self.motion = (MotionTables(motion, device) if motion is not None
                       else None)

    @property
    def device(self):
        return self.rig.device

    def init_state(self) -> SimState:
        pose = self._neutral_pose()
        return SimState(
            time=torch.zeros((), dtype=torch.float32, device=self.device),
            physics=phys_mod.physics_reset(self.phys, pose))

    def _neutral_pose(self):
        return pose_mod.pre_physics_posing(self.rig, *self._neutral_inputs())

    def _neutral_inputs(self, lead=()):
        dev = self.device
        b = self.rig.n_bones
        rot = torch.zeros(lead + (b, 4), dtype=torch.float32, device=dev)
        rot[..., 3] = 1.0
        trans = torch.zeros(lead + (b, 3), dtype=torch.float32, device=dev)
        rates = torch.zeros(lead + (self.rig.n_morphs,), dtype=torch.float32,
                            device=dev)
        return rot, trans, rates

    def _sample_anim(self, time):
        """Motion pose inputs at `time` seconds (neutral without motion);
        a crowd's times [I] give a leading instance axis."""
        if self.motion is None:
            return self._neutral_inputs(tuple(time.shape))
        frame = torch.floor(time * self.config.fps)
        return anim_mod.sample_motion(self.motion, frame)

    def step_pose(self, state: SimState):
        """One animation+physics frame -> (state', pose, positions, normals)
        with the deformed vertices in MMD units. A crowd state (time [I])
        steps all instances at once, each at its own clock, and returns
        every leaf with the leading instance axis."""
        static, phys = self.rig, self.phys
        cfg = self.config
        time = state.time + float(np.float32(1.0 / cfg.fps))
        physics = state.physics
        n_inst = time.shape[0] if time.dim() else None

        with pass_scope("anim"):
            anim_rot, anim_trans, rates = self._sample_anim(time)
        if n_inst is not None:
            # instance-major rows: [I, K, ...] -> [I*K, ...] on the views
            static = static.crowd(n_inst)
            phys = phys.crowd(n_inst, self.rig.n_bones)
            anim_rot, anim_trans = _flat(anim_rot), _flat(anim_trans)
            rates = rates.reshape(-1)
            physics = PhysicsState(**{
                f.name: _flat(getattr(physics, f.name))
                for f in dataclasses.fields(physics)})
        with pass_scope("pre_physics"):
            pose = pose_mod.pre_physics_posing(static, anim_rot, anim_trans,
                                               rates)
        if self.motion is not None and cfg.physics.enabled \
                and self.phys.n_bodies:
            with pass_scope("physics"):
                physics, pose = phys_mod.physics_react(
                    static, phys, physics, pose, cfg.physics)
        with pass_scope("post_physics"):
            pose = pose_mod.post_physics_posing(static, pose, anim_rot,
                                                anim_trans, rates)
        with pass_scope("deform"):
            positions, normals = pose_mod.deform(static, pose,
                                                 sdef=cfg.sdef_true)
        if n_inst is not None:
            physics = _per_instance(physics, n_inst)
            pose = _per_instance(pose, n_inst)
            positions = positions.reshape(n_inst, -1, 3)
            normals = normals.reshape(n_inst, -1, 3)
        return SimState(time=time, physics=physics), pose, positions, normals

    def step_and_render(self, state: SimState, width=None, height=None):
        """One frame -> (state', image [H,W,3])."""
        state, _, positions, normals = self.step_pose(state)
        image = render_frame(self.rig, positions, normals, self.config.render,
                             width=width, height=height)
        return state, image

    def rollout(self, state: SimState, n_frames: int, render: bool = True,
                width=None, height=None):
        """N frames -> (state', per-frame checksums [N]): image.mean() per
        frame when rendering, positions.mean() otherwise."""
        sums = []
        for _ in range(n_frames):
            if render:
                state, image = self.step_and_render(state, width=width,
                                                    height=height)
                sums.append(image.mean())
            else:
                state, _, positions, _ = self.step_pose(state)
                sums.append(positions.mean())
        return state, torch.stack(sums)


def build_sample_scene(density=2.0, width=1920, height=1080, shadow=2048,
                       device="cuda", n_frames=240, fps_keys=5,
                       solver_iterations=None, msaa=1,
                       shadow_window=False) -> Scene:
    """The procedural sample character and motion as a port Scene: no
    skybox, no textures. The defaults are the flagship frame (density 2.0,
    sample_motion(240, fps_keys=5), 1920x1080, 2048^2 shadow map, physics on
    with the default solver iterations, msaa=1); `msaa=4,
    shadow_window=True` is the frame the reference app renders (native
    per-sample MSAA, the windowed shadow raster)."""
    from ..app.sample import sample_character, sample_motion
    from .model import build_model

    device = resolve_device(device)
    static = build_model(sample_character(density=density))
    motion = anim_mod.bind_motion(static, sample_motion(n_frames,
                                                        fps_keys=fps_keys))
    cfg = AppConfig()
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow, show_skybox=False,
                              msaa=msaa, shadow_window=shadow_window)
    if solver_iterations is not None:
        cfg.physics.solver_iterations = solver_iterations
    return Scene(static, phys_mod.build_physics(static), motion, cfg,
                 device=device)
