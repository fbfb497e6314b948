"""Scene: model + motion + physics + renderer, stepped frame by frame
(the benchmark's plain reference).

A frozen copy of `core/scene.py` of the PyTorch port, cut to its eager
form: no CUDA graph, no seek capture, no replica. The per-frame order is
the upstream app's `frame()`:

    time += dt; frame = floor(time * fps)
    SeekFrame -> PrePhysicsPosing -> React(1/30) -> PostPhysicsPosing
    -> Deform -> render

A crowd state (every leaf with a leading instance axis, `time` [I]) goes
through the same `step_pose`, on the instance-major views of the rig and
physics tables. `_seek_state(t)` re-seeds physics from the animation pose
at clock `t`, as the upstream app's Reset does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import AppConfig, RenderConfig
from ..render.camera_anim import sample_camera, sample_light
from ..render.pipeline import (build_mmd_maps, build_packed_atlas,
                               render_frame)
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
    """`Scene(static, phys_static, motion, config, part_textures, cubemap,
    camera, light, mmd_maps, device)`: the reference's fields in its order
    and with its defaults (`config=None` is `AppConfig()`, the reference's
    default factory), then the port's `device`."""

    def __init__(self, static: ModelStatic, phys_static: PhysicsStatic,
                 motion: MotionArrays | None = None,
                 config: AppConfig | None = None,
                 part_textures: list | None = None, cubemap=None,
                 camera=None, light=None, mmd_maps: tuple | None = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config if config is not None else AppConfig()
        self.part_textures = part_textures
        self._atlas_src = self._atlas = None
        # the skybox's cubemap [6,S,S,3] (None: no skybox), moved by .to()
        if cubemap is not None:
            cubemap = torch.as_tensor(cubemap, dtype=torch.float32,
                                      device=device)
        self.register_buffer("cubemap", cubemap)
        # (sphere_textures, sphere_modes, toon_ramps) from
        # formats.textures.load_sphere_maps / load_toon_ramps: the MMD
        # toon / SPH / SPA shading when set
        self.mmd_maps = mmd_maps
        self._mmd_src = self._mmd = None
        self.rig = ModelTables(static, device)
        self.phys = PhysicsTables(phys_static, device)
        self.motion = (MotionTables(motion, device) if motion is not None
                       else None)
        # the VMD camera and light tracks (render.camera_anim.CameraArrays,
        # LightArrays), moved by .to()
        self.camera = camera.to(device) if camera is not None else None
        self.light = light.to(device) if light is not None else None

    @property
    def device(self):
        return self.rig.device

    def packed_atlas(self):
        """The scene's texture atlas (render.pipeline.PackedAtlas, with
        `texture_mips` levels) on its device, or None without textures;
        packed at the first call and kept. Replacing the list or one of its
        textures in place (`scene.part_textures[i] = new`) packs it anew,
        as does a change of `texture_mips`."""
        if self.part_textures is None:
            return None
        mips = int(self.config.render.texture_mips)
        key = (id(self.part_textures),
               tuple(id(t) for t in self.part_textures), mips)
        if self._atlas_src != key:
            self._atlas = build_packed_atlas(self.part_textures,
                                             mip_levels=mips,
                                             device=self.device)
            self._atlas_src = key
        return self._atlas

    def mmd_device_maps(self):
        """The scene's MMD maps in their device form (render.pipeline.
        MmdMaps: the sphere maps packed into one atlas, the ramps and modes
        on the scene's device), or None without `mmd_maps`; packed at the
        first call and kept until `mmd_maps` is replaced or the scene
        moves."""
        if self.mmd_maps is None:
            return None
        if self._mmd_src is not self.mmd_maps:
            self._mmd = build_mmd_maps(self.mmd_maps, self.device)
            self._mmd_src = self.mmd_maps
        return self._mmd

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
        rot[..., 3].fill_(1.0)
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

    def _seek_state(self, t, capturable: bool = False) -> SimState:
        """The state at clock `t` (a 0-d tensor): physics re-seeded from
        the animation pose there, velocities zero."""
        anim_rot, anim_trans, rates = self._sample_anim(t)
        pose = pose_mod.pre_physics_posing(self.rig, anim_rot, anim_trans,
                                           rates, capturable)
        return SimState(time=t.clone(),
                        physics=phys_mod.physics_reset(self.phys, pose))

    def step_pose(self, state: SimState, capturable: bool = False):
        """One animation+physics frame -> (state', pose, positions, normals)
        with the deformed vertices in MMD units. A crowd state (time [I])
        steps all instances at once, each at its own clock, and returns
        every leaf with the leading instance axis. `capturable` runs the
        form a CUDA graph holds (the CCD loop's fixed, masked iteration
        count instead of its early exit: the same bits)."""
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
                                               rates, capturable)
        if self.motion is not None and cfg.physics.enabled \
                and self.phys.n_bodies:
            with pass_scope("physics"):
                physics, pose = phys_mod.physics_react(
                    static, phys, physics, pose, cfg.physics)
        with pass_scope("post_physics"):
            pose = pose_mod.post_physics_posing(static, pose, anim_rot,
                                                anim_trans, rates, capturable)
        with pass_scope("deform"):
            positions, normals = pose_mod.deform(static, pose,
                                                 sdef=cfg.sdef_true)
        if n_inst is not None:
            physics = _per_instance(physics, n_inst)
            pose = _per_instance(pose, n_inst)
            positions = positions.reshape(n_inst, -1, 3)
            normals = normals.reshape(n_inst, -1, 3)
        return SimState(time=time, physics=physics), pose, positions, normals

    def morphed_extra_uvs(self, pose):
        """[N,E,4] extra-UV channels with the frame's ext-UV morphs applied
        (rest values + the offsets at `pose.leaf_rates`; a crowd pose's
        [I, M] rates give [I,N,E,4]). The built-in shader samples no
        extra-UV channel: this is the query surface for custom effects,
        gated like the other extended morphs (AppConfig.
        apply_extended_morphs says whether callers should apply it)."""
        base = self.rig.extra_uvs
        if self.rig.n_morphs == 0 or self.rig.xum_morph.shape[0] == 0:
            return base
        return base + pose_mod.ext_uv_morph_offsets(self.rig, pose.leaf_rates)

    def extended_morphs(self, leaf_rates):
        """(uv_offsets, part_color) for `render_frame` from a pose's leaf
        rates ([M], or [I, M] for a crowd: the outputs then carry the
        instance axis), under the reference's static gate: nothing unless
        `config.apply_extended_morphs` is on and the model has morphs; UV
        offsets only with UV morphs and part textures, the part colour
        (mul, add) only with material morphs."""
        rig = self.rig
        uv_off = part_color = None
        if not (self.config.apply_extended_morphs and rig.n_morphs):
            return uv_off, part_color
        with pass_scope("morphs"):
            if rig.um_morph.shape[0] and self.part_textures is not None:
                uv_off = pose_mod.uv_morph_offsets(rig, leaf_rates)
            if rig.mm_morph.shape[0]:
                part_color = pose_mod.material_morph_factors(rig, leaf_rates)
        return uv_off, part_color

    def frame_config(self, time, camera_override=None) -> RenderConfig:
        """The render config of the frame at clock `time` (the post-step
        time, a tensor): `camera_override` = (eye, target, fov_deg) in
        metres first (the live camera; host or device values, copied to
        the scene's device once here), else the camera track's sample (MMD
        units scaled to metres, with its orthographic flag); then the
        light track's colour and direction. The tracks are sampled on the
        device; nothing is read on the host."""
        rcfg = self.config.render
        dev = self.device
        if self.camera is None and self.light is None \
                and camera_override is None:
            return rcfg
        frame = time * self.config.fps
        if camera_override is not None:
            if any(isinstance(x, torch.Tensor) for x in camera_override):
                eye, target, fov = (torch.as_tensor(x, dtype=torch.float32,
                                                    device=dev)
                                    for x in camera_override)
            else:
                # host values: one copy to the device for all three
                packed = torch.as_tensor(np.concatenate(
                    [np.asarray(x, np.float32).reshape(-1)
                     for x in camera_override]), device=dev)
                eye, target, fov = packed[0:3], packed[3:6], packed[6]
            rcfg = dataclasses.replace(rcfg, camera_pos=eye,
                                       camera_target=target,
                                       camera_fov_deg=fov)
        elif self.camera is not None:
            cam = sample_camera(self.camera, frame)
            scale = rcfg.mmd_to_meter
            rcfg = dataclasses.replace(
                rcfg, camera_pos=cam["eye"] * scale,
                camera_target=cam["target"] * scale,
                camera_fov_deg=cam["fov_deg"],
                camera_orthographic=cam["ortho"])
        if self.light is not None:
            li = sample_light(self.light, frame)
            rcfg = dataclasses.replace(rcfg, light_color=li["color"],
                                       light_direction=li["direction"])
        return rcfg

    def step_and_render(self, state: SimState, width=None, height=None,
                        camera_override=None, atlas=None,
                        proj_transform=None, aspect=None):
        """One frame -> (state', image [H,W,3]). The camera and light come
        from `frame_config` (`camera_override` = (eye, target, fov_deg) in
        metres, else the tracks, sampled at the post-step time). Textures
        sample `atlas`, by default the scene's own (`packed_atlas`); with
        `config.apply_extended_morphs` the UV and material morphs of the
        frame's pose apply (`extended_morphs`). `proj_transform` and
        `aspect` as `render_frame` takes them."""
        state, pose, positions, normals = self.step_pose(state)
        return state, self._render(state.time, pose, positions, normals,
                                   width, height, atlas, camera_override,
                                   proj_transform, aspect)

    def _render(self, time, pose, positions, normals, width, height,
                atlas=None, camera_override=None, proj_transform=None,
                aspect=None):
        if atlas is None:
            atlas = self.packed_atlas()
        uv_off, part_color = self.extended_morphs(pose.leaf_rates)
        return render_frame(self.rig, positions, normals,
                            self.frame_config(time, camera_override),
                            part_textures=self.part_textures,
                            cubemap=self.cubemap, width=width, height=height,
                            uv_offsets=uv_off, part_color=part_color,
                            mmd_maps=self.mmd_device_maps(), atlas=atlas,
                            proj_transform=proj_transform, aspect=aspect)


