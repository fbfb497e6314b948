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

The compiled step (`jit_step`, `rollout`, `jit_rollout`; the reference's
`jax.jit` and `lax.scan`) is `step_pose(state, capturable=True)` captured
on the card as one CUDA graph per state shape (`utils.graph.CapturedStep`,
kept by the scene and dropped when `.to()` moves it): one replay a frame,
pose + physics + deform, with no host synchronisation. The render after it
stays eager. On a CPU scene the same capturable step runs eagerly on the
same buffers.

Per-part textures (`part_textures`, NumPy [h,w,3] each) are packed once
into a device atlas (`packed_atlas`, rebuilt when the list or one of its
textures is replaced) that every render of the scene samples. The skybox's
`cubemap` ([6,S,S,3], `render.ibl.equirect_to_cubemap`) is a device buffer
of the scene, and the MMD toon ramps and sphere maps (`mmd_maps`, the
reference's tuple) are packed once into their device form
(`mmd_device_maps`), as the atlas is.

With `config.apply_extended_morphs` every render path (`step_and_render`,
`jit_step(render=True)`, `rollout`, `jit_rollout`) applies the model's UV
and material morphs at the frame's leaf rates (the replay's pose on the
compiled paths); `config.sdef_true` deforms the SDEF vertices spherically,
inside the captured step.

A VMD camera track (`camera`, `render.camera_anim.CameraArrays`) and light
track (`light`, `LightArrays`) are buffers of the scene, sampled on the
device at the frame's post-step time by every render path
(`frame_config`): the camera's eye, target, fov and orthographic flag, the
light's colour and direction (which also steers the shadow frustum). A
`camera_override` (eye, target, fov in metres: the live camera) takes the
camera track's place. `seek` jumps the clock and re-seeds physics from the
animation pose there, captured once per scene as a CUDA graph on the card.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import AppConfig, RenderConfig
from ..render.camera_anim import sample_camera, sample_light
from ..render.pipeline import (build_mmd_maps, build_packed_atlas,
                               render_frame)
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.graph import CapturedStep, shape_key, tree_map
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
        self._graphs: dict = {}      # shape_key(state) -> CapturedStep
        self._seek = None            # the captured seek (CapturedStep)

    def _apply(self, fn, *args, **kwargs):
        # the graphs hold the tables' old addresses and the atlas lies on
        # the old device: moving drops them
        self._graphs.clear()
        self._seek = None
        self._atlas_src = self._atlas = None
        self._mmd_src = self._mmd = None
        return super()._apply(fn, *args, **kwargs)

    @property
    def device(self):
        return self.rig.device

    def replica(self, device) -> "Scene":
        """The scene on `device`, for an entry of a device mesh
        (`parallel.mesh`): the rig, physics and motion tables built there
        anew from the same host tables, the skybox and the camera and light
        tracks copied there, the config, the textures and the MMD maps
        shared (host objects). It holds no graph and no packed atlas or
        maps yet: each is made on `device` at its first use. The scene
        itself is not moved or changed."""
        def copied(track):
            return None if track is None else copy.deepcopy(track)

        return Scene(self.rig.host, self.phys.host,
                     None if self.motion is None else self.motion.host,
                     self.config, self.part_textures, self.cubemap,
                     copied(self.camera), copied(self.light), self.mmd_maps,
                     device=device)

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

    def seek(self, state: SimState, t, compiled: bool = True) -> SimState:
        """Jump the animation clock to `t` seconds (a host number, as the
        reference's): the sequencer scrub. A scrub discards in-flight
        rigid-body dynamics: physics re-seeds from the animation pose at
        the new time, as the reference's Reset does, so hair and skirts do
        not integrate through the time discontinuity. `state` is not read.

        The seek is captured once per scene as a CUDA graph (the posing's
        fixed, masked CCD count), so an interactive scrub replays it on
        every drag tick; on the CPU the same form runs eagerly. `t` goes
        in by a fill: nothing is read on the host. `compiled=False` runs
        the eager form (the CCD early exit), the same bits. Returns a
        fresh state."""
        t = float(np.float32(t))
        if not compiled:
            return self._seek_state(torch.full((), t, dtype=torch.float32,
                                               device=self.device))
        if self._seek is None:
            self._seek = CapturedStep(
                lambda tb: (tb, self._seek_state(tb, capturable=True)),
                torch.zeros((), dtype=torch.float32, device=self.device))
        self._seek.state.fill_(t)
        return tree_map(torch.clone, self._seek.replay()[1])

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

        with profiling.stage("anim"):
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
        with profiling.stage("pre_physics"):
            pose = pose_mod.pre_physics_posing(static, anim_rot, anim_trans,
                                               rates, capturable)
        with profiling.stage("physics"):
            if self.motion is not None and cfg.physics.enabled \
                    and self.phys.n_bodies:
                physics, pose = phys_mod.physics_react(
                    static, phys, physics, pose, cfg.physics)
        with profiling.stage("post_physics"):
            pose = pose_mod.post_physics_posing(static, pose, anim_rot,
                                                anim_trans, rates, capturable)
        with profiling.stage("deform"):
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

    def captured_step(self, state: SimState) -> CapturedStep:
        """The compiled step for states shaped like `state` (a single
        scene's or a crowd's of I instances), captured at the first call
        for that shape."""
        key = shape_key(state)
        if key not in self._graphs:
            self._graphs[key] = CapturedStep(
                lambda s: self.step_pose(s, capturable=True), state)
        return self._graphs[key]

    def replay_step(self, state: SimState):
        """One compiled frame from `state` -> (state', pose, positions,
        normals), the graph's own tensors: the next replay of this shape
        overwrites them. `state` itself is only read."""
        step = self.captured_step(state)
        with pass_scope("step.launch"):
            step.load(state)
            return step.replay()

    def _render(self, time, pose, positions, normals, width, height,
                atlas=None, camera_override=None, proj_transform=None,
                aspect=None):
        with pass_scope("render"):
            if atlas is None:
                atlas = self.packed_atlas()
            uv_off, part_color = self.extended_morphs(pose.leaf_rates)
            return render_frame(self.rig, positions, normals,
                                self.frame_config(time, camera_override),
                                part_textures=self.part_textures,
                                cubemap=self.cubemap, width=width,
                                height=height, uv_offsets=uv_off,
                                part_color=part_color,
                                mmd_maps=self.mmd_device_maps(), atlas=atlas,
                                proj_transform=proj_transform, aspect=aspect)

    def jit_step(self, render: bool = True, width=None, height=None,
                 donate: bool = True):
        """The compiled per-frame function (the reference's `jax.jit` of
        `step_pose` / `step_and_render`): state -> (state', pose, positions,
        normals) with `render=False`, one CUDA-graph replay; state ->
        (state', image) with `render=True`, the replay and then the eager
        `render_frame` (on the scene's atlas, `packed_atlas`), the camera
        and light tracks sampled at the replay's time. The rendering
        function also takes `camera_override` = (eye, target, fov_deg) in
        metres (the live camera), as `step_and_render` does.

        `donate=True` is the counterpart of the reference's buffer
        donation: the function returns the graph's own tensors (state' is
        its input buffer), which the next call overwrites; pass a returned
        state straight back in, or copy what must outlive the next call.
        `donate=False` returns copies. The argument state is never written
        either way."""
        def keep(out):
            return out if donate else tree_map(torch.clone, out)

        if not render:
            def pose_step(state):
                with profiling.frame():
                    return keep(self.replay_step(state))
            return pose_step
        atlas = self.packed_atlas()

        def step(state, camera_override=None):
            with profiling.frame():
                state, pose, positions, normals = self.replay_step(state)
                return keep(state), self._render(state.time, pose, positions,
                                                 normals, width, height,
                                                 atlas, camera_override)
        return step

    def rollout(self, state: SimState, n_frames: int, render: bool = True,
                width=None, height=None, atlas=None):
        """N compiled frames -> (state', per-frame checksums [N]):
        image.mean() per frame when rendering (textures from `atlas`, by
        default the scene's), positions.mean() otherwise.
        The state stays in the graph's buffers from one replay to the next
        (written back inside the graph); with `render=False` nothing is
        read on the host between the first replay and the last. state' is a
        copy."""
        step = self.captured_step(state)
        step.load(state)
        sums = []
        for _ in range(n_frames):
            state, pose, positions, normals = step.replay()
            sums.append(self._render(state.time, pose, positions, normals,
                                     width, height, atlas).mean()
                        if render else positions.mean())
        return tree_map(torch.clone, state), torch.stack(sums)

    def jit_rollout(self, n_frames: int, render: bool = True, width=None,
                    height=None):
        """state -> rollout(state, n_frames, ...) on the compiled step and
        the scene's atlas."""
        atlas = self.packed_atlas() if render else None
        return lambda state: self.rollout(state, n_frames, render=render,
                                          width=width, height=height,
                                          atlas=atlas)


def build_sample_scene(density=2.0, width=1920, height=1080, shadow=2048,
                       device="cuda", n_frames=240, fps_keys=5,
                       solver_iterations=None, msaa=1, shadow_window=False,
                       textures=None, n_parts=2, texture_mips=0,
                       texture_resident=1, albedo_window=True, cubemap=None,
                       show_edges=False, double_sided_parts=(),
                       mmd_maps=None, pmx=None, vmd=None, sdef_true=False,
                       extended_morphs=False) -> Scene:
    """The procedural sample character and motion as a port Scene. The
    defaults are the flagship frame (density 2.0,
    sample_motion(240, fps_keys=5), 1920x1080, 2048^2 shadow map, physics on
    with the default solver iterations, msaa=1, no textures); `msaa=4,
    shadow_window=True` is the frame the reference app renders (native
    per-sample MSAA, the windowed shadow raster).

    `textures`: the edges of procedural per-part textures
    (`app.sample.sample_textures`, e.g. (1024, 256) or
    `realistic_texture_sizes(16)` with `n_parts=16`), one per material part
    of the character (`n_parts`); `texture_mips`, `texture_resident` and
    `albedo_window` set the RenderConfig's fields of those names.

    The rest of the reference frame, each off by default: `cubemap`
    ([6,S,S,3]) draws the skybox; `show_edges` the edge outlines (both of
    the sample's materials carry MAT_DRAW_EDGE); `double_sided_parts`
    flags those materials MAT_DOUBLE_FACE before the model is built and
    turns `double_sided` on; `mmd_maps` (the reference's tuple, e.g.
    `app.sample.sample_mmd_maps`) the MMD toon / sphere shading.

    `pmx` (a PmxModel, e.g. parsed from a file) and `vmd` (a VmdMotion)
    take the place of the sample character (`density` and `n_parts` then
    unused) and of its motion; `sdef_true` and `extended_morphs` set the
    AppConfig's `sdef_true` and `apply_extended_morphs`."""
    from ..app.sample import sample_character, sample_motion, sample_textures
    from ..formats.pmx import MAT_DOUBLE_FACE
    from .model import build_model

    device = resolve_device(device)
    pm = (pmx if pmx is not None
          else sample_character(density=density, n_parts=n_parts))
    for p in double_sided_parts:
        pm.materials[p].draw_flags |= MAT_DOUBLE_FACE
    static = build_model(pm)
    if vmd is None:
        vmd = sample_motion(n_frames, fps_keys=fps_keys)
    motion = anim_mod.bind_motion(static, vmd)
    cfg = AppConfig(sdef_true=sdef_true,
                    apply_extended_morphs=extended_morphs)
    cfg.render = RenderConfig(width=width, height=height,
                              shadow_map_size=shadow,
                              msaa=msaa, shadow_window=shadow_window,
                              texture_mips=texture_mips,
                              texture_resident=texture_resident,
                              albedo_window=albedo_window,
                              show_skybox=cubemap is not None,
                              show_edges=show_edges,
                              double_sided=bool(double_sided_parts))
    if solver_iterations is not None:
        cfg.physics.solver_iterations = solver_iterations
    part_textures = (sample_textures(tuple(textures)) if textures is not None
                     else None)
    return Scene(static, phys_mod.build_physics(static), motion, cfg,
                 part_textures, cubemap, mmd_maps=mmd_maps, device=device)
