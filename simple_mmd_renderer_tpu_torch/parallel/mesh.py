"""Multi-instance (crowd) execution on one device.

Port of `crowd_init` and `crowd_step_fn` of `simple_mmd_renderer_tpu/
parallel/mesh.py`: many instances of one character, each at its own point
of one motion, stepped and rendered by one batched program. The reference
gets the instance axis from `jax.vmap(scene.step_pose)`; here
`Scene.step_pose` takes the crowd state itself and runs every stage once on
instance-major rows (`core.model.CrowdModelTables`,
`core.physics.CrowdPhysicsTables`), and `render.pipeline.
crowd_render_frame` rasterizes all instances in one binning and one kernel
launch per pass. The reference jits the crowd step; here `crowd_step_fn`
replays the scene's compiled step (`Scene.jit_step`: one CUDA graph for
the crowd's shape, one replay a crowd frame) and renders eagerly after it.

The reference's multi-device entry points (`make_mesh`, `shard_crowd`,
`crowd_jit`, `frame_jit`, `band_transform`) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ..core.physics import PhysicsState
from ..core.scene import Scene, SimState
from ..render.pipeline import (build_packed_atlas, crowd_render_frame,
                               crowd_render_supported, render_frame)


def crowd_init(scene: Scene, n: int, phase_frames: float = 7.0) -> SimState:
    """n instance states with staggered animation clocks (independent-
    looking motion from one motion track): every leaf of `init_state`
    repeated along a leading [n] axis, `time = arange(n) * phase_frames /
    fps`."""
    base = scene.init_state()
    physics = PhysicsState(**{
        f.name: getattr(base.physics, f.name)[None].repeat(
            (n,) + (1,) * getattr(base.physics, f.name).dim())
        for f in dataclasses.fields(base.physics)})
    times = torch.arange(n, dtype=torch.float32, device=scene.device) \
        * (phase_frames / scene.config.fps)
    return SimState(time=times, physics=physics)


_FALLBACK_NOTICED: set = set()

# the render config's fields a camera or light track sets
_TRACK_FIELDS = ("camera_pos", "camera_target", "camera_fov_deg",
                 "camera_orthographic", "light_color", "light_direction")


def crowd_step_fn(scene: Scene, render: bool = True, width=None,
                  height=None, atlas_arg: bool = False):
    """Per-frame crowd function over the instance axis: state -> (state',
    pose, positions, normals) without rendering, state -> (state', images
    [I,H,W,3]) with it.

    With textures (`scene.part_textures`) every instance samples one
    shared atlas: with `atlas_arg=True` the one the caller passes, state,
    atlas -> (state', images) (e.g. `scene.packed_atlas()`, whose mip
    chain selects each triangle's level per instance); else one packed
    from the scene's textures without mips when the function is made (the
    atlas the reference's jitted step holds as a constant). The scene's
    skybox (`scene.cubemap`) and MMD maps (`scene.mmd_device_maps()`,
    packed once) go into every crowd frame. With
    `config.apply_extended_morphs` each instance's UV and material morphs
    apply at its own leaf rates (`Scene.extended_morphs` on the batched
    pose: [I, V, 2] offsets and [I, P, 3] factors), under the reference's
    static gate.

    With a VMD camera track (`scene.camera`) the crowd leaves the fused
    frame for the per-instance one, as the reference's does, each instance
    rendered with its own clock's camera and light samples
    (`Scene.frame_config`). The fused frame does not read a light track:
    the reference's fused step passes the scene's render config as it is,
    and so does this one.

    Posing and physics always run batched, as one replay of the scene's
    compiled step on the crowd state (`Scene.jit_step(render=False,
    donate=False)`; on a CPU scene the same capturable step, eagerly). Its
    outputs are copies, so that steps of several crowds may share the
    scene's graph. Rendering goes through the
    fused multi-instance frame when the config allows it
    (`crowd_render_supported`); the supersampled MSAA, a camera track and
    the scan raster, which it does not cover, render instance by instance
    through `render_frame`, with a one-line notice once per process."""
    pose_step = scene.jit_step(render=False, donate=False)
    if not render:
        return pose_step

    cfg_r = scene.config.render
    textures = scene.part_textures
    own = (None if atlas_arg or textures is None
           else build_packed_atlas(textures, device=scene.device))
    look = dict(cubemap=scene.cubemap, mmd_maps=scene.mmd_device_maps())

    def bind(step):
        return step if atlas_arg else (lambda state: step(state, own))

    if crowd_render_supported(cfg_r, camera=scene.camera):
        def step(state, atlas=None):
            state, pose, positions, normals = pose_step(state)
            uv_off, part_color = scene.extended_morphs(pose.leaf_rates)
            images = crowd_render_frame(scene.rig, positions, normals, cfg_r,
                                        width, height, part_textures=textures,
                                        atlas=atlas, uv_offsets=uv_off,
                                        part_color=part_color, **look)
            return state, images
        return bind(step)

    reasons = [r for r, on in (
        ("msaa_supersample", bool(cfg_r.msaa >= 4 and cfg_r.msaa_supersample)),
        ("vmd_camera", scene.camera is not None),
        ("scan_raster", cfg_r.raster_mode == "scan"),
    ) if on]
    key = tuple(reasons)
    if key not in _FALLBACK_NOTICED:
        _FALLBACK_NOTICED.add(key)
        print(f"# crowd: vmap(render_frame) fallback (fused path excluded "
              f"by: {', '.join(reasons) or 'unknown config'})",
              file=sys.stderr)

    def step_fallback(state, atlas=None):
        state, pose, positions, normals = pose_step(state)
        uv_off, part_color = scene.extended_morphs(pose.leaf_rates)
        # the tracks sampled once at every instance's clock ([I] leading)
        batched = scene.frame_config(state.time)
        sampled = [f for f in _TRACK_FIELDS
                   if getattr(batched, f) is not getattr(cfg_r, f)]

        def instance_cfg(i):
            return dataclasses.replace(
                batched, **{f: getattr(batched, f)[i] for f in sampled})
        images = torch.stack([
            render_frame(scene.rig, positions[i], normals[i],
                         instance_cfg(i),
                         part_textures=textures, width=width, height=height,
                         atlas=atlas,
                         uv_offsets=None if uv_off is None else uv_off[i],
                         part_color=(None if part_color is None else
                                     (part_color[0][i], part_color[1][i])),
                         **look)
            for i in range(positions.shape[0])])
        return state, images
    return bind(step_fallback)
