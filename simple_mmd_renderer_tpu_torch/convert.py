"""Carry state, static tables and configs from the reference package into
the port.

The port has its own copies of the reference's host dataclasses, so the
reference's objects are converted field by field, by class name, into the
port's classes of the same name (nested ones too: the `Segment`s and
`IKProgram`s inside a `ModelStatic`, the PMX `Material`/`RigidBody`/
`Constraint` records, the render and physics configs inside an
`AppConfig`). Array leaves go through `np.asarray` (JAX arrays included), so
this module needs neither JAX nor the reference package:

- `model_static`, `motion_arrays`, `physics_static`, `app_config`: the
  reference's ModelStatic / MotionArrays / PhysicsStatic / AppConfig -> the
  port's.
- `packed_atlas`: the reference's PackedAtlas (its texture atlas, mip
  tables included) -> the port's on a device, so that both packages can
  sample one atlas.
- `cubemap`, `mmd_maps`: the reference's skybox cubemap (a JAX or NumPy
  [6,S,S,3]) -> a float32 tensor on a device, and its `mmd_maps` tuple
  (sphere textures, sphere modes, toon ramps) -> the same tuple of NumPy
  arrays, as `Scene(cubemap=, mmd_maps=)` and `render_frame` take them.
- `camera_arrays`, `light_arrays`: the reference's CameraArrays /
  LightArrays (a bound VMD camera or light track) -> the port's
  `render.camera_anim` modules on a device, as `Scene(camera=, light=)`
  takes them.
- `sim_state_to_torch` / `sim_state_to_numpy`: a SimState (time + the
  physics leaves pos, quat, vel, omega) into torch tensors on a device (by
  default the card, as every entry point) and back to NumPy, so a test can
  start both packages from one `init_state` and compare them frame by
  frame. A crowd state (`parallel.mesh.
  crowd_init`: every leaf with a leading instance axis) converts the same
  way.
- `pose_arrays`, `physics_state`: a PoseArrays / PhysicsState (the
  posing's and the solver's state between the frame's stages) into the
  port's on a device, so that a test can start one stage of both packages
  from the same input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .core import model as _model
from .core.anim import MotionArrays
from .core.physics import PhysicsState, PhysicsStatic
from .core.pose import PoseArrays
from .core.scene import SimState
from .formats import pmx as _pmx
from .render.camera_anim import CameraArrays, LightArrays
from .render.pipeline import PackedAtlas
from .utils.device import resolve_device

PHYSICS_LEAVES = ("pos", "quat", "vel", "omega")

# the port's dataclasses that may sit inside a converted object, by name
_CLASSES = {cls.__name__: cls for cls in (
    _model.IKProgram, _model.Segment, _model.ModelStatic, MotionArrays,
    PhysicsStatic, _pmx.IKLink, _pmx.Bone, _pmx.Material, _pmx.Morph,
    _pmx.RigidBody, _pmx.Constraint, _config.RenderConfig,
    _config.PhysicsConfig, _config.AppConfig)}


def _port(obj, cls=None):
    """A reference leaf, list, dict or dataclass -> the port's form."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = cls or _CLASSES.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no port class for {type(obj).__name__}")
        if isinstance(obj, cls):
            return obj
        return cls(**{f.name: _port(getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _port(v) for k, v in obj.items()}
    if hasattr(obj, "shape") and not isinstance(obj, np.generic):
        return np.asarray(obj)
    return obj


def model_static(static) -> _model.ModelStatic:
    """Reference ModelStatic -> the port's, with its nested segments, IK
    programs and PMX records."""
    return _port(static, _model.ModelStatic)


def motion_arrays(mo) -> MotionArrays:
    return _port(mo, MotionArrays)


def physics_static(ps) -> PhysicsStatic:
    return _port(ps, PhysicsStatic)


def app_config(cfg) -> _config.AppConfig:
    """Reference AppConfig -> the port's, with its nested RenderConfig and
    PhysicsConfig."""
    return _port(cfg, _config.AppConfig)


def packed_atlas(atlas, device="cuda") -> PackedAtlas:
    """Reference PackedAtlas -> the port's on `device`. The reference's
    bit-packed uint32 words are below 2^24, so they become int32 exactly."""
    device = resolve_device(device)

    def t(x, dtype):
        return (None if x is None else
                torch.as_tensor(np.asarray(x).astype(dtype), device=device))
    data = np.asarray(atlas.data)
    return PackedAtlas(
        data=t(data, np.int32 if atlas.eight_bit else np.float32),
        offsets=t(atlas.offsets, np.int32), sizes=t(atlas.sizes, np.float32),
        eight_bit=bool(atlas.eight_bit),
        mip_offsets=t(atlas.mip_offsets, np.int32),
        mip_sizes=t(atlas.mip_sizes, np.float32), n_mips=int(atlas.n_mips),
        mip_meta=tuple(tuple(tuple(int(v) for v in lv) for lv in part)
                       for part in atlas.mip_meta))


def cubemap(cube, device="cuda") -> torch.Tensor:
    """Reference cubemap [6,S,S,3] (JAX or NumPy) -> float32 tensor on
    `device`."""
    return torch.as_tensor(np.asarray(cube, np.float32),
                           device=resolve_device(device))


def mmd_maps(maps) -> tuple:
    """Reference `mmd_maps` (sphere textures [P] of [h,w,3], modes [P],
    toon ramps [P,K,3]; JAX or NumPy leaves) -> the same tuple of NumPy
    arrays (float32 maps and ramps, int32 modes)."""
    texs, modes, ramps = maps
    return ([np.asarray(t, np.float32) for t in texs],
            np.asarray(modes, np.int32), np.asarray(ramps, np.float32))


def camera_arrays(cam, device="cuda") -> CameraArrays:
    """Reference CameraArrays (JAX or NumPy leaves) -> the port's on
    `device`."""
    return CameraArrays(*(np.asarray(getattr(cam, k)) for k in (
        "frames", "targets", "rotations", "distances", "fovs", "ortho",
        "luts")), device=device)


def light_arrays(light, device="cuda") -> LightArrays:
    """Reference LightArrays -> the port's on `device`."""
    return LightArrays(np.asarray(light.frames), np.asarray(light.colors),
                       np.asarray(light.directions), device=device)


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def pose_arrays(pose, device="cuda") -> PoseArrays:
    """Reference PoseArrays (JAX or NumPy leaves) -> the port's on
    `device`."""
    device = resolve_device(device)
    return PoseArrays(**{f.name: _f32(getattr(pose, f.name), device)
                         for f in dataclasses.fields(PoseArrays)})


def physics_state(state, device="cuda") -> PhysicsState:
    """Reference PhysicsState (JAX or NumPy leaves) -> the port's on
    `device`."""
    device = resolve_device(device)
    return PhysicsState(**{k: _f32(getattr(state, k), device)
                           for k in PHYSICS_LEAVES})


def sim_state_to_torch(state, device="cuda") -> SimState:
    """Reference SimState (JAX or NumPy leaves) -> port SimState on
    `device` (the card unless the caller asks for another device; no card
    raises, as every entry point does)."""
    device = resolve_device(device)
    return SimState(time=_f32(state.time, device),
                    physics=physics_state(state.physics, device))


def sim_state_to_numpy(state: SimState) -> dict:
    """Port SimState -> {"time": ndarray, "pos": ..., "quat": ..., "vel":
    ..., "omega": ...} NumPy leaves (the reference's SimState field
    names), for comparison or to rebuild a reference SimState."""
    out = {"time": state.time.detach().cpu().numpy()}
    for k in PHYSICS_LEAVES:
        out[k] = getattr(state.physics, k).detach().cpu().numpy()
    return out
