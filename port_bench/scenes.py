"""One scene from a run's inputs, built by the program or by the reference.

Both packages keep the same module layout and names, so one function builds
both: the files are read by the package's own PMX, VMD and HDR readers and
every table (rig, motion, physics, cubemap, atlas) is built by the
package's own code, as the program's command-line app builds its scene.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

PROGRAM = "simple_mmd_renderer_tpu_torch"
REFERENCE = "port_bench.reference"


def _fields(cls, values: dict, where: str) -> dict:
    """`values` as keyword arguments of the dataclass `cls`, each array
    field's value as an array of its default's type. A key that is no field
    of `cls` is refused: a setting of the file is never dropped."""
    fields = {f.name for f in dataclasses.fields(cls) if f.init}
    unknown = sorted(set(values) - fields)
    if unknown:
        raise KeyError(f"configuration block {where!r}: {unknown} are not "
                       f"fields of {cls.__name__}")
    defaults = cls()
    out = {}
    for k, v in values.items():
        d = getattr(defaults, k)
        out[k] = np.asarray(v, d.dtype) if isinstance(d, np.ndarray) else v
    return out


def app_config(pkg: str, config: dict):
    """The AppConfig of `pkg` that `config` describes: the package's
    defaults (the upstream app's) with every field that the file's
    `render`, `physics` and `app` blocks set over them."""
    cfg_mod = importlib.import_module(f"{pkg}.config")
    app = _fields(cfg_mod.AppConfig, config.get("app", {}), "app")
    for nested in ("render", "physics"):
        if nested in app:
            raise KeyError(f"configuration block 'app': give {nested!r} as "
                           "a block of its own")
    return cfg_mod.AppConfig(
        render=cfg_mod.RenderConfig(**_fields(
            cfg_mod.RenderConfig, config.get("render", {}), "render")),
        physics=cfg_mod.PhysicsConfig(**_fields(
            cfg_mod.PhysicsConfig, config.get("physics", {}), "physics")),
        **app)


def build_scene(pkg: str, inputs, config: dict, device):
    """The Scene of package `pkg` on `device` from `inputs`."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    static = mod("core.model").build_model(mod("formats.pmx").load_pmx(
        inputs.pmx))
    motion = mod("core.anim").bind_motion(static, mod("formats.vmd").load_vmd(
        inputs.vmd))
    cfg = app_config(pkg, config)
    cubemap = None
    if inputs.hdr is not None:
        cubemap = mod("render.ibl").equirect_to_cubemap(
            mod("formats.hdr").load_hdr(inputs.hdr), cfg.render.cubemap_size,
            device=device)
    scene = mod("core.scene").Scene(
        static, mod("core.physics").build_physics(static), motion, cfg,
        inputs.textures, cubemap, device=device)
    return scene
