"""Runtime configuration.

The port's own copy of `simple_mmd_renderer_tpu/config.py`: the same three
dataclasses with the same fields and defaults (`main.cpp:151-239` and
`main.cpp:2502-2504` of the reference app). The port reads a subset of the
render options; `render/pipeline.py` raises NotImplementedError for the
ones it has not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _v(*xs):
    return field(default_factory=lambda: np.array(xs, np.float32))


@dataclass
class RenderConfig:
    # window / framebuffer (main.cpp:2502-2504)
    width: int = 1280
    height: int = 720
    clear_color: np.ndarray = _v(0.1, 0.1, 0.15)
    # the reference app renders with 4x MSAA (main.cpp:2504). msaa >= 4 runs
    # per-sample MSAA in the tiled raster kernel (4 rotated-grid samples per
    # pixel, shaded once per pixel, coverage resolve); msaa_supersample=True
    # renders 2x2 supersampled at msaa=1 and box-filters down instead
    msaa: int = 1
    msaa_supersample: bool = False

    # camera (main.cpp:151-156; clip planes main.cpp:1897)
    camera_pos: np.ndarray = _v(0.2, 1.6, -4.0)
    camera_target: np.ndarray = _v(0.0, 1.1, 0.0)
    camera_fov_deg: float = 45.0
    # orthographic projection (VMD camera tracks' "perspective off" flag)
    camera_orthographic: bool = False
    near: float = 0.1
    far: float = 1000.0

    # directional light (main.cpp:228-233)
    light_direction: np.ndarray = field(default_factory=lambda: (
        np.array([0.3, -1.0, 0.2], np.float32)
        / np.linalg.norm([0.3, -1.0, 0.2])).astype(np.float32))
    light_color: np.ndarray = _v(1.0, 1.0, 1.0)
    light_intensity: float = 1.0

    # shadows (main.cpp:218, 232; frustum main.cpp:1996-2003)
    shadows_enabled: bool = True
    shadow_map_size: int = 2048
    shadow_frustum_half: float = 5.0
    shadow_near: float = 0.1
    shadow_far: float = 100.0
    # albedo sampling restricted to the character's screen bbox
    albedo_window: bool = True
    # mip levels of the packed texture atlas (0/1 = off, the reference's
    # sampler)
    texture_mips: int = 0
    # per-frame resident mip mini-atlas (0 = off, 1 = auto slot, >= 64 =
    # explicit slot edge)
    texture_resident: int = 1
    # shadow raster restricted to the casters' tile bounding box
    # (ops/tiled_raster.rasterize_depth_tiled_window), for maps of at least
    # 1024^2; the map it gives equals the full raster's
    shadow_window: bool = False
    # bin only the valid (not culled) triangles in the single-instance tiled
    # raster
    compact_bin: bool = True
    # the ground's shadow factor is looked up at 1/N resolution and
    # bilinearly upsampled (the 3x3 PCF is already a blur at that scale);
    # 1 = exact per-pixel lookup
    shadow_lookup_downsample: int = 4

    # figure/resin material (main.cpp:235-239)
    rim_power: float = 2.0
    rim_intensity: float = 0.2
    rim_color: np.ndarray = _v(1.0, 1.0, 1.0)
    specular_power: float = 64.0
    specular_intensity: float = 1.0

    # rasterizer path: "auto" and "tiled" run the binned tile raster in the
    # port on every device; "scan" runs the exact scan raster (KS on the
    # card), the reference's choice off the TPU
    raster_mode: str = "auto"

    # toon edge outlines (inverted hull; beyond the reference app)
    show_edges: bool = False
    edge_scale: float = 1.0
    # honour the per-material MAT_DOUBLE_FACE flag (beyond the reference app)
    double_sided: bool = False

    # skybox / ground
    show_skybox: bool = True
    show_ground: bool = True
    ground_size: float = 50.0          # main.cpp:868
    cubemap_size: int = 512            # main.cpp:1074

    # units (main.cpp:753-754)
    mmd_to_meter: float = 0.1


@dataclass
class PhysicsConfig:
    # mmd-bullet_impl.inl:64-89 + UI (main.cpp:1630-1696)
    enabled: bool = True
    gravity_strength: float = 9.8
    gravity_direction: np.ndarray = _v(0.0, -1.0, 0.0)
    world_scale: float = 10.0          # "world is scaled by 10"
    has_floor: bool = True
    floor_friction: float = 0.265
    # the reference app never sets restitution on its ground body, so it
    # keeps Bullet's default 0
    floor_restitution: float = 0.0
    dt: float = 1.0 / 30.0             # main.cpp:1806
    substep_hz: float = 60.0           # stepSimulation internal step
    max_substeps: int = 60
    # XPBD iteration count
    solver_iterations: int = 6


@dataclass
class AppConfig:
    render: RenderConfig = field(default_factory=RenderConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    fps: float = 30.0                  # VMD frame rate (main.cpp:1793)
    animation_playing: bool = True
    # true spherical SDEF skinning for the model's SDEF vertices (beyond the
    # reference app, which ships the matrix-lerp fallback): core.pose.deform,
    # inside the compiled step too
    sdef_true: bool = False
    # UV and material morphs at render time (beyond the reference app, which
    # parses them and applies neither): Scene.extended_morphs feeds
    # render_frame's uv_offsets / part_color on every render path, the
    # crowd's per instance
    apply_extended_morphs: bool = False
