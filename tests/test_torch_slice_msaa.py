"""The ported slice at 4x MSAA against the reference, frame by frame.

Two frames the reference app can render, each through
`test_torch_slice.compare_slice` (the same image, time and physics
tolerances as the msaa=1 slice), with raster_mode="tiled" set on the
reference side before it is jitted:

- native MSAA with the windowed shadow map (`msaa=4, shadow_window=True`):
  the sample character at density 0.5, 256x192, 4 solver iterations, and a
  1024^2 shadow map, the least size at which the window applies, so the
  shadow pass runs the windowed raster (K6) and the character pass the
  MSAA raster (K4), 3 frames. The reference's jitted frame at 1024^2 runs
  in about 30 s in interpret mode here, so the frame is tested at that
  size directly; tests/test_torch_msaa_window.py also holds
  `shadow_pass(window=True)` at 1024^2 on a small mesh.
- `msaa_supersample=True`: 2x2 supersampling at msaa=1 (the frame at twice
  the width and height, the ground's lit lookup at twice the downsample)
  and a box filter, one 128x96 frame over a 256^2 shadow map.
"""

import dataclasses

from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

from test_torch_slice import compare_slice

import torch_threads  # noqa: F401  (the port's tests' thread cap)


def _reference_scene(width, height, shadow, **render):
    from __graft_entry__ import _build_scene

    ref = _build_scene(density=0.5, width=width, height=height,
                       shadow=shadow, solver_iterations=4,
                       raster_mode="tiled")
    ref.config.render = dataclasses.replace(ref.config.render, **render)
    return ref


def test_msaa_window_slice_matches_reference_three_frames():
    before = (tr.raster_ms_launches, tr.depth_win_launches)
    compare_slice(_reference_scene(256, 192, 1024, msaa=4,
                                   shadow_window=True), 3)
    # CPU tensors run the kernels' plain versions
    assert (tr.raster_ms_launches, tr.depth_win_launches) == before


def test_msaa_supersample_frame_matches_reference():
    compare_slice(_reference_scene(128, 96, 256, msaa=4,
                                   msaa_supersample=True), 1)
