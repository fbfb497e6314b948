"""The ported slice at 4x MSAA against the reference, frame by frame.

Two frames the reference app can render, through
`test_torch_slice.slice_frames` and `check_slice` (the same image, time
and physics tolerances as the msaa=1 slice), with raster_mode="tiled" set
on the reference side before it is jitted. Both render configs draw the
pose of one stepped slice (one pose step a frame in each package, jitted
apart from the two renders on the reference side), 3 frames:

- native MSAA with the windowed shadow map (`msaa=4, shadow_window=True`):
  the sample character at density 0.5, 256x192, 4 solver iterations, and a
  1024^2 shadow map, the least size at which the window applies, so the
  shadow pass runs the windowed raster (K6) and the character pass the
  MSAA raster (K4). The reference's jitted frame at 1024^2 runs
  in about 30 s in interpret mode here, so the frame is tested at that
  size directly; tests/test_torch_msaa_window.py also holds
  `shadow_pass(window=True)` at 1024^2 on a small mesh.
- `msaa_supersample=True`: 2x2 supersampling at msaa=1 (the frame at twice
  the width and height, the ground's lit lookup at twice the downsample)
  and a box filter, 128x96 frames over a 256^2 shadow map.
"""

import pytest

from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

from test_torch_slice import check_slice, slice_frames

import torch_threads  # noqa: F401  (the port's tests' thread cap)

RENDERS = {
    "window": dict(width=256, height=192, shadow_map_size=1024, msaa=4,
                   shadow_window=True),
    "supersample": dict(width=128, height=96, shadow_map_size=256, msaa=4,
                        msaa_supersample=True),
}


@pytest.fixture(scope="module")
def frames():
    """Both render configs over one stepped slice (the two differ only in
    their render config, so they step alike): 3 frames, each rendered
    both ways in both packages; and the MSAA and window kernels' launch
    counters before and after."""
    from __graft_entry__ import _build_scene

    ref = _build_scene(density=0.5, width=256, height=192, shadow=1024,
                       solver_iterations=4, raster_mode="tiled")
    before = (tr.raster_ms_launches, tr.depth_win_launches)
    out = slice_frames(ref, 3, RENDERS)
    return out, before, (tr.raster_ms_launches, tr.depth_win_launches)


def test_msaa_window_slice_matches_reference_three_frames(frames):
    out, before, after = frames
    check_slice(out, ["window"])
    # CPU tensors run the kernels' plain versions
    assert after == before


def test_msaa_supersample_frame_matches_reference(frames):
    check_slice(frames[0], ["supersample"])
