"""`parallel.mesh.frame_jit` on the CPU: the port's banded frame against
the reference's and against its own unbanded frame.

The reference renders its bands on 4 of the 8 virtual CPU devices
tests/conftest.py makes; the port on `make_mesh(["cpu"] * 4)` (4 bands
that share one device and render in turn, from one pose step). Scenes as
tests/test_torch_mesh.py builds them (tests/test_parallel.py's
`_tiny_scene`, the reference side at `raster_mode="tiled"`, both sides
from the port's `init_state`), 2 frames each, every frame at the
whole-frame tolerance (fewer than 2e-3 of the pixels off by more than
0.02, mean below 1/255), the state's clock equal and its bodies equal to
the unbanded step's bit for bit (the same compiled step):

- tiled + textured at 128x64 (`sample_textures((32, 16))`; bands of 16
  rows, which the downsample factor 4 divides: the downsampled lit map with
  its geometric halo rows is kept, on both sides). Measured: against the
  reference 8.1e-5 of the pixels beyond 0.02 (one of 8,192), mean 5.4e-6;
  against the unbanded frame none, largest 2.3e-5;
- tiled at 128x40 (bands of 10 rows, which it does not divide: both sides
  render the bands with the exact per-pixel lookup). The port's unbanded
  frame compared is then the scene's with the exact lookup too: the single
  frame keys its choice off the full height (the unbanded frame with the
  downsampled lookup differs by up to 0.39 at 0.59 % of the pixels, the
  shadow's edge). Measured: equal to the reference's and to the unbanded
  frame.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.app.sample import sample_textures
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu_torch.parallel import mesh as par

from test_torch_crowd_step import port_scene, ref_scene
from test_torch_mesh import N_DEV, in_threads, ref_state
from test_torch_textured_slice import _assert_frames_close

FRAMES = 2
CASES = {
    # (width, height, textured)
    "tiled-textured-halo": (128, 64, True),
    "tiled-exact": (128, 40, False),
}


@pytest.fixture(scope="module")
def banded():
    """{case: (port scene, the reference's banded frames, its times)}."""
    mesh = ref_par.make_mesh(jax.devices()[:N_DEV])
    scenes = {}
    for case, (w, h, textured) in CASES.items():
        ref = ref_scene(w, h)
        if textured:
            ref = dataclasses.replace(ref, part_textures=sample_textures(
                (32, 16)))
        port = port_scene(ref)
        if textured:
            port.part_textures = list(ref.part_textures)
        scenes[case] = ref, port

    def frames(ref, port):
        step = ref_par.frame_jit(ref, mesh)
        # replicated from the start, as the step's own state comes back:
        # one compile for both frames
        s = jax.device_put(ref_state(port.init_state()),
                           NamedSharding(mesh, PartitionSpec()))
        images, times = [], []
        for _ in range(FRAMES):
            s, img = step(s)
            assert len(img.sharding.device_set) == N_DEV
            images.append(np.asarray(img))
            times.append(float(s.time))
        return images, times

    out = in_threads(*[lambda sc=sc: frames(*sc) for sc in scenes.values()])
    return {case: (scenes[case][1], *res) for case, res in zip(scenes, out)}


@pytest.mark.parametrize("case", list(CASES))
def test_frame_jit_matches_reference_and_unbanded(banded, case):
    port, want, times = banded[case]
    w, h, _ = CASES[case]
    step = par.frame_jit(port, par.make_mesh(["cpu"] * N_DEV))
    exact = (h // N_DEV) % port.config.render.shadow_lookup_downsample != 0
    assert exact == (case == "tiled-exact")
    full_scene = (par._with_render(port, shadow_lookup_downsample=1)
                  if exact else port)
    full_step = full_scene.jit_step(donate=False)
    s = f = port.init_state()
    for frame in range(FRAMES):
        s, image = step(s)
        f, full = full_step(f)
        assert isinstance(image, par.Sharded) and len(image) == N_DEV
        assert all(b.shape == (h // N_DEV, w, 3) for b in image.shards)
        got = image.gather("cpu")
        assert got.shape == (h, w, 3)
        _assert_frames_close(got[None].numpy(), want[frame][None],
                             f"{case} frame {frame} vs the reference")
        _assert_frames_close(got[None].numpy(), full[None].numpy(),
                             f"{case} frame {frame} vs unbanded")
        assert float(s.time) == times[frame] == float(f.time)
        assert torch.equal(s.physics.pos, f.physics.pos)
