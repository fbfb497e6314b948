"""The crowd slice end to end: `parallel.mesh.crowd_step_fn(scene)` of the
port (batched pose + physics, then the fused frame) against the
reference's, frame by frame, and the supersampled-MSAA fallback.

Configuration and tolerance: tests/test_torch_crowd_render.py's (3
instances with staggered clocks, density 0.25, 128x64, shadow 64^2; fewer
than 2e-3 of an instance's pixels off by more than 0.02, mean absolute
difference below 1/255). Here the port poses its own vertices, so the CCD
divergence of tests/test_torch_crowd_step.py (at most 1.4e-2 MMD units in
a vertex) could move silhouette pixels; at this size it moves none.
Measured over 2 frames: no pixel beyond 0.02, mean 2.2e-10 at msaa=1,
1.9e-6 at msaa=4, 6.9e-10 through the supersampled fallback. The
reference's msaa=1 and msaa=4 crowds are traced into one jax.jit (one
pose step, two fused frames; `reference_frames`).
"""

import numpy as np
import jax
import pytest
import torch

from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.parallel import mesh as par
from simple_mmd_renderer_tpu_torch.render import pipeline

from test_torch_crowd_render import N, _assert_frames_close
from test_torch_crowd_step import port_scene, ref_scene

import torch_threads  # noqa: F401  (the port's tests' thread cap)


@pytest.fixture(scope="module")
def reference_frames():
    """The reference's crowd at msaa=1 and at msaa=4 (N instances, clocks 7
    frames apart), 2 frames, both configurations traced into one jax.jit:
    the batched pose step once a frame (the two scenes differ only in
    their render config, so they pose alike), then each one's fused frame,
    `crowd_render_frame`, which is what the reference's `crowd_step_fn`
    runs after the same pose step for these scenes (no extended morphs,
    textures, skybox, MMD maps or camera track). -> ({msaa: scene}, the
    initial state, [(times, {msaa: images})] a frame)."""
    refs = {msaa: ref_scene(msaa=msaa) for msaa in (1, 4)}
    for ref in refs.values():
        assert ref_pipeline.crowd_render_supported(
            ref.config.render, ref.part_textures, ref.cubemap, ref.camera)
        assert not (ref.config.apply_extended_morphs or ref.mmd_maps)
    pose_step = jax.vmap(refs[1].step_pose)

    def step(state):
        state, _, positions, normals = pose_step(state)
        return state, {msaa: ref_pipeline.crowd_render_frame(
            ref.static, positions, normals, ref.config.render)
            for msaa, ref in refs.items()}

    state0 = ref_par.crowd_init(refs[1], N, phase_frames=7.0)
    step = jax.jit(step)
    frames, state = [], state0
    for _ in range(2):
        state, images = step(state)
        frames.append((np.asarray(state.time),
                       {msaa: np.asarray(v) for msaa, v in images.items()}))
    return refs, state0, frames


@pytest.mark.parametrize("msaa", [1, 4])
def test_crowd_step_fn_end_to_end_two_frames(reference_frames, msaa):
    refs, ref_state, frames = reference_frames
    port = port_scene(refs[msaa])
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    step = par.crowd_step_fn(port)
    for frame, (want_time, want) in enumerate(frames):
        state, got = step(state)
        assert got.shape == (N, 64, 128, 3)
        _assert_frames_close(got.numpy(), want[msaa],
                             f"msaa={msaa} frame {frame}")
        np.testing.assert_array_equal(state.time.numpy(), want_time)
    assert state.physics.pos.shape == (N, port.phys.n_bodies, 3)


def test_supersample_fallback_renders_instance_by_instance(capsys):
    """msaa_supersample is outside the fused frame: the step renders each
    instance through render_frame, says so once, and gives the fused
    msaa=1 frame's shape and the reference fallback's pixels."""
    ref = ref_scene(msaa=4, msaa_supersample=True)
    port = port_scene(ref)
    assert not ref_pipeline.crowd_render_supported(ref.config.render)
    assert not pipeline.crowd_render_supported(port.config.render)
    par._FALLBACK_NOTICED.clear()
    step = par.crowd_step_fn(port)
    par.crowd_step_fn(port)
    err = capsys.readouterr().err
    assert err.count("# crowd: vmap(render_frame) fallback") == 1
    assert "msaa_supersample" in err

    ref_state = ref_par.crowd_init(ref, 2, phase_frames=7.0)
    state, got = step(convert.sim_state_to_torch(ref_state, device="cpu"))
    _, want = jax.jit(ref_par.crowd_step_fn(ref))(ref_state)
    _assert_frames_close(got.numpy(), np.asarray(want), "supersample")

    fused = port_scene(ref_scene())
    _, img1 = par.crowd_step_fn(fused)(par.crowd_init(fused, 2))
    assert got.shape == img1.shape == (2, 64, 128, 3)
    with pytest.raises(NotImplementedError, match="msaa_supersample"):
        pipeline.crowd_render_frame(port.rig, torch.zeros(2, 4, 3),
                                    torch.zeros(2, 4, 3), port.config.render)
