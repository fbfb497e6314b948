"""The multi-device entry points of `parallel.mesh` on the CPU:
`make_mesh`, `band_transform`, `shard_crowd` and `crowd_jit` of the port
against the reference's (`frame_jit`: tests/test_torch_mesh_bands.py).

The reference runs on 4 of the 8 virtual CPU devices tests/conftest.py
makes; the port on `make_mesh(["cpu"] * 4)`, its counterpart (4 shards that
share one device and run in turn). Configuration (tests/test_parallel.py's
`_tiny_scene`): the sample character at density 0.25,
`sample_motion(60, fps_keys=10)`, 4 solver iterations, no skybox, the
reference side at `raster_mode="tiled"`; the port's Scene is built from the
reference's objects through `convert`, and both start from the port's
`crowd_init` state.

- The crowd: 4 instances whose clocks start 7 frames apart, one a shard,
  2 frames. State and posed vertices at tests/test_torch_crowd_step.py's
  tolerances: instance 0 at the slice test's (the IK-driven kinematic
  bodies at 6e-3 / 1.5e-3, the rest at 1e-4), the later clocks at its
  wider ones (the CCD divergence of those frames: IK bodies 1e-2 / 2e-3,
  other bodies pos 2e-3, quat 5e-4, velocities 3e-2), vertices at 2e-2,
  normals at 5e-3. Measured: IK bodies 1.9e-3 / 5.1e-4 (instance 0) and
  8.0e-3 / 1.7e-3 (later), other bodies 9.5e-7 (instance 0) and pos
  4.3e-4, quat 9.8e-5, vel 1.5e-2, omega 6.7e-3 (later); vertices 1.7e-2,
  normals 3.4e-3. Rendered: the fused tiled crowd at 32x32, textured
  (`sample_textures((64, 16))`), shadow 64^2, at the whole-frame
  tolerance (fewer than 2e-3 of an instance's pixels off by more than
  0.02, mean below 1/255; measured: at most 6.5e-4 of an instance's pixels,
  one of 1,024, mean at most 5.1e-5).
- The shared device: the 4 shards share the scene and its compiled step
  for the shard's shape; each shard's outputs are its own tensors, equal to
  the unsharded step's instances (1e-5, velocities 1e-4: a batched product
  over 1 instance may block its sums differently from one over 4;
  measured: vertices 1.9e-6, quat 1.4e-7, vel 7.2e-6, omega 1.2e-5).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.app.sample import sample_textures
from simple_mmd_renderer_tpu.core.physics import PhysicsState as RefPhysics
from simple_mmd_renderer_tpu.core.scene import SimState as RefState
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.parallel import mesh as par

from test_torch_crowd_step import _leaves, port_scene, ref_scene
from test_torch_slice import _ik_driven_bodies
from test_torch_textured_slice import TEXTURES, _assert_frames_close

N_DEV, N_INST, PHASE, FRAMES = 4, 4, 7.0, 2


def _ref_mesh():
    return ref_par.make_mesh(jax.devices()[:N_DEV])


def _port_mesh():
    return par.make_mesh(["cpu"] * N_DEV)


def ref_state(state):
    """The port's state as the reference's SimState: the same numbers."""
    leaves = convert.sim_state_to_numpy(state)
    return RefState(time=jnp.asarray(leaves["time"]), physics=RefPhysics(
        **{k: jnp.asarray(leaves[k]) for k in convert.PHYSICS_LEAVES}))


def in_threads(*jobs):
    """The jobs' results, each run in a thread of its own: the reference's
    programs compile in parallel (the XLA compile, most of their time,
    runs outside the GIL)."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        return [f.result() for f in [pool.submit(job) for job in jobs]]


# ---------------------------------------------------------------------------
# band_transform and make_mesh
# ---------------------------------------------------------------------------

def test_band_transform_bit_equal_to_reference():
    for n in range(1, 9):
        for b in range(n):
            want = np.asarray(ref_par.band_transform(n, b))
            for index in (b, torch.tensor(b), torch.tensor(float(b))):
                got = par.band_transform(n, index)
                assert got.dtype == torch.float32
                assert np.array_equal(got.numpy(), want), (n, b, index)


def test_make_mesh_without_a_card_raises_naming_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=None"):
        par.make_mesh()
    with pytest.raises(RuntimeError, match="devices="):
        par.make_mesh(["cuda:0"] * 2)
    with pytest.raises(ValueError, match="devices"):
        par.make_mesh([])


def test_make_mesh_repeats_a_device():
    mesh = par.make_mesh(["cpu"] * 4, axis="inst")
    assert len(mesh) == 4 and mesh.axis == "inst"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.distinct == (torch.device("cpu"),)


# ---------------------------------------------------------------------------
# shard_crowd and crowd_jit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crowd_scenes():
    """The textured crowd scene (reference, port), the start state and the
    reference's sharded steps over 4 devices: FRAMES frames without
    rendering (state leaves and vertices) and with it (images)."""
    ref = dataclasses.replace(ref_scene(32, 32), part_textures=sample_textures(
        TEXTURES))
    port = port_scene(ref)
    port.part_textures = list(ref.part_textures)
    state0 = par.crowd_init(port, N_INST, phase_frames=PHASE)
    mesh = _ref_mesh()
    start = ref_par.shard_crowd(ref_state(state0), mesh)

    def posed():
        step, s, out = ref_par.crowd_jit(ref, mesh, render=False), start, []
        for _ in range(FRAMES):
            s, _, pos, nrm = step(s)
            out.append((_leaves(s), np.asarray(pos), np.asarray(nrm)))
        return out

    def rendered():
        step = ref_par.crowd_jit(ref, mesh, render=True, width=32, height=32)
        s, out = start, []
        for _ in range(FRAMES):
            s, img = step(s)
            assert len(img.sharding.device_set) == N_DEV
            out.append(np.asarray(img))
        return out

    return (ref, port, state0, *in_threads(posed, rendered))


def test_shard_crowd_splits_the_instance_axis(crowd_scenes):
    _, port, state, _, _ = crowd_scenes
    mesh = _port_mesh()
    sharded = par.shard_crowd(state, mesh)
    assert len(sharded) == N_DEV and sharded.devices == mesh.devices
    for k, shard in enumerate(sharded.shards):
        assert shard.time.shape == (N_INST // N_DEV,)
        assert torch.equal(shard.physics.pos, state.physics.pos[k:k + 1])
        assert shard.physics.pos.data_ptr() != state.physics.pos.data_ptr()
    whole = sharded.gather("cpu")
    assert torch.equal(whole.time, state.time)
    assert torch.equal(whole.physics.vel, state.physics.vel)
    with pytest.raises(ValueError, match="do not split"):
        par.shard_crowd(par.crowd_init(port, 6), mesh)
    with pytest.raises(ValueError, match="axis"):
        par.shard_crowd(state, mesh, axis="rows")


def test_crowd_jit_pose_matches_reference(crowd_scenes):
    ref, port, state, posed, _ = crowd_scenes
    step = par.crowd_jit(port, _port_mesh(), render=False)
    ik = _ik_driven_bodies(ref.static, ref.phys_static)
    s = par.shard_crowd(state, _port_mesh())
    for frame, (want, want_pos, want_nrm) in enumerate(posed):
        s, pose, pos, nrm = step(s)
        assert all(isinstance(x, par.Sharded) for x in (s, pose, pos, nrm))
        got = convert.sim_state_to_numpy(s.gather())
        np.testing.assert_array_equal(got["time"], want["time"])
        for k in convert.PHYSICS_LEAVES:
            np.testing.assert_allclose(got[k][0, ~ik], want[k][0, ~ik],
                                       atol=1e-4, err_msg=f"{frame} {k}")
            np.testing.assert_allclose(
                got[k][0, ik], want[k][0, ik], err_msg=f"{frame} {k} (IK)",
                atol={"pos": 6e-3, "quat": 1.5e-3}.get(k, 1e-4))
            np.testing.assert_allclose(
                got[k][1:, ~ik], want[k][1:, ~ik], err_msg=f"{frame} {k}",
                atol={"pos": 2e-3, "quat": 5e-4}.get(k, 3e-2))
            np.testing.assert_allclose(
                got[k][1:, ik], want[k][1:, ik], err_msg=f"{frame} {k} (IK)",
                atol={"pos": 1e-2, "quat": 2e-3}.get(k, 1e-4))
        np.testing.assert_allclose(pos.gather().numpy(), want_pos,
                                   atol=2e-2, err_msg=f"frame {frame}")
        np.testing.assert_allclose(nrm.gather().numpy(), want_nrm,
                                   atol=5e-3, err_msg=f"frame {frame}")
        assert pose.gather().world.shape == (N_INST, port.rig.n_bones, 4, 4)


def test_crowd_jit_textured_frame_matches_reference(crowd_scenes):
    _, port, state, _, images = crowd_scenes
    step = par.crowd_jit(port, _port_mesh(), width=32, height=32)
    s = state
    for frame, want in enumerate(images):
        s, got = step(s)
        assert isinstance(s, par.Sharded) and isinstance(got, par.Sharded)
        got = got.gather()
        assert got.shape == (N_INST, 32, 32, 3)
        _assert_frames_close(got.numpy(), want, f"frame {frame}")


def test_shards_sharing_a_device_keep_their_own_outputs(crowd_scenes):
    """4 shards on one CPU share the scene's compiled step for their
    shape; each shard's state and vertices are its own tensors, equal to
    the unsharded step's instances, over two steps."""
    _, port, state, _, _ = crowd_scenes
    mesh = _port_mesh()
    step = par.crowd_jit(port, mesh, render=False)
    whole = par.crowd_step_fn(port, render=False)
    s, w = par.shard_crowd(state, mesh), state
    for _ in range(FRAMES):
        s, _, pos, _ = step(s)
        w, _, wpos, _ = whole(w)
        assert len(port._graphs) >= 1
        ptrs = {t.data_ptr() for t in pos.shards} | {
            x.physics.pos.data_ptr() for x in s.shards}
        assert len(ptrs) == 2 * N_DEV
        for k in range(N_DEV):
            sl = slice(k, k + 1)
            assert float((pos.shards[k] - wpos[sl]).abs().max()) <= 1e-5
            for f in convert.PHYSICS_LEAVES:
                tol = 1e-4 if f in ("vel", "omega") else 1e-5
                gap = (getattr(s.shards[k].physics, f)
                       - getattr(w.physics, f)[sl]).abs().max()
                assert float(gap) <= tol, (k, f, float(gap))
            assert torch.equal(s.shards[k].time, w.time[sl])
