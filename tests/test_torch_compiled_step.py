"""The port's compiled frame step on the CPU: `Scene.step_pose(...,
capturable=True)` (the form a CUDA graph holds), `Scene.jit_step`,
`rollout` / `jit_rollout` and the crowd step through them.

Configuration: `__graft_entry__._build_scene` at density 0.5, 64x48, 64^2
shadow map, 4 solver iterations, `sample_motion(90, fps_keys=10)`,
raster_mode="tiled" on the reference side; the port's Scene is built from
the reference's objects through `convert`, on the CPU. The crowd is 4
instances of it with clocks 7 frames apart (`crowd_init`).

- The capturable step (the CCD loop's fixed, masked iteration count) gives
  the eager step's bits (early exit), every state leaf, pose field,
  position and normal, over 3 frames, single and crowd; and the neutral
  pose, whose chains have converged before the first iteration (the eager
  loop runs none, the capturable one all of them, masked), posed alone.
- A guard: while the capturable step runs, reading a tensor on the host
  (`__bool__`, `item`, `tolist`, `__int__`, `__float__`) or making one
  from host data (`torch.tensor`, `torch.from_numpy`, `torch.as_tensor` of
  anything but a tensor, `t[i] = <a Python number>`, which copies a host
  scalar in and, where the target is one element, synchronises on the
  card) raises; the step gets through, single and crowd.
  The eager step, whose CCD exit reads a flag, trips it.
- `jit_step(render=False, donate=False)` and `jit_rollout(3,
  render=False)` against the reference's jitted step (`jit_step(render=
  False)`, 3 frames; the reference's `jit_rollout` is the `lax.scan` of
  the same step, so its state' is the third frame's and its checksums the
  frames' `mean(positions)`): `time` equal, physics leaves at 1e-4, the
  kinematic bodies on IK-driven bones at 6e-3 / 1.5e-3 (pos / quat; PARITY
  D1, the tolerances of tests/test_torch_slice.py), vertices at 2e-2 and
  normals at 5e-3 (tests/test_torch_crowd_step.py's), the checksums at
  2e-2 (a mean moves no more than its largest term). The port's rollout
  equals its own jit_step frames bit for bit.
- One rendered frame of `jit_step(render=True)` against the reference's
  `raster_mode="tiled"` frame (its jitted `render_frame` on its jitted
  step's frame-1 vertices, which is its `step_and_render` here: no camera
  or light track, no material morph, no textures): fewer than 2e-3 of
  pixels off by more than 0.02, mean absolute difference below 1/255.
- `donate`: with it, the function returns the step's own buffers, which
  the next call overwrites; without it, copies that survive the next
  call. The argument state is never written. `rollout` returns a copy.
"""

import contextlib
import dataclasses

import numpy as np
import jax
import pytest
import torch

from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core import pose as pose_mod
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.parallel import mesh as par
from simple_mmd_renderer_tpu_torch.utils.graph import tree_leaves

from test_torch_slice import _ik_driven_bodies

import torch_threads  # noqa: F401  (the port's tests' thread cap)

W, H, FRAMES = 64, 48, 3


@pytest.fixture(scope="module")
def ref():
    from __graft_entry__ import _build_scene

    return _build_scene(density=0.5, width=W, height=H, shadow=64,
                        solver_iterations=4, raster_mode="tiled")


@pytest.fixture(scope="module")
def port(ref):
    return Scene(convert.model_static(ref.static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(ref.motion),
                 convert.app_config(ref.config), device="cpu")


def _state(port, kind):
    return port.init_state() if kind == "single" else par.crowd_init(port, 4)


@pytest.fixture(scope="module")
def eager_frames(port):
    """The eager step's first 3 frames from `port.init_state()`."""
    state, frames = port.init_state(), []
    for _ in range(FRAMES):
        frames.append(port.step_pose(state))
        state = frames[-1][0]
    return frames


def _assert_same_bits(got, want, what):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w) == 15      # time, 4 physics, 8 pose, pos, nrm
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and torch.equal(a, b), f"{what}, leaf {i}"


@pytest.mark.parametrize("kind", ["single", "crowd"])
def test_capturable_step_gives_the_eager_bits(port, eager_frames, kind):
    eager = capt = _state(port, kind)
    for frame in range(FRAMES):
        want = (eager_frames[frame] if kind == "single"
                else port.step_pose(eager))
        got = port.step_pose(capt, capturable=True)
        _assert_same_bits(got, want, f"{kind} frame {frame}")
        eager, capt = want[0], got[0]
    if kind == "crowd":     # staggered clocks: the instances differ
        assert float((got[2][0] - got[2][1]).abs().max()) > 1e-3


def test_capturable_ik_freezes_converged_chains(port, monkeypatch):
    """The neutral pose: every chain has converged before the first CCD
    iteration, so the eager loop runs none and the capturable loop runs
    every one, masked; the pose is the same."""
    calls = []
    fk = pose_mod._fk_bones

    def counted(*args, active=None, **kw):
        calls.append(active is not None)
        return fk(*args, active=active, **kw)

    monkeypatch.setattr(pose_mod, "_fk_bones", counted)
    inputs = port._neutral_inputs()
    want = pose_mod.pre_physics_posing(port.rig, *inputs)
    eager_iters = sum(calls)
    calls.clear()
    got = pose_mod.pre_physics_posing(port.rig, *inputs, capturable=True)
    assert eager_iters == 0 and sum(calls) > 0
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def _refuse(name):
    def call(*args, **kw):
        raise AssertionError(f"the step called {name}")
    return call


@contextlib.contextmanager
def host_guard():
    """Make every host read of a tensor, and every tensor made from host
    data, raise."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
            mp.setattr(torch.Tensor, name, _refuse(name))
        as_tensor = torch.as_tensor

        def tensors_only(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                raise AssertionError("the step made a tensor from host data")
            return as_tensor(data, *args, **kw)

        mp.setattr(torch, "as_tensor", tensors_only)
        setitem = torch.Tensor.__setitem__

        def no_host_scalars(self, index, value):
            if isinstance(value, (bool, int, float)):
                raise AssertionError("the step set a tensor from a host "
                                     "scalar")
            return setitem(self, index, value)

        mp.setattr(torch.Tensor, "__setitem__", no_host_scalars)
        mp.setattr(torch, "tensor", _refuse("torch.tensor"))
        mp.setattr(torch, "from_numpy", _refuse("torch.from_numpy"))
        yield


@pytest.mark.parametrize("kind", ["single", "crowd"])
def test_capturable_step_reads_nothing_on_the_host(port, kind):
    state = _state(port, kind)
    if kind == "crowd":
        port.rig.crowd(4)       # the crowd views are made once, up front
        port.phys.crowd(4, port.rig.n_bones)
    with host_guard():
        new_state, _, positions, _ = port.step_pose(state, capturable=True)
        with pytest.raises(AssertionError, match="__bool__"):
            port.step_pose(state)       # the eager CCD exit reads a flag
    assert new_state.time.shape == state.time.shape
    assert torch.isfinite(positions).all()


@pytest.fixture(scope="module")
def ref_frames(ref):
    """The reference's jitted step, 3 frames from its init_state, and its
    first frame rendered (see the module docstring)."""
    from simple_mmd_renderer_tpu.render.pipeline import render_frame

    step = ref.jit_step(render=False, donate=False)
    state, frames = ref.init_state(), []
    for _ in range(FRAMES):
        state, _, positions, normals = step(state)
        frames.append((state, positions, normals))
    assert ref.camera is None and ref.light is None
    assert ref.part_textures is None and not len(ref.static.mm_morph)
    image = jax.jit(lambda p, n: render_frame(ref.static, p, n,
                                              ref.config.render))(
        *frames[0][1:])
    return ([(st, np.asarray(p), np.asarray(n)) for st, p, n in frames],
            np.asarray(image))


def _assert_state_close(got, ref_state, ik, what):
    got = convert.sim_state_to_numpy(got)
    assert got["time"] == np.asarray(ref_state.time), what
    for k in convert.PHYSICS_LEAVES:
        r = np.asarray(getattr(ref_state.physics, k))
        np.testing.assert_allclose(got[k][~ik], r[~ik], atol=1e-4,
                                   err_msg=f"{what} {k}")
        np.testing.assert_allclose(
            got[k][ik], r[ik], err_msg=f"{what} {k} (IK)",
            atol={"pos": 6e-3, "quat": 1.5e-3}.get(k, 1e-4))


def test_jit_step_and_jit_rollout_match_the_reference(ref, port, ref_frames):
    frames, _ = ref_frames
    ik = _ik_driven_bodies(ref.static, ref.phys_static)
    start = convert.sim_state_to_torch(ref.init_state(), device="cpu")
    step = port.jit_step(render=False, donate=False)
    state, sums = start, []
    for i, (ref_state, ref_pos, ref_nrm) in enumerate(frames):
        state, pose, positions, normals = step(state)
        _assert_state_close(state, ref_state, ik, f"jit_step frame {i}")
        np.testing.assert_allclose(positions.numpy(), ref_pos, atol=2e-2)
        np.testing.assert_allclose(normals.numpy(), ref_nrm, atol=5e-3)
        assert pose.world.shape == (port.rig.n_bones, 4, 4)
        sums.append(positions.mean())

    final, checksums = port.jit_rollout(FRAMES, render=False)(start)
    _assert_state_close(final, frames[-1][0], ik, "jit_rollout")
    np.testing.assert_allclose(checksums.numpy(),
                               [p.mean() for _, p, _ in frames], atol=2e-2)
    # the rollout is the jit_step frames, bit for bit
    assert torch.equal(checksums, torch.stack(sums))
    for a, b in zip(tree_leaves(final), tree_leaves(state)):
        assert torch.equal(a, b)


def test_jit_step_render_matches_the_reference_frame(ref, port, ref_frames):
    _, ref_image = ref_frames
    start = convert.sim_state_to_torch(ref.init_state(), device="cpu")
    state, image = port.jit_step(render=True)(start)
    assert image.shape == ref_image.shape == (H, W, 3)
    d = np.abs(image.numpy() - ref_image)
    assert (d > 0.02).mean() < 2e-3
    assert d.mean() < 1 / 255
    assert float(state.time) == float(ref_frames[0][0][0].time)


@pytest.mark.parametrize("donate", [True, False])
def test_donate_returns_the_buffers_or_copies(port, eager_frames, donate):
    start = port.init_state()
    kept = [t.clone() for t in tree_leaves(start)]
    eager1, eager2 = eager_frames[:2]
    step = port.jit_step(render=False, donate=donate)
    out1 = step(start)
    _assert_same_bits(out1, eager1, "call 1")
    out2 = step(out1[0])
    _assert_same_bits(out2, eager2, "call 2")
    for a, b in zip(tree_leaves(start), kept):      # the argument is read
        assert torch.equal(a, b)
    shared = [a is b for a, b in zip(tree_leaves(out1), tree_leaves(out2))]
    if donate:
        # the step's own buffers: call 2 wrote over what call 1 returned
        assert all(shared)
        assert out1[0] is port.captured_step(start).state
    else:
        assert not any(shared)
        _assert_same_bits(out1, eager1, "call 1 after call 2")
        # rollout's state' is a copy, not the buffer
        final, _ = port.rollout(start, 2, render=False)
        assert final.time is not port.captured_step(start).state.time
        for a, b in zip(tree_leaves(final), tree_leaves(eager2[0])):
            assert torch.equal(a, b)


def test_moving_the_scene_drops_its_graphs(port):
    port.captured_step(port.init_state())
    assert port._graphs
    port.to("cpu")
    assert not port._graphs
