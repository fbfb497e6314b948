"""The port's command-line renderer and what it reaches: checkpoints
(`utils/checkpoint.py`, across both packages), the PNG writer, the
terminal preview, the keyboard orbit rig, `FrameStats` and `trace`, and
`app/cli.main` itself, against the reference.

Configurations: `cli.main(["--sample", "--device", "cpu", ...])` at 64x48,
shadow 64^2, density 0.25, against the reference Scene built from the same
flags at raster_mode="tiled" (the reference's CLI picks the scan raster
on the CPU, so its own PNGs are not the yardstick); the written inputs of
`chip_smoke.cli_files` (the sample character at density 0.25 as PMX, a VMD
of `sample_motion`'s bone keys with a camera and a light track) at 64x48
for the resume, the tracks and the pose.

Tolerances: the CLI's PNGs against the reference's frames quantized the
same way ((img * 255).astype(uint8)) at the whole-frame tolerance (fewer
than 2e-3 of the pixels off by more than 0.02, mean absolute difference
below 1/255; measured: no pixel beyond 0.02); checkpoints, resumes, the
CLI's frames against the Scene's, the rig's vectors and the preview's
string bit for bit.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import torch_threads  # noqa: F401  (the port's tests' thread cap)

import chip_smoke
from simple_mmd_renderer_tpu.app import cli as ref_cli
from simple_mmd_renderer_tpu.app.sample import (sample_character,
                                                sample_motion)
from simple_mmd_renderer_tpu.config import AppConfig, RenderConfig
from simple_mmd_renderer_tpu.config import RenderConfig as RefRC
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.utils import checkpoint as ref_ckpt
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.app import cli
from simple_mmd_renderer_tpu_torch.config import RenderConfig as PortRC
from simple_mmd_renderer_tpu_torch.core.physics import PhysicsState
from simple_mmd_renderer_tpu_torch.core.scene import SimState
from simple_mmd_renderer_tpu_torch.parallel.mesh import crowd_init
from simple_mmd_renderer_tpu_torch.utils import checkpoint as ckpt
from simple_mmd_renderer_tpu_torch.utils.png import encode_png

from test_torch_textured_slice import _assert_frames_close

SMALL = ["--width", "64", "--height", "48", "--shadow-size", "64",
         "--density", "0.25", "--device", "cpu"]


def _state(seed=0, lead=()):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=lead + shape)
                               .astype(np.float32))
    return SimState(time=t(), physics=PhysicsState(
        pos=t(5, 3), quat=t(5, 4), vel=t(5, 3), omega=t(5, 3)))


def _leaves(state):
    return [state.time] + [getattr(state.physics, k)
                           for k in convert.PHYSICS_LEAVES]


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "crowd"])
def test_checkpoint_round_trip(tmp_path, lead):
    """A state (and a crowd state, leading [I]) saved and loaded bit for
    bit, keyed by the reference's key paths, on the template's device."""
    path = str(tmp_path / "s.npz")
    state = _state(1, lead)
    ckpt.save_state(path, state)
    keys = set(np.load(path).files)
    assert keys == {"__format_version__", "leaf:.time", "leaf:.physics.pos",
                    "leaf:.physics.quat", "leaf:.physics.vel",
                    "leaf:.physics.omega"}
    out = ckpt.load_state(path, _state(2, lead))
    _assert_same(out, state)
    assert out.time.device == torch.device("cpu")


def test_checkpoint_crowd_state_of_a_scene(tmp_path):
    """A scene's crowd state (`crowd_init`) round-trips."""
    from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene

    scene = build_sample_scene(0.25, 64, 48, 64, "cpu", n_frames=30,
                               fps_keys=10, solver_iterations=2)
    state = crowd_init(scene, 3)
    path = str(tmp_path / "crowd.npz")
    ckpt.save_state(path, state)
    _assert_same(ckpt.load_state(path, crowd_init(scene, 3)), state)


def test_checkpoint_field_errors(tmp_path):
    """Errors name the field, as the reference's: missing, unknown, shape,
    dtype, a newer format, and a file that is no checkpoint."""
    path = str(tmp_path / "d.npz")
    ckpt.save_state(path, {"time": torch.tensor(2.0),
                           "pos": torch.zeros(2, 3)})
    out = ckpt.load_state(path, {"pos": torch.ones(2, 3),
                                 "time": torch.tensor(0.0)})
    assert float(out["time"]) == 2.0
    cases = [
        ({"time": torch.tensor(0.0), "pos": torch.zeros(2, 3),
          "vel": torch.zeros(2, 3)},
         r"missing from the checkpoint .*: \['vel'\]"),
        ({"time": torch.tensor(0.0)}, r"unknown to this .*\['pos'\]"),
        ({"time": torch.tensor(0.0), "pos": torch.zeros(3, 3)},
         r"field \"\['pos'\]\": shape \(2, 3\) does not match template "
         r"\(3, 3\)"),
        ({"time": torch.tensor(0.0), "pos": torch.zeros(2, 3,
                                                         dtype=torch.int32)},
         r"field \"\['pos'\]\": dtype float32 does not match template "
         r"int32"),
    ]
    for template, message in cases:
        with pytest.raises(ValueError, match=message):
            ckpt.load_state(path, template)
        ref_template = {k: jnp.asarray(v.numpy()) for k, v in
                        template.items()}
        with pytest.raises(ValueError, match=message):
            ref_ckpt.load_state(path, ref_template)
    newer = str(tmp_path / "v9.npz")
    np.savez(newer, __format_version__=np.int32(9))
    with pytest.raises(ValueError, match="v9 is newer than this build"):
        ckpt.load_state(newer, _state())
    bogus = str(tmp_path / "bogus.npz")
    np.savez(bogus, x=np.zeros(3))
    with pytest.raises(ValueError, match="not a checkpoint"):
        ckpt.load_state(bogus, _state())


def _v1_file(path, tree):
    """A v1 checkpoint of a reference tree, as the reference wrote it."""
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(repr(treedef).encode(), np.uint8)
    np.savez(path, **arrays)


def test_checkpoint_legacy_v1(tmp_path):
    """`treedef_repr` gives the repr JAX gives the reference's SimState
    (and plain trees), so a v1 file of the present structure loads; a v1
    file of another structure is refused with the reference's message."""
    ref_state = convert_state_to_ref(_state(3))
    assert ckpt.treedef_repr(_state()) == repr(
        jax.tree.flatten(ref_state)[1])
    plain = {"a": jnp.float32(1.0), "b": (jnp.ones(2), [jnp.ones(1)])}
    assert ckpt.treedef_repr({"a": torch.tensor(0.0), "b": (
        torch.zeros(2), [torch.zeros(1)])}) == repr(jax.tree.flatten(
            plain)[1])
    path = str(tmp_path / "v1.npz")
    _v1_file(path, ref_state)
    _assert_same(ckpt.load_state(path, _state()), _state(3))
    _v1_file(path, {"a": jnp.float32(1.0), "b": jnp.ones(2)})
    with pytest.raises(ValueError, match=r"legacy v1 format .* re-create"):
        ckpt.load_state(path, _state())


def convert_state_to_ref(state):
    """A port SimState as the reference's (JAX leaves)."""
    from simple_mmd_renderer_tpu.core.physics import PhysicsState as RefPS
    from simple_mmd_renderer_tpu.core.scene import SimState as RefSS

    leaves = convert.sim_state_to_numpy(state)
    return RefSS(time=jnp.asarray(leaves["time"]), physics=RefPS(
        **{k: jnp.asarray(leaves[k]) for k in convert.PHYSICS_LEAVES}))


def test_checkpoints_cross_the_packages(tmp_path):
    """A .npz written by the reference loads in the port, and the reverse,
    bit for bit."""
    state = _state(4)
    ref_state = convert_state_to_ref(state)
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_state(path, ref_state)
    _assert_same(ckpt.load_state(path, _state()), state)
    path = str(tmp_path / "port.npz")
    ckpt.save_state(path, state)
    back = ref_ckpt.load_state(path, convert_state_to_ref(_state()))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_png_encoder_decodes_to_the_same_array():
    rng = np.random.default_rng(0)
    for shape in ((5, 7, 3), (1, 1, 3), (48, 64, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        back = np.asarray(Image.open(io.BytesIO(encode_png(img))))
        assert np.array_equal(back, img), shape
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2, 3), np.float32))


def test_frame_stats_and_trace(tmp_path):
    """FrameStats counts and summarizes as the reference's; `trace` writes
    a Chrome trace into its directory that holds the pass labels of a
    frame rendered inside it."""
    import json

    from simple_mmd_renderer_tpu.utils.profiling import FrameStats as Ref
    from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
    from simple_mmd_renderer_tpu_torch.utils import profiling

    stats, ref = profiling.FrameStats(window=2), Ref(window=2)
    assert stats.summary() == ref.summary() == {"fps": 0.0, "frame_ms": 0.0}
    for st in (stats, ref):
        for _ in range(4):
            st.tick()
        st.count("draws", 5)
        st.count("draws")
    assert len(stats.times) == len(ref.times) == 2
    assert stats.counters == ref.counters == {"draws": 6.0}
    assert stats.fps > 0 and set(stats.summary()) == set(ref.summary())
    scene = build_sample_scene(0.25, 32, 24, 32, "cpu", n_frames=30,
                               fps_keys=10, solver_iterations=2)
    with profiling.trace(str(tmp_path / "tr")):
        scene.step_and_render(scene.init_state())
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"anim", "physics", "shadow", "character", "shade"} <= names


def test_orbit_rig_and_keys_match_reference():
    """The same key bytes (arrows, zoom, fly, reset; an arrow split after
    ESC and after ESC [) give the reference rig's eye and target."""
    rig, ref = cli.OrbitRig(PortRC()), ref_cli.OrbitRig(RefRC())
    for chunk in (b"\x1b[C", b"\x1b", b"[A", b"++w", b"\x1b[", b"D", b"ad",
                  b"qe-\x1b[B", b"s", b"\x1bw", b"r", b"\x1b[D\x1b[D"):
        assert cli.apply_keys(rig, chunk) == ref_cli.apply_keys(ref, chunk)
        assert np.array_equal(rig.eye, ref.eye), chunk
        assert np.array_equal(rig.target, ref.target), chunk
    assert cli.apply_keys(rig, b"x") and ref_cli.apply_keys(ref, b"x")
    assert cli.KEY_HELP == ref_cli.KEY_HELP


def test_ansi_frame_matches_reference():
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (48, 64, 3)).astype(
        np.float32)
    assert cli.ansi_frame(img, 24) == ref_cli.ansi_frame(img, 24)


def _png(path):
    return np.asarray(Image.open(path))


def _run(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert cli.main(list(argv)) == 0
    return out.getvalue()


def test_cli_sample_matches_reference(tmp_path):
    """`--sample` frames against the reference Scene built from the same
    flags, each quantized to uint8; `--warm` renders one frame and exits;
    without a card `--device cuda` (the default) stops, naming the
    argument."""
    out = str(tmp_path / "frames")
    log = _run("--sample", "--frames", "2", "--out", out, *SMALL)
    assert "1 frames in" in log
    static = ref_model.build_model(sample_character(0.25))
    cfg = AppConfig()
    cfg.render = RenderConfig(width=64, height=48, shadow_map_size=64,
                              show_skybox=False, raster_mode="tiled")
    ref = RefScene(static, ref_physics.build_physics(static),
                   ref_anim.bind_motion(static, sample_motion(4)), cfg)
    step = jax.jit(ref.step_and_render)
    state = ref.init_state()
    for i in range(2):
        state, img = step(state)
        want = (np.asarray(img) * 255).astype(np.uint8)
        got = _png(os.path.join(out, f"frame_{i:05d}.png"))
        _assert_frames_close(got[None] / 255.0, want[None] / 255.0,
                             f"frame {i}")
    log = _run("--sample", "--frames", "5", "--warm", "--out", out, *SMALL)
    assert "exiting (--warm)" in log
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cuda"):
            cli.main(["--sample"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The written PMX (density 0.25) and VMD, and a VPD pose."""
    d = tmp_path_factory.mktemp("inputs")
    pmx, vmd = chip_smoke.cli_files(str(d), density=0.25)
    vpd = os.path.join(str(d), "pose.vpd")
    with open(vpd, "wb") as f:
        f.write(chip_smoke.VPD_POSE.encode("cp932"))
    return pmx, vmd, vpd


def test_cli_resume_is_bit_identical(tmp_path, files):
    """4 frames in one run equal 2 frames, `--save-state`, then
    `--resume` for 2 more, bit for bit in the PNGs and the state (the
    reference's tests/test_aux.py:235 on the port's CLI), with both
    tracks driving the frames."""
    pmx, vmd, _ = files
    base = [pmx, vmd, "--use-camera", "--use-light", *SMALL]
    a, b, c = (str(tmp_path / n) for n in "abc")
    log = _run(*base, "--frames", "4", "--out", a, "--save-state",
               a + ".npz")
    assert "camera driven" in log and "light driven" in log
    _run(*base, "--frames", "2", "--out", b, "--save-state", b + ".npz",
         "--save-every", "1")
    log = _run(*base, "--frames", "2", "--out", c, "--resume", b + ".npz",
               "--save-state", c + ".npz")
    assert "resumed sim state" in log
    for i in range(2):
        assert np.array_equal(_png(f"{c}/frame_{i:05d}.png"),
                              _png(f"{a}/frame_{i + 2:05d}.png")), i
    want, got = np.load(a + ".npz"), np.load(c + ".npz")
    assert want.files == got.files
    for k in want.files:
        assert np.array_equal(want[k], got[k]), k


def test_cli_tracks_and_pose(tmp_path, files):
    """`--use-camera --use-light` frames equal the Scene's with the bound
    tracks (and differ from the frames without them); `--pose` holds the
    VPD pose (frames 1 and 2 equal, physics off) and differs from the
    model at rest."""
    from simple_mmd_renderer_tpu_torch.render.camera_anim import (
        bind_camera, bind_light)

    pmx, vmd, vpd = files
    tracks, bare = str(tmp_path / "t"), str(tmp_path / "b")
    _run(pmx, vmd, "--use-camera", "--use-light", "--frames", "1", "--out",
         tracks, *SMALL)
    _run(pmx, vmd, "--frames", "1", "--out", bare, *SMALL)
    args = cli.parse_args([pmx, vmd, "--use-camera", "--use-light", *SMALL])
    scene = cli.build_scene(args, torch.device("cpu"))
    assert scene.camera is not None and scene.light is not None
    from simple_mmd_renderer_tpu_torch.formats.vmd import load_vmd
    motion = load_vmd(vmd)
    for name, buf in bind_camera(motion.camera, "cpu").named_buffers():
        assert torch.equal(buf, getattr(scene.camera, name)), name
    for name, buf in bind_light(motion.light, "cpu").named_buffers():
        assert torch.equal(buf, getattr(scene.light, name)), name
    _, img = scene.step_and_render(scene.init_state())
    got = _png(f"{tracks}/frame_00000.png")
    assert np.array_equal(got, (img.numpy() * 255).astype(np.uint8))
    assert np.abs(got.astype(int) - _png(f"{bare}/frame_00000.png")).max() \
        > 20
    posed, rest = str(tmp_path / "p"), str(tmp_path / "r")
    log = _run(pmx, "--pose", vpd, "--no-physics", "--frames", "2", "--out",
               posed, *SMALL)
    assert "holding pose" in log
    _run(pmx, "--no-physics", "--frames", "1", "--out", rest, *SMALL)
    p0, p1 = _png(f"{posed}/frame_00000.png"), _png(f"{posed}/frame_00001.png")
    assert np.array_equal(p0, p1)
    assert not np.array_equal(p0, _png(f"{rest}/frame_00000.png"))
