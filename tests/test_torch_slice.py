"""The whole ported slice against the reference, frame by frame, and the
port's independence from JAX.

Configuration: `__graft_entry__._build_scene` — the sample character at
density 0.5, 256x192, 256^2 shadow map, 4 solver iterations,
sample_motion(90, fps_keys=10), raster_mode="tiled" on the reference side.
The port's Scene is built from the reference's objects through
`simple_mmd_renderer_tpu_torch.convert` (config included, `app_config`);
both packages start from one converted `init_state` and step 3 frames.
`compare_slice` (`slice_frames`, then `check_slice`) is shared with
tests/test_torch_slice_msaa.py (the msaa=4 and supersampled frames) and
tests/test_torch_wild_assets.py; with `renders` both packages step once a
frame and render that pose under several render configs.

Per frame: fewer than 2e-3 of pixels off by more than 0.02 and mean
absolute difference below 1/255 (`__graft_entry__`'s image tolerance),
`time` equal, and the physics leaves at atol 1e-4 — except the pos/quat of
kinematic bodies on IK-driven bones: a kinematic body copies its bone's
animated transform, so it inherits the port's CCD divergence from the
reference (PARITY D1). Measured here, port vs the jitted reference: 1.92e-3,
8.6e-7 and 3.88e-3 MMD units in position and 5.1e-4, 1.9e-7 and 9.8e-4 in
the quaternion in frames 1-3; the reference's eager run differs from its
jitted run by 0 on these bodies. Held at 6e-3 and 1.5e-3. From the same
pose, physics_react holds every body, these included, at 1e-4
(tests/test_torch_physics.py).
"""

import ast
import copy
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax

from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core.scene import Scene

import torch_threads  # noqa: F401  (the port's tests' thread cap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ik_driven_bodies(static, ps):
    seeds = set()
    for seg in static.pre_segments + static.post_segments:
        for ik in seg.iks:
            seeds |= set(ik.links.tolist()) | {ik.target}

    def driven(b):
        while b >= 0:
            if b in seeds:
                return True
            b = int(static.bone_parent[b])
        return False

    return np.array([bool(ps.kinematic[i]) and bool(ps.has_bone[i])
                     and driven(int(ps.bone[i]))
                     for i in range(ps.n_bodies)])


# the module's physics tolerances: every leaf at BODY_ATOL, and the pos
# and quat of kinematic bodies on IK-driven bones at IK_ATOL (PARITY D1)
BODY_ATOL = 1e-4
IK_ATOL = {"pos": 6e-3, "quat": 1.5e-3}


def _reference_frames(ref, state, n_frames, renders, steps=None):
    """The reference's frames, jitted: [(state, {name: image})]. Without
    `renders` the scene's own `step_and_render` (name None); with them
    `step_pose` once a frame (or `steps`, the jitted step's outputs
    (state', pose, positions, normals) a frame, where the caller stepped
    the reference already), then `render_frame` under every render config
    (the scene's, with each entry's changes), all configs traced into one
    jit: that is step_and_render's composition where the scene has no
    camera or light track, textures, skybox, MMD maps or extended
    morphs."""
    frames = []
    if renders is None:
        step = jax.jit(ref.step_and_render)
        for _ in range(n_frames):
            state, image = step(state)
            frames.append((state, {None: np.asarray(image)}))
        return frames
    assert (ref.camera is None and ref.light is None
            and ref.part_textures is None and ref.cubemap is None
            and ref.mmd_maps is None
            and not ref.config.apply_extended_morphs)
    if steps is None:
        step = jax.jit(ref.step_pose)
        steps = []
        for _ in range(n_frames):
            steps.append(step(state))
            state = steps[-1][0]
    assert len(steps) == n_frames
    cfgs = {name: dataclasses.replace(ref.config.render, **changes)
            for name, changes in renders.items()}
    draw = jax.jit(lambda p, n: {
        name: ref_pipeline.render_frame(ref.static, p, n, cfg)
        for name, cfg in cfgs.items()})
    for state, _, positions, normals in steps:
        frames.append((state, {name: np.asarray(image) for name, image
                               in draw(positions, normals).items()}))
    return frames


def _port_frames(port, state, n_frames, renders):
    """The port's frames, as _reference_frames takes them: its own
    `step_and_render`, or `step_pose` once a frame and the scene's render
    once a render config (a copy of the scene whose render config has the
    entry's changes)."""
    frames = []
    if renders is None:
        for _ in range(n_frames):
            state, image = port.step_and_render(state)
            frames.append((state, {None: image.numpy()}))
        return frames
    scenes = {}
    for name, changes in renders.items():
        scenes[name] = copy.copy(port)
        scenes[name].config = copy.copy(port.config)
        scenes[name].config.render = dataclasses.replace(port.config.render,
                                                         **changes)
    for _ in range(n_frames):
        state, pose, positions, normals = port.step_pose(state)
        frames.append((state, {
            name: scene._render(state.time, pose, positions, normals, None,
                                None).numpy()
            for name, scene in scenes.items()}))
    return frames


def slice_frames(ref, n_frames, renders=None, ref_run=None):
    """Step the reference Scene `ref` (jitted) and the port built from it
    (converted field by field, on the CPU) from one init_state, n_frames
    frames. `renders` ({name: render config changes}) renders each frame's
    pose under each of these configs in both packages (see
    _reference_frames); None renders the scene's own frame. `ref_run`
    (with `renders`: the reference's initial state and its `steps`, see
    _reference_frames) stands for `ref.init_state()` and the reference's
    stepping. -> the frames for check_slice."""
    port = Scene(convert.model_static(ref.static),
                 convert.physics_static(ref.phys_static),
                 convert.motion_arrays(ref.motion),
                 convert.app_config(ref.config), device="cpu")
    ref_state, steps = ref_run or (ref.init_state(), None)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    ik_bodies = _ik_driven_bodies(ref.static, ref.phys_static)
    assert 0 < ik_bodies.sum() < ref.phys_static.n_bodies
    sizes = {name: (dataclasses.replace(ref.config.render, **changes).height,
                    dataclasses.replace(ref.config.render, **changes).width)
             for name, changes in (renders or {None: {}}).items()}
    return (ik_bodies, sizes,
            _reference_frames(ref, ref_state, n_frames, renders, steps),
            _port_frames(port, state, n_frames, renders))


def check_slice(frames, names=None, body_atol=None, ik_atol=None):
    """Hold slice_frames' frames (the images of `names`, default all) at
    the module's tolerances: the images, time, and the physics leaves.
    `body_atol` ({leaf: atol}) holds the leaves of the bodies that are not
    IK-driven and kinematic where a scene needs other tolerances than
    BODY_ATOL (a leaf it does not name stays at BODY_ATOL); `ik_atol`
    replaces IK_ATOL."""
    ik_bodies, sizes, ref_frames, port_frames = frames
    for frame, ((ref_state, ref_imgs), (state, imgs)) in enumerate(
            zip(ref_frames, port_frames)):
        for name in names or imgs:
            img, ref_img = imgs[name], ref_imgs[name]
            assert img.shape == ref_img.shape == sizes[name] + (3,)
            d = np.abs(img - ref_img)
            assert (d > 0.02).mean() < 2e-3, f"frame {frame} {name}"
            assert d.mean() < 1 / 255, f"frame {frame} {name}"
        got = convert.sim_state_to_numpy(state)
        assert got["time"] == np.asarray(ref_state.time)
        for k in convert.PHYSICS_LEAVES:
            g = got[k]
            r = np.asarray(getattr(ref_state.physics, k))
            np.testing.assert_allclose(
                g[~ik_bodies], r[~ik_bodies], err_msg=f"{frame} {k}",
                atol=(body_atol or {}).get(k, BODY_ATOL))
            np.testing.assert_allclose(
                g[ik_bodies], r[ik_bodies], err_msg=f"{frame} {k} (IK)",
                atol=(ik_atol or IK_ATOL).get(k, BODY_ATOL))


def compare_slice(ref, n_frames, renders=None, body_atol=None,
                  ik_atol=None):
    """slice_frames then check_slice: the reference Scene `ref` and the
    port built from it, n_frames frames, held at the module's tolerances
    (or the ones given)."""
    check_slice(slice_frames(ref, n_frames, renders), body_atol=body_atol,
                ik_atol=ik_atol)


def test_slice_matches_reference_three_frames():
    from __graft_entry__ import _build_scene

    compare_slice(_build_scene(density=0.5, width=256, height=192,
                               shadow=256, solver_iterations=4,
                               raster_mode="tiled"), 3)


BLOCKED = ("jax", "jaxlib", "flax", "simple_mmd_renderer_tpu")


def test_port_runs_without_jax():
    """A fresh interpreter whose imports refuse `jax`, `flax` and the JAX
    package `simple_mmd_renderer_tpu` imports the port, `chip_smoke.py` and
    the port's profile script, and renders one 64x48 frame at msaa=1, one
    at msaa=4 with the windowed shadow map and one textured with a mip
    chain and the full look (skybox, edges, a double-sided part, the MMD
    maps), and a crowd of two through `parallel.mesh` at msaa=1 and 4 and
    textured; and the content rig (`chip_smoke.content_rig`: SDEF, UV and
    material morphs, through `write_pmx` and `parse_pmx`) with `sdef_true`
    and the extended morphs on, one frame and a crowd of two, and the
    sample character read back from PMD bytes with a VPD pose (the
    `models` index's readers); and the command-line renderer (`app/cli.py`)
    over 2 tiny frames of the written PMX and VMD with the camera and light
    tracks, PNGs and a checkpoint: the card's machine has no JAX, and the
    port keeps its own copies of the host modules."""
    code = textwrap.dedent(f"""
        import importlib.util
        import sys

        BLOCKED = {BLOCKED!r}

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, _Block())
        import torch
        from simple_mmd_renderer_tpu_torch.app.sample import sample_textures
        from simple_mmd_renderer_tpu_torch.core.scene import (
            build_sample_scene)
        import simple_mmd_renderer_tpu_torch.convert  # noqa: F401
        import simple_mmd_renderer_tpu_torch.formats.hdr  # noqa: F401
        from simple_mmd_renderer_tpu_torch.app.sample import (
            sample_equirect, sample_mmd_maps)
        from simple_mmd_renderer_tpu_torch.render.ibl import (
            equirect_to_cubemap)
        import chip_smoke  # noqa: F401

        spec = importlib.util.spec_from_file_location(
            "profile_torch_frame", "scripts/profile_torch_frame.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))

        for extra, shadow in (({{}}, 64),
                              (dict(msaa=4, shadow_window=True), 1024)):
            scene = build_sample_scene(0.25, 64, 48, shadow, "cpu",
                                       n_frames=30, fps_keys=10,
                                       solver_iterations=2, **extra)
            state, image = scene.step_and_render(scene.init_state())
            assert image.shape == (48, 64, 3)
            assert bool(torch.isfinite(image).all())
            print("rendered", extra, float(image.mean()))
        look = dict(cubemap=equirect_to_cubemap(sample_equirect(16, 32), 8,
                                                device="cpu"),
                    show_edges=True, double_sided_parts=(1,),
                    mmd_maps=sample_mmd_maps(2, 16, 8))
        scene = build_sample_scene(0.25, 64, 48, 64, "cpu", n_frames=30,
                                   fps_keys=10, solver_iterations=2,
                                   textures=(16, 8), n_parts=2,
                                   texture_mips=3, **look)
        state, image = scene.step_and_render(scene.init_state())
        assert bool(torch.isfinite(image).all())
        print("rendered textured", float(image.mean()))

        from simple_mmd_renderer_tpu_torch.parallel import mesh
        for msaa in (1, 4):
            scene = build_sample_scene(0.25, 64, 48, 64, "cpu", n_frames=30,
                                       fps_keys=10, solver_iterations=2,
                                       msaa=msaa)
            state, images = mesh.crowd_step_fn(scene)(
                mesh.crowd_init(scene, 2))
            assert images.shape == (2, 48, 64, 3)
            assert bool(torch.isfinite(images).all())
            print("crowd", msaa, float(images.mean()))
        scene.part_textures = sample_textures((16, 8))
        state, images = mesh.crowd_step_fn(scene)(mesh.crowd_init(scene, 2))
        assert bool(torch.isfinite(images).all())
        print("textured crowd", float(images.mean()))

        from simple_mmd_renderer_tpu_torch import models
        from simple_mmd_renderer_tpu_torch.formats.vpd import parse_vpd
        pm, n_sdef = chip_smoke.content_rig(0.25)
        scene = build_sample_scene(0.25, 64, 48, 64, "cpu", fps_keys=10,
                                   solver_iterations=2, textures=(16, 8),
                                   pmx=pm,
                                   vmd=chip_smoke.content_motion(30, 10),
                                   sdef_true=True, extended_morphs=True)
        assert scene.rig.n_sdef == n_sdef > 0
        state, image = scene.step_and_render(scene.init_state())
        state, images = mesh.crowd_step_fn(scene)(mesh.crowd_init(scene, 2))
        assert bool(torch.isfinite(image).all() & torch.isfinite(images).all())
        print("content", float(image.mean()), float(images.mean()))
        pm = models.parse_pmd(chip_smoke.pmd_bytes(
            models.sample_character(0.25)))
        pose = parse_vpd("Vocaloid Pose Data file\\n\\nBone0{{左腕\\n"
                         "0,0,0;\\n0,0,0.3,0.95;\\n}}\\n".encode("cp932"))
        scene = build_sample_scene(0.25, 64, 48, 64, "cpu",
                                   solver_iterations=2, pmx=pm, vmd=pose)
        state, image = scene.step_and_render(scene.init_state())
        assert bool(torch.isfinite(image).all())
        print("pmd + vpd", float(image.mean()))

        import os
        import tempfile
        from simple_mmd_renderer_tpu_torch.app import cli
        with tempfile.TemporaryDirectory() as tmp:
            pmx, vmd = chip_smoke.cli_files(tmp, density=0.25)
            out = os.path.join(tmp, "frames")
            assert cli.main([pmx, vmd, "--use-camera", "--use-light",
                             "--device", "cpu", "--frames", "2", "--width",
                             "64", "--height", "48", "--shadow-size", "64",
                             "--out", out, "--save-state",
                             os.path.join(tmp, "s.npz")]) == 0
            assert sorted(os.listdir(out)) == ["frame_00000.png",
                                               "frame_00001.png"]
        print("cli done")
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("rendered") == 3
    assert res.stdout.count("crowd") == 3
    assert "content" in res.stdout and "pmd + vpd" in res.stdout
    assert "camera driven" in res.stdout and "cli done" in res.stdout


def _imported_modules(tree):
    """Absolute module names a parsed file imports, by import statement
    or by a literal `__import__`/`import_module` call."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")):
            yield node.args[0].value


def test_port_imports_nothing_of_the_reference():
    """No file of the port, nor chip_smoke.py or the port's scripts
    (scripts/*torch*.py), imports jax, flax or anything of
    `simple_mmd_renderer_tpu`."""
    files = sorted(glob.glob(os.path.join(
        REPO, "simple_mmd_renderer_tpu_torch", "**", "*.py"),
        recursive=True))
    scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "*torch*.py")))
    assert os.path.join(REPO, "scripts", "profile_torch_frame.py") in scripts
    files += [os.path.join(REPO, "chip_smoke.py")] + scripts
    assert len(files) > 20
    for module in (("parallel", "mesh.py"), ("formats", "pmd.py"),
                   ("formats", "vpd.py"), ("formats", "writers.py"),
                   ("models", "__init__.py"), ("render", "camera_anim.py"),
                   ("utils", "checkpoint.py"), ("utils", "png.py"),
                   ("app", "cli.py"), ("native", "__init__.py"),
                   ("utils", "cache.py")):
        assert os.path.join(REPO, "simple_mmd_renderer_tpu_torch",
                            *module) in files
    seen = set()
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported_modules(tree):
            seen.add(mod)
            assert mod.split(".")[0] not in BLOCKED, (path, mod)
    assert "torch" in seen
