"""The port's own host modules and NumPy builders produce exactly the
reference's objects.

The port keeps its own copies of the reference's host code (it imports
nothing of the JAX package): `sample_character`, `sample_motion`, the
procedural textures, the PMX and VMD readers, `write_vmd`, the config
dataclasses, and the functions `build_model`, `bind_motion`,
`build_physics`, `build_weight_matrix` and `build_packed_atlas`. Every
field must be equal (np.array_equal, dtype too), on the sample rig at
density 0.5 and at the flagship density 2.0 (the atlas on 8-bit and float
textures, with and without mips), and the converters in
`simple_mmd_renderer_tpu_torch.convert` must carry the reference's objects
into the port's classes field by field.
"""

import dataclasses

import numpy as np
import pytest

from simple_mmd_renderer_tpu import config as ref_config
from simple_mmd_renderer_tpu.app.sample import sample_character, sample_motion
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.formats import vmd as ref_vmd
from simple_mmd_renderer_tpu.formats import writers as ref_writers
from simple_mmd_renderer_tpu.ops import skinning as ref_skinning
from simple_mmd_renderer_tpu_torch import config, convert
from simple_mmd_renderer_tpu_torch.app import sample
from simple_mmd_renderer_tpu_torch.core import anim, model, physics
from simple_mmd_renderer_tpu_torch.formats import pmx, vmd, writers
from simple_mmd_renderer_tpu_torch.ops import skinning

import torch_threads  # noqa: F401  (the port's tests' thread cap)


def _assert_same(a, b, path="root"):
    """Deep equality: arrays by np.array_equal (dtype too), dataclasses
    field by field (whatever their classes), lists element-wise, dicts key
    by key, other leaves by identity or ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} != {b.dtype}"
        assert np.array_equal(a, b), f"{path}: arrays differ"
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        assert ([f.name for f in dataclasses.fields(a)]
                == [f.name for f in dataclasses.fields(b)]), path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys differ"
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a is b or a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module", params=[0.5, 2.0], ids=["d0.5", "d2.0"])
def rig(request):
    pm = sample_character(density=request.param)
    return request.param, pm, ref_model.build_model(pm)


@pytest.mark.parametrize("density", [0.5, 2.0])
def test_sample_character_matches_reference(density):
    got = sample.sample_character(density=density)
    assert isinstance(got, pmx.PmxModel)
    _assert_same(got, sample_character(density=density))


@pytest.mark.parametrize("length,fps_keys", [(90, 10), (240, 5)])
def test_sample_motion_matches_reference(length, fps_keys):
    got = sample.sample_motion(length, fps_keys=fps_keys)
    assert isinstance(got, vmd.VmdMotion)
    _assert_same(got, sample_motion(length, fps_keys=fps_keys))


def test_pmx_parse_matches_reference(monkeypatch):
    """The same PMX bytes (every skinning type, every morph kind the
    fixtures hold, the sample rig's bodies and joints) through both
    readers: the port's Python vertex loop gives the reference's arrays
    (its native vertex parser: tests/test_torch_native.py)."""
    from fixtures import ik_leg, two_bone_arm

    from simple_mmd_renderer_tpu_torch import native
    monkeypatch.setattr(native, "get_lib", lambda: None)

    for pm in (two_bone_arm(), ik_leg(), sample_character(density=0.5)):
        data = ref_writers.write_pmx(pm)
        got = pmx.parse_pmx(data)
        assert isinstance(got, pmx.PmxModel)
        _assert_same(got, ref_pmx.parse_pmx(data))


def test_vmd_write_and_parse_match_reference():
    rng = np.random.default_rng(4)
    keys = [(f"bone{i % 3}", int(f), rng.normal(size=3).astype(np.float32),
             rng.normal(size=4).astype(np.float32),
             rng.integers(0, 127, (4, 4)).astype(np.int8))
            for i, f in enumerate(rng.permutation(40))]
    morphs = [("blink", f, float(rng.uniform())) for f in range(0, 40, 7)]
    cams = [{"frame": 3, "position": (1.0, 2.0, 3.0), "fov": 40.0}]
    lights = [{"frame": 5, "color": (0.5, 0.6, 0.7)}]
    data = writers.write_vmd("dance", keys, morphs, cams, lights)
    assert data == ref_writers.write_vmd("dance", keys, morphs, cams, lights)
    got = vmd.parse_vmd(data)
    assert got.camera is not None and got.light is not None
    _assert_same(got, ref_vmd.parse_vmd(data))


def test_app_config_defaults_match_reference():
    _assert_same(config.AppConfig(), ref_config.AppConfig())


def test_convert_carries_reference_objects_field_by_field(rig):
    _, _, ref = rig
    got = convert.model_static(ref)
    assert isinstance(got, model.ModelStatic)
    for seg in got.pre_segments + got.post_segments:
        assert isinstance(seg, model.Segment)
        assert all(isinstance(ik, model.IKProgram) for ik in seg.iks)
    assert all(isinstance(m, pmx.Material) for m in got.materials)
    assert all(isinstance(b, pmx.RigidBody) for b in got.rigid_bodies)
    _assert_same(got, ref)
    ref_cfg = ref_config.AppConfig()
    ref_cfg.render.msaa = 4
    ref_cfg.physics.solver_iterations = 3
    cfg = convert.app_config(ref_cfg)
    assert isinstance(cfg, config.AppConfig)
    assert isinstance(cfg.render, config.RenderConfig)
    assert isinstance(cfg.physics, config.PhysicsConfig)
    _assert_same(cfg, ref_cfg)


def test_build_model_matches_reference(rig):
    density, pm, ref = rig
    got = model.build_model(sample.sample_character(density=density))
    assert isinstance(got, model.ModelStatic)
    _assert_same(got, ref)
    data = ref_writers.write_pmx(pm)        # and from parsed bytes
    _assert_same(model.build_model(pmx.parse_pmx(data)),
                 ref_model.build_model(ref_pmx.parse_pmx(data)))


def test_model_tables_part_tables_match_reference(rig):
    """`ModelTables.part_base` / `tri_part` (buffers, so `.to()` moves them)
    equal the reference's host part tables, `_static_pid` for the model's
    own part count and for a smaller atlas (`pipeline._tri_part`)."""
    import torch

    from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
    from simple_mmd_renderer_tpu_torch.render import pipeline

    _, _, ref = rig
    tables = model.ModelTables(convert.model_static(ref), device="cpu")
    buffers = dict(tables.named_buffers())
    assert "part_base" in buffers and "tri_part" in buffers
    assert np.array_equal(tables.part_base.numpy(),
                          np.asarray(ref.part_base, np.int32))
    t = len(ref.triangles)
    for pn in (len(ref.part_base), 1):
        want = ref_pipeline._static_pid(t, ref, pn)
        got = pipeline._tri_part(tables, pn)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), pn


def test_bind_motion_matches_reference(rig):
    _, _, static = rig
    motion = sample_motion(90, fps_keys=10)
    ref = ref_anim.bind_motion(static, motion)
    got = anim.bind_motion(static, motion)
    for f in dataclasses.fields(anim.MotionArrays):
        _assert_same(getattr(got, f.name), getattr(ref, f.name), f.name)


def test_build_physics_matches_reference(rig):
    _, _, static = rig
    ref = ref_physics.build_physics(static)
    got = physics.build_physics(static)
    for f in dataclasses.fields(ref_physics.PhysicsStatic):
        _assert_same(getattr(got, f.name), getattr(ref, f.name), f.name)


def test_build_weight_matrix_matches_reference(rig):
    _, _, static = rig
    args = (static.skin_bones, static.skin_weights, static.n_bones)
    _assert_same(skinning.build_weight_matrix(*args),
                 ref_skinning.build_weight_matrix(*args))


def test_bezier_presample_matches_reference():
    from simple_mmd_renderer_tpu.utils import bezier as ref_bezier
    from simple_mmd_renderer_tpu_torch.utils import bezier

    rng = np.random.default_rng(3)
    c0 = rng.integers(0, 128, (40, 2)).astype(np.float32) / 127
    c1 = rng.integers(0, 128, (40, 2)).astype(np.float32) / 127
    c0[:5] = c0[:5, :1]          # linear curves among them
    c1[:5] = c1[:5, :1]
    for x, y in zip(bezier.presample(c0, c1), ref_bezier.presample(c0, c1)):
        _assert_same(x, y)


@pytest.mark.parametrize("entry", ["Scene", "build_sample_scene",
                                   "ModelTables", "PhysicsTables",
                                   "MotionTables"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Every entry point that takes `device` defaults to "cuda" and, with no
    card, raises naming the argument instead of falling back to the CPU;
    device="cpu" builds on the CPU."""
    import torch

    from simple_mmd_renderer_tpu_torch.core.scene import (Scene,
                                                          build_sample_scene)

    static = model.build_model(sample.sample_character(density=0.25))
    ps = physics.build_physics(static)
    mo = anim.bind_motion(static, sample.sample_motion(30, fps_keys=10))
    make = {
        "Scene": lambda **kw: Scene(static, ps, mo, **kw),
        "build_sample_scene": lambda **kw: build_sample_scene(
            0.25, 64, 48, 64, n_frames=30, fps_keys=10, **kw),
        "ModelTables": lambda **kw: model.ModelTables(static, **kw),
        "PhysicsTables": lambda **kw: physics.PhysicsTables(ps, **kw),
        "MotionTables": lambda **kw: anim.MotionTables(mo, **kw),
    }[entry]
    built = make(device="cpu")
    assert {b.device.type for b in built.buffers()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        make()


def test_state_converter_defaults_to_the_card(monkeypatch):
    """`convert.sim_state_to_torch` carries a reference state onto the card
    unless asked for another device; with no card it raises naming the
    argument, and device="cpu" converts on the CPU."""
    import types

    import torch

    ref_state = types.SimpleNamespace(
        time=np.zeros((2,), np.float32),
        physics=types.SimpleNamespace(**{
            k: np.ones((2, 3, 4 if k == "quat" else 3), np.float32)
            for k in convert.PHYSICS_LEAVES}))
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    assert state.time.device.type == "cpu"
    assert state.physics.quat.shape == (2, 3, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        convert.sim_state_to_torch(ref_state)


def test_sample_textures_match_reference():
    """The procedural textures and the realistic size mix."""
    from simple_mmd_renderer_tpu.app import sample as ref_sample

    for n in (2, 16, 20):
        assert (sample.realistic_texture_sizes(n)
                == ref_sample.realistic_texture_sizes(n))
    _assert_same(sample.sample_textures(), ref_sample.sample_textures())
    _assert_same(sample.sample_textures((64, 16, 8)),
                 ref_sample.sample_textures((64, 16, 8)))


def _atlas_fields(atlas):
    """A PackedAtlas's fields as NumPy arrays and host values."""
    out = {}
    for f in dataclasses.fields(atlas):
        if f.name == "tables":
            continue
        v = getattr(atlas, f.name)
        out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


@pytest.mark.parametrize("eight_bit", [True, False], ids=["8bit", "float"])
@pytest.mark.parametrize("mips", [0, 3])
def test_build_packed_atlas_matches_reference(eight_bit, mips):
    """`build_packed_atlas` gives the reference's atlas exactly: the packed
    words (int32 here, uint32 there: every word is below 2^24) or float
    rows, the placements, sizes and mip tables. Odd edges exercise the mip
    step's dropped row and column, and a flat 1x1 part the short chain.
    `convert.packed_atlas` carries the reference's atlas into the port's
    class with the same fields."""
    import torch

    from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
    from simple_mmd_renderer_tpu_torch.render import pipeline

    rng = np.random.default_rng(3)
    texs = [rng.random(s).astype(np.float32)
            for s in ((13, 7, 3), (4, 9, 3), (1, 1, 3), (16, 16, 3))]
    if eight_bit:
        texs = [(np.round(t * 255.0) / 255.0).astype(np.float32)
                for t in texs]
    ref = ref_pipeline.build_packed_atlas(texs, mip_levels=mips)
    got = pipeline.build_packed_atlas(texs, mip_levels=mips, device="cpu")
    assert got.eight_bit is eight_bit
    assert got.data.dtype == (torch.int32 if eight_bit else torch.float32)
    want = _atlas_fields(convert.packed_atlas(ref, device="cpu"))
    have = _atlas_fields(got)
    _assert_same(have, want)
    assert np.array_equal(have["data"], np.asarray(ref.data))
    assert have["n_mips"] == (mips if mips > 1 else 0)
    assert have["mip_meta"] == ref.mip_meta


def test_toon_and_sphere_loaders_match_reference(tmp_path):
    """`default_toon_ramp`, `load_toon_ramps` and `load_sphere_maps` give
    the reference's arrays exactly, over materials without a toon, with a
    global toon, a model-local toon file (its centre column resampled), a
    missing and an out-of-range toon; an SPH and an SPA file, an SPA whose
    file is missing (black), an out-of-range SPH and a sub-texture (off)."""
    import types

    from PIL import Image

    from simple_mmd_renderer_tpu.formats import textures as ref_textures
    from simple_mmd_renderer_tpu_torch.formats import textures

    for k in (1, 2, 16, 32):
        _assert_same(textures.default_toon_ramp(k),
                     ref_textures.default_toon_ramp(k))
    rng = np.random.default_rng(7)
    for name, shape in (("sph.png", (8, 6, 3)), ("toon.png", (16, 4, 3)),
                        ("spa.png", (5, 5, 3))):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            tmp_path / name)
    base = sample_character(density=0.5).materials[0]
    mats = [dataclasses.replace(base, toon=t, toon_is_global=g,
                                sub_texture=s, sub_texture_type=m)
            for t, g, s, m in ((-1, True, -1, 0), (3, True, 0, 1),
                               (1, False, 2, 2), (3, False, 3, 2),
                               (9, False, 9, 1), (1, False, 0, 3))]
    static = types.SimpleNamespace(
        materials=mats,
        textures=["sph.png", "toon.png", "spa.png", "missing.png"])
    for k in (4, 32):
        got = textures.load_toon_ramps(static, str(tmp_path), k)
        _assert_same(got, ref_textures.load_toon_ramps(static, str(tmp_path),
                                                       k))
        assert got.shape == (len(mats), k, 3)
    got = textures.load_sphere_maps(static, str(tmp_path))
    _assert_same(got, ref_textures.load_sphere_maps(static, str(tmp_path)))
    assert got[1].tolist() == [0, 1, 2, 2, 0, 0]
    assert textures.SPHERE_MUL == ref_textures.SPHERE_MUL == 1
    assert textures.SPHERE_ADD == ref_textures.SPHERE_ADD == 2
    empty = types.SimpleNamespace(materials=[], textures=[])
    _assert_same(textures.load_toon_ramps(empty, k=8),
                 ref_textures.load_toon_ramps(empty, k=8))
