"""The port's texture units against the reference's, on the same NumPy
inputs: the bilinear sampler, the atlas samplers (8-bit and float atlases,
the flat-part broadcast), the deferred-UV rows and their sampler, the mip
level selection, the windowed albedo, the resident mini-atlas and the
loaders. (`build_packed_atlas` is held field by field in
tests/test_torch_builders.py; whole textured frames in
tests/test_torch_textured_slice.py.)

The model is the sample character at density 0.25 split into 3 material
parts. Tolerances, with the largest difference measured here: the port's
f32 arithmetic is the reference's operation for operation, and eager JAX
on the CPU gives the same bits (measured 0 for every sampler and row
table); held at 1e-6 for samples, 1e-5 for texel-space rows (values up to
64), exactly for the atlas copies and the levels. The windowed albedo is
the exception: the reference compiles it inside `lax.switch`, where XLA
fuses multiply-adds. From per-pixel UVs that moves a sample by 1.8e-7
(held at 1e-6); through the rows an ulp of a texel coordinate up to 64
moves the bilinear weight (measured 1.08e-5, held at 5e-5).
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.app.sample import sample_character
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.formats import textures as ref_textures
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.formats import textures
from simple_mmd_renderer_tpu_torch.render import pipeline

import torch_threads  # noqa: F401  (the port's tests' thread cap)

N_PARTS = 3


@pytest.fixture(scope="module")
def model():
    """(reference ModelStatic, the port's ModelTables on the CPU)."""
    static = ref_model.build_model(sample_character(density=0.25,
                                                    n_parts=N_PARTS))
    return static, ModelTables(convert.model_static(static), "cpu")


def _textures(kind, rng):
    """Per-part textures: "8bit" and "float" of different sizes (one part a
    flat 1x1 colour), "flat" all 1x1."""
    sizes = ((1, 1), (1, 1), (1, 1)) if kind == "flat" else \
        ((8, 8), (4, 6), (1, 1))
    texs = [rng.random(s + (3,)).astype(np.float32) for s in sizes]
    if kind != "float":
        texs = [(np.round(t * 255.0) / 255.0).astype(np.float32)
                for t in texs]
    return texs


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= atol, err
    return err


def test_sample_bilinear_wraps_like_reference():
    """Repeat wrap by floor-mod: UVs below 0 and above 1 wrap the same way
    as the reference's jnp.mod."""
    rng = np.random.default_rng(0)
    tex = rng.random((7, 5, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (40, 30, 2)).astype(np.float32)
    uv[0, :2] = [[-0.01, -0.99], [1.0, 2.0]]
    want = ref_textures.sample_bilinear(tex, jnp.asarray(uv))
    _close(textures.sample_bilinear(tex, _t(uv)), want, 1e-6)


@pytest.mark.parametrize("kind", ["8bit", "float", "flat"])
def test_character_albedo_matches_reference(model, kind):
    """`character_albedo` (the packed atlas of either kind, built inline or
    given; all-flat parts take the broadcast) on random triangle ids, some
    uncovered, and wrapped UVs."""
    static, rig = model
    rng = np.random.default_rng(1)
    texs = _textures(kind, rng)
    t = static.triangles.shape[0]
    tri = rng.integers(-1, t, (24, 32)).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (24, 32, 2)).astype(np.float32)
    want = ref_pipeline.character_albedo(static, jnp.asarray(tri),
                                         jnp.asarray(uv), texs)
    _close(pipeline.character_albedo(rig, _t(tri), _t(uv), texs), want, 1e-6)
    if kind != "flat":
        atlas = ref_pipeline.build_packed_atlas(texs, mip_levels=3)
        want = ref_pipeline.character_albedo(static, jnp.asarray(tri),
                                             jnp.asarray(uv), texs, atlas)
        got = pipeline.character_albedo(
            rig, _t(tri), _t(uv), texs, convert.packed_atlas(atlas, "cpu"))
        _close(got, want, 1e-6)


def test_affine_uv_rows_and_uv_from_vis(model):
    static, rig = model
    rng = np.random.default_rng(2)
    tris = np.asarray(static.triangles)[:, ::-1].copy()
    uvs = rng.uniform(-0.5, 1.5, (rig.n_vertices, 2)).astype(np.float32)
    want = ref_pipeline.affine_uv_rows(jnp.asarray(uvs), jnp.asarray(tris))
    rows = pipeline.affine_uv_rows(_t(uvs), _t(tris))
    _close(rows, want, 0.0)
    tri = rng.integers(-1, tris.shape[0], (16, 20)).astype(np.int32)
    bary = rng.random((16, 20, 2)).astype(np.float32)
    want = ref_pipeline.uv_from_vis(jnp.asarray(tri), jnp.asarray(bary),
                                    jnp.asarray(np.asarray(want)))
    _close(pipeline.uv_from_vis(_t(tri), _t(bary), rows), want, 1e-6)


def _mip_setup(static, rig, rng, kind="8bit"):
    """A 4-level mip atlas of larger textures, random UVs and screen
    positions: (tris, uvs, screen, reference atlas, port atlas)."""
    texs = [rng.random((64, 64, 3)), rng.random((32, 16, 3)),
            rng.random((1, 1, 3))]
    texs = [(np.round(t * 255.0) / 255.0 if kind == "8bit" else t)
            .astype(np.float32) for t in texs]
    ref_atlas = ref_pipeline.build_packed_atlas(texs, mip_levels=4)
    tris = np.asarray(static.triangles)[:, ::-1].copy()
    uvs = rng.uniform(-0.5, 1.5, (rig.n_vertices, 2)).astype(np.float32)
    screen = rng.uniform(0, 200, (rig.n_vertices, 2)).astype(np.float32)
    return (tris, uvs, screen, ref_atlas,
            convert.packed_atlas(ref_atlas, "cpu"), texs)


@pytest.mark.parametrize("how", ["plain", "mips", "resident"])
def test_affine_uv_part_rows_matches_reference(model, how):
    """The fused UV/placement rows: level 0 of each part, the per-triangle
    mip level from the screen area, and the resident mini-atlas's slots."""
    static, rig = model
    rng = np.random.default_rng(3)
    tris, uvs, screen, ref_atlas, atlas, _ = _mip_setup(static, rig, rng)
    ref_kw, kw = {}, {}
    if how == "mips":
        ref_kw["screen_xy"], kw["screen_xy"] = jnp.asarray(screen), _t(screen)
    elif how == "resident":
        need = np.array([1, 0, 3], np.int32)
        _, roff, rsz = ref_pipeline.build_resident_atlas(
            ref_atlas, jnp.asarray(need), 32)
        ref_kw["resident"] = (roff, rsz)
        kw["resident"] = (_t(roff), _t(rsz))
    want = ref_pipeline.affine_uv_part_rows(jnp.asarray(uvs),
                                            jnp.asarray(tris), ref_atlas,
                                            static, **ref_kw)
    got = pipeline.affine_uv_part_rows(_t(uvs), _t(tris), atlas, rig, **kw)
    assert got.shape == (tris.shape[0], 12)
    _close(got, want, 1e-5)
    if how == "mips":
        # the levels themselves: tw, th of each row
        assert np.array_equal(got[:, 8:10].numpy(), np.asarray(want)[:, 8:10])


def test_tri_mip_levels_on_fixed_inputs():
    """Level selection, floor(0.5 log2(texel area / pixel area)), on fixed
    inputs: random triangles (held equal), degenerate screen triangles (the
    last level) and ratios that sit exactly on powers of two, where an ulp
    of the ratio may move the floor. Measured: 0 of 4,000 random triangles
    and 0 of the 64 power-of-two ones a level apart; held at no random one
    and at most 1 of the 64, by at most one level."""
    rng = np.random.default_rng(4)
    T, L = 4000, 6
    g = rng.random((T, 3, 2)).astype(np.float32)
    sz0 = rng.choice([16.0, 64.0, 256.0], (T, 2)).astype(np.float32)
    screen = rng.uniform(0, 500, (3 * T, 2)).astype(np.float32)
    tris = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    screen[:30] = 7.0                               # 10 degenerate triangles
    want = np.asarray(ref_pipeline._tri_mip_levels(
        jnp.asarray(g), jnp.asarray(sz0), jnp.asarray(screen),
        jnp.asarray(tris), L))
    got = pipeline._tri_mip_levels(_t(g), _t(sz0), _t(screen), _t(tris),
                                   L).numpy()
    assert (got[:10] == L - 1).all()
    assert np.array_equal(got, want)

    # power-of-two ratios: a unit UV right triangle over 2^k x 2^k pixels
    # of a 256^2 texture gives rho^2 = 4^(8-k) exactly
    k = np.repeat(np.arange(8), 8).astype(np.float32)
    n = k.size
    g2 = np.broadcast_to(np.float32([[0, 0], [1, 0], [0, 1]]),
                         (n, 3, 2)).copy()
    s2 = np.zeros((n, 3, 2), np.float32)
    s2[:, 1, 0] = 2.0 ** k
    s2[:, 2, 1] = 2.0 ** k
    s2 += rng.uniform(0, 300, (n, 1, 2)).astype(np.float32)
    sz2 = np.full((n, 2), 256.0, np.float32)
    tris2 = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    want = np.asarray(ref_pipeline._tri_mip_levels(
        jnp.asarray(g2), jnp.asarray(sz2), jnp.asarray(s2.reshape(-1, 2)),
        jnp.asarray(tris2), 9))
    got = pipeline._tri_mip_levels(_t(g2), _t(sz2), _t(s2.reshape(-1, 2)),
                                   _t(tris2), 9).numpy()
    off = got != want
    assert off.sum() <= 1 and np.abs(got - want).max() <= 1


@pytest.mark.parametrize("kind", ["8bit", "float", "crowd"])
def test_albedo_rows_matches_reference(model, kind):
    """Deferred-UV sampling from the fused rows: one atlas of either kind,
    and per-instance rows of a crowd of 2 (each instance's pixels read its
    own rows)."""
    static, rig = model
    rng = np.random.default_rng(5)
    tris, uvs, screen, ref_atlas, atlas, _ = _mip_setup(
        static, rig, rng, "float" if kind == "float" else "8bit")
    n = 2 if kind == "crowd" else 1
    rows = np.stack([np.asarray(ref_pipeline.affine_uv_part_rows(
        jnp.asarray(uvs + 0.1 * i), jnp.asarray(tris), ref_atlas, static,
        screen_xy=jnp.asarray(screen * (1 + i)))) for i in range(n)])
    tri = rng.integers(-1, tris.shape[0], (n, 20, 24)).astype(np.int32)
    bary = rng.random((n, 20, 24, 2)).astype(np.float32)
    want = np.stack([np.asarray(ref_pipeline._albedo_rows(
        ref_atlas, jnp.asarray(tri[i]), jnp.asarray(bary[i]),
        jnp.asarray(rows[i]))) for i in range(n)])
    if kind == "crowd":
        got = pipeline._albedo_rows(atlas, _t(tri), _t(bary), _t(rows))
    else:
        got = pipeline._albedo_rows(atlas, _t(tri[0]), _t(bary[0]),
                                    _t(rows[0]))[None]
    _close(got, want, 1e-6)


@pytest.mark.parametrize("uv_from", ["pixels", "rows"])
def test_character_albedo_windowed_on_covered_pixels(model, uv_from):
    """At 640x512 (at least 512^2: the reference samples a window picked
    from its ladder) the port, which samples every pixel, gives the
    reference's albedo on every covered pixel: from per-pixel UVs, and
    from the visibility buffer through 12-column rows."""
    static, rig = model
    rng = np.random.default_rng(6)
    tris, uvs, screen, ref_atlas, atlas, texs = _mip_setup(static, rig, rng)
    h, w = 512, 640
    tri = np.full((h, w), -1, np.int32)
    tri[200:330, 300:470] = rng.integers(0, tris.shape[0], (130, 170))
    covered = tri >= 0
    uv = rng.uniform(-1.0, 2.0, (h, w, 2)).astype(np.float32)
    bary = rng.random((h, w, 2)).astype(np.float32)
    if uv_from == "pixels":
        want = ref_pipeline.character_albedo_windowed(
            static, jnp.asarray(tri), jnp.asarray(uv), texs)
        got = pipeline.character_albedo_windowed(rig, _t(tri), _t(uv), texs)
    else:
        ref_rows = ref_pipeline.affine_uv_part_rows(
            jnp.asarray(uvs), jnp.asarray(tris), ref_atlas, static)
        want = ref_pipeline.character_albedo_windowed(
            static, jnp.asarray(tri), None, texs, ref_atlas,
            bary=jnp.asarray(bary), uv_rows=ref_rows)
        got = pipeline.character_albedo_windowed(
            rig, _t(tri), None, texs, atlas, bary=_t(bary),
            uv_rows=_t(np.asarray(ref_rows)))
    assert got.shape == (h, w, 3)
    _close(got.numpy()[covered], np.asarray(want)[covered],
           1e-6 if uv_from == "pixels" else 5e-5)


def test_resident_atlas_matches_reference(model):
    """`build_resident_atlas` copies the same windows (exactly) with the
    same part origins and level sizes; `resident_fit_levels` and
    `resident_slot_size` give the reference's values; a chain that never
    fits the slot raises the reference's ValueError."""
    static, rig = model
    rng = np.random.default_rng(7)
    _, _, _, ref_atlas, atlas, texs = _mip_setup(static, rig, rng)
    for slot in (8, 16, 32, 64):
        want = ref_pipeline.resident_fit_levels(ref_atlas, slot)
        got = pipeline.resident_fit_levels(atlas, slot)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want)
    for n in (1, 2, 5, 16, 64, 1000):
        assert (pipeline.resident_slot_size(n)
                == ref_pipeline.resident_slot_size(n))
    for need, slot in (([0, 0, 0], 64), ([1, 0, 3], 32), ([2, 5, 0], 16)):
        want = ref_pipeline.build_resident_atlas(
            ref_atlas, jnp.asarray(np.int32(need)), slot)
        got = pipeline.build_resident_atlas(atlas, torch.tensor(need), slot)
        assert got[0].eight_bit == want[0].eight_bit
        assert np.array_equal(got[0].data.numpy(),
                              np.asarray(want[0].data).astype(np.int32))
        for a, b in zip(got[1:], want[1:]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    shallow = pipeline.build_packed_atlas(texs, mip_levels=2, device="cpu")
    with pytest.raises(ValueError, match="texture_mips"):
        pipeline.build_resident_atlas(shallow, torch.zeros(3, dtype=torch.int32),
                                      16)


def test_loaders_on_a_temporary_directory(tmp_path):
    """A PNG found case-insensitively under the model directory's `tex/`
    decodes to the reference's array; a missing file, an undecodable one and
    a part without a texture give the white 1x1."""
    from PIL import Image

    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    (tmp_path / "tex").mkdir()
    Image.fromarray(img).save(tmp_path / "tex" / "Body.PNG")
    (tmp_path / "broken.png").write_bytes(b"not a png")
    d = str(tmp_path)
    for name in ("tex/body.png", "tex\\BODY.png", "Body.PNG"):
        hit = textures.resolve_texture_path(name, d)
        assert hit == ref_textures.resolve_texture_path(name, d)
        assert hit is not None and hit.endswith("Body.PNG")
    got = textures.load_texture("tex/body.png", d)
    assert np.array_equal(got, ref_textures.load_texture("tex/body.png", d))
    assert np.array_equal(got, img.astype(np.float32) / 255.0)
    for missing in ("nope.png", "broken.png"):
        assert np.array_equal(textures.load_texture(missing, d),
                              textures.WHITE_1X1)
    static = types.SimpleNamespace(part_tex=[0, -1, 2, 0],
                                   textures=["tex/Body.png", "x", "nope"])
    got = textures.load_material_textures(static, d)
    want = ref_textures.load_material_textures(static, d)
    assert len(got) == 4 and got[0] is got[3]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_atlas_entry_points_default_to_the_card(monkeypatch):
    """`build_packed_atlas` and `convert.packed_atlas` build on the card
    unless asked for another device, and raise without one; an all-flat
    texture set packs no atlas."""
    rng = np.random.default_rng(9)
    texs = _textures("8bit", rng)
    assert pipeline.build_packed_atlas(_textures("flat", rng),
                                       device="cpu") is None
    ref_atlas = ref_pipeline.build_packed_atlas(texs)
    assert pipeline.build_packed_atlas(texs, device="cpu").data.device.type \
        == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        pipeline.build_packed_atlas(texs)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        convert.packed_atlas(ref_atlas)
