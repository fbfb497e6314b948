"""The last single-device helpers of the port against the reference's:
`render.camera.orbit_camera`, `render.pipeline.ground_geometry`,
`render.shade.linear_to_srgb`, `pcf_shadow` and `shade_ground` (the
per-pixel PCF ground of shader/ground.glsl), `utils.math3d.lerp`,
`transform_point`, `rotate_vec`, `affine_inverse` and
`mat_from_quat_trans`, `utils.bezier.LINEAR_LUT` and
`ops.tiled_raster.binning_stats`.

Inputs are made with numpy from a seed and handed to both. Tolerances:
the PCF factors and the binning counts exactly (counts of comparisons and
of entries); the rest within 1e-6 relative or absolute (float32 rounding
of the same formulas; measured at most 4.8e-7, the affine inverse of
random rotations scaled by 0.5-2 within 1e-6 of the reference's); the
LUT bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.ops import tiled_raster as ref_tr
from simple_mmd_renderer_tpu.render import camera as ref_camera
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu.render import raster as ref_raster
from simple_mmd_renderer_tpu.render import shade as ref_shade
from simple_mmd_renderer_tpu.utils import bezier as ref_bezier
from simple_mmd_renderer_tpu.utils import math3d as ref_m3
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import camera, pipeline, shade
from simple_mmd_renderer_tpu_torch.utils import bezier, math3d as m3

from test_torch_raster import _random_mesh, _with_big


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("angles", [(0.0, 0.0), (0.3, -0.2), (-2.5, 1.2)])
def test_orbit_camera(angles):
    target = np.array([0.1, 0.9, -0.3], np.float32)
    want = ref_camera.orbit_camera(target, -2.6, *angles)
    _close(camera.orbit_camera(target, -2.6, *angles, device="cpu"), want)


def test_ground_geometry():
    verts, tris = pipeline.ground_geometry(50.0, device="cpu")
    want_v, want_t = ref_pipeline.ground_geometry(50.0)
    assert verts.dtype == torch.float32 and tris.dtype == torch.int32
    assert np.array_equal(verts.numpy(), np.asarray(want_v))
    assert np.array_equal(tris.numpy(), np.asarray(want_t))


def test_linear_to_srgb():
    c = np.concatenate([np.linspace(-0.1, 1.5, 401),
                        [0.0031308, 0.0031309]]).astype(np.float32)
    _close(shade.linear_to_srgb(torch.as_tensor(c)),
           ref_shade.linear_to_srgb(jnp.asarray(c)))


def _light_inputs(seed=3, s=32, n=(24, 20)):
    """Light-space clip positions [..., 4] (some outside the frustum, some
    with tiny w) and a random shadow map [s, s]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2, 1.2, n + (4,)).astype(np.float32)
    pos[..., 2] = rng.uniform(-0.1, 1.1, n)
    pos[..., 3] = rng.choice([1.0, 0.7, 1e-10, -0.5], n,
                             p=[0.7, 0.2, 0.05, 0.05])
    return pos, rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)


@pytest.mark.parametrize("enabled", [True, False])
def test_pcf_shadow(enabled):
    pos, smap = _light_inputs()
    want = np.asarray(ref_shade.pcf_shadow(jnp.asarray(pos),
                                           jnp.asarray(smap), enabled))
    got = shade.pcf_shadow(torch.as_tensor(pos), torch.as_tensor(smap),
                           enabled).numpy()
    assert got.shape == want.shape == pos.shape[:-1] + (1,)
    assert np.array_equal(got, want)
    if enabled:
        assert 0.2 < (got < 1.0).mean() < 0.9       # lit and shadowed
    else:
        assert (got == 1.0).all()


@pytest.mark.parametrize("shadows,receive", [(True, True), (True, False),
                                             (False, True)])
def test_shade_ground(shadows, receive):
    pos, smap = _light_inputs(seed=4)
    albedo = np.random.default_rng(5).uniform(
        0, 1, pos.shape[:-1] + (3,)).astype(np.float32)
    want = ref_shade.shade_ground(jnp.asarray(albedo), jnp.asarray(pos),
                                  jnp.asarray(smap), shadows, receive)
    _close(shade.shade_ground(torch.as_tensor(albedo), torch.as_tensor(pos),
                              torch.as_tensor(smap), shadows, receive), want)


def _affines(rng, n=16):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    return q, t


def test_lerp():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(12, 3)).astype(np.float32)
    b = rng.normal(size=(12, 3)).astype(np.float32)
    ts = np.concatenate([[0.0, 1e-9, 1.0, 1.0 - 1e-9],
                         rng.uniform(0, 1, 8)]).astype(np.float32)
    _close(m3.lerp(torch.as_tensor(a), torch.as_tensor(b),
                   torch.as_tensor(ts)),
           ref_m3.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ts)))
    for t in (0.0, 0.25, 1.0):      # a scalar weight
        _close(m3.lerp(torch.as_tensor(a), torch.as_tensor(b), t),
               ref_m3.lerp(jnp.asarray(a), jnp.asarray(b), t))


def test_affine_helpers():
    rng = np.random.default_rng(7)
    q, t = _affines(rng)
    m_ref = ref_m3.mat_from_quat_trans(jnp.asarray(q), jnp.asarray(t))
    m = m3.mat_from_quat_trans(torch.as_tensor(q), torch.as_tensor(t))
    _close(m, m_ref)
    scaled = (np.asarray(m_ref) * np.concatenate(
        [rng.uniform(0.5, 2.0, (16, 3, 1)), np.ones((16, 1, 1))],
        1)).astype(np.float32)
    scaled[:, 3] = [0, 0, 0, 1]
    _close(m3.affine_inverse(torch.as_tensor(scaled)),
           ref_m3.affine_inverse(jnp.asarray(scaled)))
    p = rng.normal(size=(16, 3)).astype(np.float32)
    _close(m3.transform_point(torch.as_tensor(scaled), torch.as_tensor(p)),
           ref_m3.transform_point(jnp.asarray(scaled), jnp.asarray(p)))
    _close(m3.rotate_vec(torch.as_tensor(scaled), torch.as_tensor(p)),
           ref_m3.rotate_vec(jnp.asarray(scaled), jnp.asarray(p)))
    # inverse and transform round-trip
    back = m3.transform_point(m3.affine_inverse(torch.as_tensor(scaled)),
                              m3.transform_point(torch.as_tensor(scaled),
                                                 torch.as_tensor(p)))
    np.testing.assert_allclose(back.numpy(), p, atol=1e-5)


@pytest.mark.parametrize("form", ["empty", "float16", "rot3", "trans",
                                  "both"])
def test_affine_matches_reference(form):
    """`affine` as the reference takes it: `affine()` is eye(4) of float32,
    `dtype` sets an empty one's type, and the dtype otherwise comes from
    rot3 (else trans), whatever `dtype` says. Exact."""
    rng = np.random.default_rng(8)
    rot3 = rng.normal(size=(5, 3, 3))
    trans = rng.normal(size=(5, 3))
    args = {"empty": ({}, {}),
            "float16": ({}, dict(dtype=(jnp.float16, torch.float16))),
            "rot3": (dict(rot3=rot3.astype(np.float32)),
                     dict(dtype=(jnp.float16, torch.float16))),
            "trans": (dict(trans=trans.astype(np.float32)), {}),
            "both": (dict(rot3=rot3.astype(np.float32),
                          trans=trans.astype(np.float32)), {})}[form]
    arrays, dtype = args
    ref_kw = {**{k: jnp.asarray(v) for k, v in arrays.items()},
              **{k: v[0] for k, v in dtype.items()}}
    kw = {**{k: torch.as_tensor(v) for k, v in arrays.items()},
          **{k: v[1] for k, v in dtype.items()}}
    want = np.asarray(ref_m3.affine(**ref_kw))
    got = m3.affine(**kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_linear_lut():
    assert bezier.LINEAR_LUT.dtype == ref_bezier.LINEAR_LUT.dtype
    assert np.array_equal(bezier.LINEAR_LUT, ref_bezier.LINEAR_LUT)


@pytest.mark.parametrize("case", ["sparse", "dense", "big", "tile8"])
def test_binning_stats(case):
    """The counts of the reference's binning, with and without oversized
    triangles, at 32- and 8-row tiles."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "dense":
        clip, tris = _random_mesh(rng, t=500, spread=0.05, size=0.08)
    else:
        clip, tris = _random_mesh(rng, t=150)
    if case == "big":
        clip, tris = _with_big(clip, tris)
    args = (256, 128, ref_raster.CULL_NONE, 2 if case == "big" else 6, 128,
            8 if case == "tile8" else None)
    want = ref_tr.binning_stats(jnp.asarray(clip), jnp.asarray(tris), *args)
    got = tr.binning_stats(torch.as_tensor(clip), torch.as_tensor(tris),
                           *args)
    assert got == want
    assert got["total_entries"] >= got["max_tile_entries"] > 0
    # 8-row tiles make some triangles oversized too
    assert (got["n_big"] > 0) == (case in ("big", "tile8"))
