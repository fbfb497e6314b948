"""Kernel K3 (ground 3x3 PCF lit map) and the ground pass: port vs reference.

The reference runs its Pallas `pcf_lit_map_tiled` in interpret mode on the
CPU; the port runs its plain PyTorch version (`pcf_lit_map_plain`, what
the CUDA kernel is checked against on the card). Both take the plane as
the reference does, (shadow_map, z0, zc, zr): a shared plane as Python
floats or 0-d arrays, or per-map planes against the reference's
`jax.vmap(pcf_lit_map)` over batched planes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.ops import shadow_pcf as ref_pcf
from simple_mmd_renderer_tpu.render import camera as ref_cam
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu.render import shade as ref_shade
from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
from simple_mmd_renderer_tpu_torch.render import camera, pipeline, shade

import torch_threads  # noqa: F401  (the port's tests' thread cap)


def _light_vp():
    """A plausible ortho light VP (as tests/test_render.py's PCF test)."""
    light_dir = np.array([0.3, -1.0, 0.2], np.float32)
    light_dir /= np.linalg.norm(light_dir)
    view = ref_cam.look_at(jnp.asarray(-50.0 * light_dir),
                           jnp.zeros(3, jnp.float32),
                           jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    proj = ref_cam.orthographic(-5.0, 5.0, -5.0, 5.0, 0.1, 100.0)
    return np.array(proj @ view)


def _count_off_by_ninth(got, ref):
    """Texels that differ; each must differ by exactly one tap (1/9)."""
    diff = np.abs(got - ref)
    off = diff > 0
    if off.any():
        np.testing.assert_allclose(diff[off], np.float32(1.0 / 9.0),
                                   rtol=1e-6)
    return int(off.sum())


def test_pcf_plain_matches_pallas_kernel():
    """S=256, random map. Expected bit-exact; at most 1e-4 of texels may
    differ, each by exactly 1/9 (a one-ulp zref difference flips one tap).
    Measured: 0 texels differ."""
    rng = np.random.default_rng(7)
    s = 256
    smap = rng.random((s, s), np.float32)
    z0, zc, zr = ref_shade._ground_zref_plane(s, jnp.asarray(_light_vp()),
                                              0.001)
    ref = np.asarray(ref_pcf.pcf_lit_map_tiled(jnp.asarray(smap), z0, zc, zr))
    got = shadow_pcf.pcf_lit_map(torch.as_tensor(smap), float(z0), float(zc),
                                 float(zr)).numpy()
    assert _count_off_by_ninth(got, ref) <= 1e-4 * s * s


def test_pcf_plain_batched_and_edges():
    """A batch [B,S,S] maps each map independently, and the edge taps clamp
    like the reference's edge pre-pad (a map with a deep border)."""
    rng = np.random.default_rng(8)
    s = 128
    maps = rng.random((2, s, s), np.float32)
    maps[1, :, 0] = 0.0
    maps[1, -1, :] = 1.0
    got = shadow_pcf.pcf_lit_map(torch.as_tensor(maps), 0.5, 1e-3,
                                 -2e-3).numpy()
    for b in range(2):
        ref = np.asarray(ref_pcf.pcf_lit_map_tiled(
            jnp.asarray(maps[b]), jnp.float32(0.5), jnp.float32(1e-3),
            jnp.float32(-2e-3)))
        assert _count_off_by_ninth(got[b], ref) <= 1e-4 * s * s


@pytest.fixture(scope="module")
def planes_case():
    """B = 3 maps of S = 128 with a plane each, and the reference's lit
    maps: `pcf_lit_map` with the first plane shared (the three scalars)
    and `jax.vmap(pcf_lit_map)` over the batched planes (its
    `_pcf_lit_map_vmap` branch)."""
    rng = np.random.default_rng(12)
    b, s = 3, 128
    maps = rng.random((b, s, s), np.float32)
    z0 = np.float32([0.5, 0.45, 0.55])
    zc = np.float32([1e-3, 2e-3, -1e-3])
    zr = np.float32([-2e-3, 1e-3, 5e-4])
    shared = np.asarray(ref_pcf.pcf_lit_map(jnp.asarray(maps), z0[0], zc[0],
                                            zr[0]))
    per_map = np.asarray(jax.vmap(ref_pcf.pcf_lit_map)(
        jnp.asarray(maps), jnp.asarray(z0), jnp.asarray(zc),
        jnp.asarray(zr)))
    return maps, (z0, zc, zr), shared, per_map


@pytest.mark.parametrize("fn", ["pcf_lit_map", "pcf_lit_map_tiled"])
@pytest.mark.parametrize("form", ["floats", "0-d", "per_map"])
def test_pcf_planes_match_reference(planes_case, fn, form):
    """Scalar, 0-d and per-map planes through the port's `pcf_lit_map` and
    `pcf_lit_map_tiled` equal the reference's (B = 3, S = 128). Expected
    bit-exact; at most 1e-4 of texels may differ, each by exactly 1/9 (as
    test_pcf_plain_matches_pallas_kernel). Measured: 0 texels differ."""
    maps, (z0, zc, zr), shared, per_map = planes_case
    if form == "floats":
        args, ref = (float(z0[0]), float(zc[0]), float(zr[0])), shared
    elif form == "0-d":
        args = tuple(torch.tensor(v[0]) for v in (z0, zc, zr))
        ref = shared
    else:
        args, ref = tuple(torch.as_tensor(v) for v in (z0, zc, zr)), per_map
    got = getattr(shadow_pcf, fn)(torch.as_tensor(maps), *args).numpy()
    assert _count_off_by_ninth(got, ref) <= 1e-4 * got.size
    # per map, each map is its own plane's lit map
    if form == "per_map":
        for i in range(3):
            one = shadow_pcf.pcf_lit_map(torch.as_tensor(maps[i]),
                                         float(z0[i]), float(zc[i]),
                                         float(zr[i])).numpy()
            assert np.array_equal(one, got[i])


def test_pcf_rejects_planes_of_another_batch():
    with pytest.raises(ValueError, match="z0"):
        shadow_pcf.pcf_lit_map(torch.zeros((2, 8, 8)), torch.zeros(3), 0.0,
                               0.0)


def test_ground_lit_map_matches_reference():
    """shade.ground_lit_map: the zref plane and the PCF together, S=256."""
    rng = np.random.default_rng(9)
    s = 256
    smap = rng.random((s, s), np.float32)
    vp = _light_vp()
    ref = np.asarray(ref_shade.ground_lit_map(jnp.asarray(smap),
                                              jnp.asarray(vp)))
    got = shade.ground_lit_map(torch.as_tensor(smap),
                               torch.as_tensor(vp)).numpy()
    assert _count_off_by_ninth(got, ref) <= 1e-4 * s * s
    rz = ref_shade._ground_zref_plane(s, jnp.asarray(vp), 0.001)
    pz = shade._ground_zref_plane(s, torch.as_tensor(vp), 0.001)
    np.testing.assert_allclose([float(x) for x in pz],
                               [float(x) for x in rz], rtol=1e-6, atol=1e-9)


def test_ground_pass_lookup_and_upsample_match_reference():
    """The ground's screen path at 128x96: ray/plane hits (with the halo
    rows of the downsampled lookup), the lit-map lookup and the bilinear
    upsample."""
    cfg = RenderConfig(width=128, height=96)
    rm = ref_pipeline.build_matrices(cfg, aspect=128 / 96)
    pm = pipeline.build_matrices(cfg, aspect=128 / 96)
    for k in ("view", "proj", "mvp", "light_vp"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(rm[k]),
                                   rtol=1e-6, atol=1e-6)
    view, proj = rm["view"], rm["proj"]
    tview, tproj = torch.as_tensor(np.array(view)), torch.as_tensor(
        np.array(proj))
    for args in ((128, 96), (32, 24, -1, 26)):
        r = ref_pipeline.ground_pass(cfg, view, proj, *args)
        g = pipeline.ground_pass(cfg, tview, tproj, *args)
        mask = np.asarray(r[0])
        assert np.array_equal(g[0].numpy(), mask)
        # hits on the ground (the pixels that use them): the two inverses
        # of vp differ in the last bits, which grazing rays amplify with
        # distance — measured 7.1e-5 relative (3.2 mm at 50 m)
        hit, ref_hit = g[1].numpy()[mask], np.asarray(r[1])[mask]
        np.testing.assert_array_less(
            np.abs(hit - ref_hit) / (np.abs(ref_hit) + 1.0), 2e-4)
        np.testing.assert_allclose(g[2].numpy(), np.asarray(r[2]),
                                   atol=1e-6)
    rng = np.random.default_rng(10)
    lit_map = rng.random((64, 64), np.float32)
    lclip = rng.uniform(-1.2, 1.2, (26, 32, 4)).astype(np.float32)
    lclip[..., 3] = 1.0
    rl = ref_shade.ground_shadow_lookup(jnp.asarray(lclip),
                                        jnp.asarray(lit_map),
                                        jnp.asarray(True))
    gl = shade.ground_shadow_lookup(torch.as_tensor(lclip),
                                    torch.as_tensor(lit_map))
    assert np.array_equal(gl.numpy(), np.asarray(rl))
    ru = ref_pipeline.upsample_bilinear_int(rl, 4, pre_padded_rows=True)
    gu = pipeline.upsample_bilinear_int(gl, 4, pre_padded_rows=True)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ru), atol=1e-6)


def test_unproject_depth_matches_reference():
    cfg = RenderConfig(width=64, height=48)
    m = ref_pipeline.build_matrices(cfg, aspect=64 / 48)
    vp = np.array(m["proj"] @ m["view"])
    depth = np.random.default_rng(11).uniform(0.9, 1.0, (48, 64)).astype(
        np.float32)
    ref = np.asarray(ref_pipeline.unproject_depth(jnp.asarray(depth),
                                                  jnp.asarray(vp), 64, 48))
    got = pipeline.unproject_depth(torch.as_tensor(depth),
                                   torch.as_tensor(vp), 64, 48).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_camera_matrices_match_reference():
    np.testing.assert_allclose(
        camera.perspective(camera.deg2rad(45.0), 16 / 9, 0.1, 1000.0).numpy(),
        np.asarray(ref_cam.perspective(jnp.deg2rad(45.0), 16 / 9, 0.1,
                                       1000.0)), rtol=1e-6)
    d = np.array([0.3, -1.0, 0.2], np.float32)
    np.testing.assert_allclose(
        camera.directional_light_view(d).numpy(),
        np.asarray(ref_cam.directional_light_view(d)), rtol=1e-6, atol=1e-5)
    # the straight-down light takes the alternate up vector
    d2 = np.array([0.0, -1.0, 0.0], np.float32)
    np.testing.assert_allclose(
        camera.directional_light_view(d2).numpy(),
        np.asarray(ref_cam.directional_light_view(d2)), rtol=1e-6, atol=1e-5)
