"""The port's HDR reader/writer and image-based lighting against the
reference's: `formats/hdr.py` (`write_hdr`, `parse_hdr` flat and RLE,
`load_hdr`) and `render/ibl.py` (`equirect_to_cubemap`, `sample_cubemap`,
`aces_tonemap`, `skybox_colors`).

Inputs are seeded NumPy arrays. Tolerances: HDR bytes and decoded
radiance exactly equal. The cube mapping picks nearest texels by
truncating float coordinates, so one ulp of `atan2`/`acos` (or of a face
tie) can move a texel: those are held by the share of texels or pixels
that differ, below 1e-3; measured here 0 of 3,456 cubemap texels, 0 of
20,000 random directions and 0 of 3,072 skybox pixels. ACES at 1e-6
(measured 0: the same bits); the skybox's colours at 1e-5 beyond that
share (measured at most 1.2e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.formats import hdr as ref_hdr
from simple_mmd_renderer_tpu.render import ibl as ref_ibl
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu_torch import config
from simple_mmd_renderer_tpu_torch.app.sample import sample_equirect
from simple_mmd_renderer_tpu_torch.formats import hdr
from simple_mmd_renderer_tpu_torch.render import ibl, pipeline

import torch_threads  # noqa: F401  (the port's tests' thread cap)

SHARE = 1e-3      # the most texels or pixels that may pick another texel


def _image(seed=0, h=12, w=20):
    """Seeded HDR radiance with zeros, tiny values and values above 1."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    img[0, :3] = 0.0
    img[1, :2] = 1e-33
    img[2, 0] = [65.0, 0.5, 0.001]
    return img


def test_write_hdr_bytes_equal_the_reference(tmp_path):
    img = _image()
    ref_path, port_path = tmp_path / "ref.hdr", tmp_path / "port.hdr"
    ref_hdr.write_hdr(str(ref_path), img)
    hdr.write_hdr(str(port_path), img)
    assert port_path.read_bytes() == ref_path.read_bytes()


def test_flat_hdr_reads_agree_both_ways(tmp_path):
    """Each package reads the other's flat file to the same radiance,
    which `load_hdr` and `parse_hdr` both give."""
    img = _image(1)
    ref_path, port_path = tmp_path / "ref.hdr", tmp_path / "port.hdr"
    ref_hdr.write_hdr(str(ref_path), img)
    hdr.write_hdr(str(port_path), img)
    want = ref_hdr.load_hdr(str(port_path))
    got = hdr.load_hdr(str(ref_path))
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hdr.parse_hdr(ref_path.read_bytes()), got)
    # the round trip keeps 8 bits of the brightest channel's mantissa
    # (radiance below 1e-30 is written as black)
    assert (np.abs(got - img)
            <= img.max(-1, keepdims=True) / 128 + 1e-30).all()


def _rle_scanlines(rgbe):
    """Hand-encoded new-style RLE scanlines of rgbe [H,W,4] uint8: per row
    the 0x02 0x02 width header, then per channel runs (count > 128) of
    repeated bytes and literals (count <= 128) of the rest."""
    out = bytearray()
    h, w = rgbe.shape[:2]
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                n = 1
                while x + n < w and row[x + n] == row[x] and n < 127:
                    n += 1
                if n >= 3:
                    out += bytes([128 + n, int(row[x])])
                    x += n
                else:
                    lit = min(w - x, 3)
                    out += bytes([lit]) + row[x:x + lit].tobytes()
                    x += lit
    return bytes(out)


def test_rle_hdr_reads_agree():
    """A hand-encoded RLE buffer (runs and literals in every channel) reads
    to the same radiance in both packages, equal to the decoded RGBE."""
    rng = np.random.default_rng(2)
    h, w = 5, 19
    rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[:, 4:12, :] = rgbe[:, 4:5, :]        # runs
    rgbe[1, :, 3] = 0                         # a row of zero exponents
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode() + _rle_scanlines(rgbe))
    got = hdr.parse_hdr(data)
    np.testing.assert_array_equal(got, ref_hdr.parse_hdr(data))
    np.testing.assert_array_equal(got, hdr._decode_rgbe(rgbe))
    assert (got[1] == 0).all() and got.max() > 0


@pytest.mark.parametrize("data,match", [
    (b"P6\n", "not a Radiance"),
    (b"#?RADIANCE\n\n+Y 2 +X 2\n" + bytes(16), "orientation"),
    (b"#?RGBE\n\n-Y 1 +X 8\n" + bytes([2, 2, 0, 8, 1, 1]) + bytes(40),
     "corrupt"),
], ids=["magic", "orientation", "rle-header"])
def test_bad_hdr_raises_as_the_reference(data, match):
    if match == "corrupt":
        # a second scanline without its header
        data = (b"#?RGBE\n\n-Y 2 +X 8\n" + bytes([2, 2, 0, 8])
                + bytes([136, 7]) * 4 + bytes([9, 9, 9, 9]) + bytes(40))
    for parse in (hdr.parse_hdr, ref_hdr.parse_hdr):
        with pytest.raises(ValueError, match=match):
            parse(data)


@pytest.fixture(scope="module")
def equirect():
    return sample_equirect(40, 80, seed=3)


def test_equirect_to_cubemap_matches_reference(equirect):
    want = np.asarray(ref_ibl.equirect_to_cubemap(jnp.asarray(equirect), 24))
    got = ibl.equirect_to_cubemap(equirect, 24, device="cpu")
    assert got.shape == (6, 24, 24, 3) and got.dtype == torch.float32
    off = (got.numpy() != want).any(-1).mean()
    assert off < SHARE, off
    # a tensor input keeps its device
    again = ibl.equirect_to_cubemap(torch.as_tensor(equirect), 24)
    assert torch.equal(again, got)


def test_sample_cubemap_matches_reference(equirect):
    """Random directions, axis-aligned ones and exact face ties."""
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(20_000, 3)).astype(np.float32)
    ties = np.array([[1, 1, 0], [1, -1, 1], [0, 0, -1], [-1, 0, 0],
                     [0.5, 0.5, 0.5], [0, 1, 0]], np.float32)
    dirs = np.concatenate([dirs, ties])
    cube = np.array(ref_ibl.equirect_to_cubemap(jnp.asarray(equirect), 16))
    want = np.asarray(ref_ibl.sample_cubemap(cube, jnp.asarray(dirs)))
    got = ibl.sample_cubemap(torch.as_tensor(cube), torch.as_tensor(dirs))
    assert got.shape == want.shape
    assert (got.numpy() != want).any(-1).mean() < SHARE
    np.testing.assert_array_equal(got.numpy()[-len(ties):],
                                  want[-len(ties):])


def test_aces_tonemap_matches_reference():
    x = np.random.default_rng(5).uniform(0.0, 30.0, (4096, 3)).astype(
        np.float32)
    want = np.asarray(ref_ibl.aces_tonemap(jnp.asarray(x)))
    got = ibl.aces_tonemap(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_skybox_colors_match_reference(equirect):
    """The flagship camera's skybox at 64x48 from the same cubemap."""
    cube = np.array(ref_ibl.equirect_to_cubemap(jnp.asarray(equirect), 16))
    cfg = RenderConfig(width=64, height=48)
    mats = ref_pipeline.build_matrices(cfg, None, aspect=64 / 48)
    want = np.asarray(jax.jit(lambda v, p: ref_ibl.skybox_colors(
        cube, v, p, 64, 48))(mats["view"], mats["proj"]))
    pcfg = config.RenderConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    pm = pipeline.build_matrices(pcfg, aspect=64 / 48, device="cpu")
    got = ibl.skybox_colors(torch.as_tensor(cube), pm["view"], pm["proj"],
                            64, 48).numpy()
    assert got.shape == (48, 64, 3)
    d = np.abs(got - want).max(-1)
    assert (d > 1e-5).mean() < SHARE
    assert np.median(d) < 1e-6 and got.std() > 0.01
