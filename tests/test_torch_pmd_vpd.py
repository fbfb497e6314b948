"""The port's PMD and VPD readers, `write_pmx` and the `models` index
against the reference's, on the CPU.

- `parse_pmd` / `load_pmd`: field by field (np.array_equal, dtypes too)
  on tests/test_pmd.py's byte builder (every PMD conversion rule: BDEF2
  vertices, bone types, the "[IK]" duplicate, knee limits, the x4 CCD
  angle, the base-morph remap, bone-relative bodies, the ghost body) and
  on `chip_smoke.pmd_bytes` of the sample character at density 0.25;
  `build_model` of both equal; and one frame of the sample PMD (64x48,
  shadow 64^2, the rest pose) against the reference's
  `raster_mode="tiled"` frame at the whole-frame tolerance (fewer than
  2e-3 of the pixels off by more than 0.02, mean below 1/255; measured: the
  largest difference 6.0e-8, mean 1.4e-10);
- `parse_vpd` / `load_vpd`: field by field on tests/test_vpd.py's pose,
  the reference's error cases raise the port's `ParseError`, and the bound
  pose holds at every time (`bind_motion` + `sample_motion` at frames 0,
  7.5 and 1000, equal to the reference's);
- `write_pmx`: bytes equal to the reference's for `sample_character()`
  and `two_bone_arm()` (UTF-8 and UTF-16), and the port's `parse_pmx` of
  them equal to the reference's;
- `models`: the reference's `__all__`, each name the port's own object.
"""

import os

import numpy as np
import jax
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu import models as ref_models
from simple_mmd_renderer_tpu.app.sample import (
    sample_character as ref_sample_character)
from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.formats import pmd as ref_pmd
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.formats import vpd as ref_vpd
from simple_mmd_renderer_tpu.formats import writers as ref_writers
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu.utils.io import ParseError as RefParseError
from simple_mmd_renderer_tpu_torch import convert, models
from simple_mmd_renderer_tpu_torch.app.sample import sample_character
from simple_mmd_renderer_tpu_torch.core import anim, model
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.formats import pmd, pmx, vpd, writers
from simple_mmd_renderer_tpu_torch.render import pipeline
from simple_mmd_renderer_tpu_torch.utils.io import ParseError

from fixtures import two_bone_arm
from test_pmd import _build_pmd_bytes
from test_torch_builders import _assert_same
from test_torch_textured_slice import _assert_frames_close, _port_cfg
from test_vpd import VPD_TEXT, _vpd_bytes

import chip_smoke


@pytest.fixture(scope="module")
def sample_pmd():
    return chip_smoke.pmd_bytes(sample_character(density=0.25))


@pytest.mark.parametrize("which", ["builder", "sample"])
def test_parse_pmd_matches_reference(sample_pmd, which, tmp_path):
    data = _build_pmd_bytes() if which == "builder" else sample_pmd
    got = pmd.parse_pmd(data)
    assert isinstance(got, pmx.PmxModel)
    want = ref_pmd.parse_pmd(data)
    _assert_same(got, want)
    _assert_same(model.build_model(got), ref_model.build_model(want))
    path = os.path.join(tmp_path, "m.pmd")
    with open(path, "wb") as f:
        f.write(data)
    _assert_same(pmd.load_pmd(path), want)
    if which == "builder":      # two of the rules, as tests/test_pmd.py
        assert got.bones[4].ik_angle == np.float32(0.5 * 4.0)
        assert got.rigid_bodies[1].type == pmx.RIGID_PHYSICS_GHOST


def test_parse_pmd_errors_match_reference():
    """Truncated, bad magic, a forged face count: the port raises its own
    ParseError where the reference raises its."""
    data = _build_pmd_bytes()
    for bad in (data[:40], b"Pmx" + data[3:], data[:len(data) // 2]):
        with pytest.raises(RefParseError):
            ref_pmd.parse_pmd(bad)
        with pytest.raises(ParseError):
            pmd.parse_pmd(bad)


def test_pmd_frame_matches_reference(sample_pmd):
    """The sample character read from PMD bytes, rendered in its rest pose
    by both packages."""
    static = ref_model.build_model(ref_pmd.parse_pmd(sample_pmd))
    rig = ModelTables(convert.model_static(static), "cpu")
    cfg = RenderConfig(width=64, height=48, shadow_map_size=64,
                       show_skybox=False, raster_mode="tiled")
    pos, nrm = np.asarray(static.positions), np.asarray(static.normals)
    want = np.asarray(jax.jit(lambda p, n: ref_pipeline.render_frame(
        static, p, n, cfg))(pos, nrm))
    got = pipeline.render_frame(rig, torch.as_tensor(pos),
                                torch.as_tensor(nrm), _port_cfg(cfg)).numpy()
    _assert_frames_close(got[None], want[None], "pmd frame")
    assert got.std() > 0.05


def test_parse_vpd_matches_reference(tmp_path):
    got = vpd.parse_vpd(_vpd_bytes(), name="p")
    want = ref_vpd.parse_vpd(_vpd_bytes(), name="p")
    _assert_same(got, want)
    assert got.length == 0
    path = os.path.join(tmp_path, "pose.vpd")
    with open(path, "wb") as f:
        f.write(_vpd_bytes())
    _assert_same(vpd.load_vpd(path), ref_vpd.load_vpd(path))


@pytest.mark.parametrize("bad", [
    b"not a pose file\n",
    "Vocaloid Pose Data file\n\nx.osm;\n0;\n".encode(),
    _vpd_bytes(VPD_TEXT.replace("0.100000,2.000000,-0.300000", "0.1,2.0")),
    _vpd_bytes(VPD_TEXT.replace("0.750000", "zero.75"))],
    ids=["magic", "no-blocks", "count", "non-numeric"])
def test_parse_vpd_errors_match_reference(bad):
    with pytest.raises(RefParseError) as ref_err:
        ref_vpd.parse_vpd(bad)
    with pytest.raises(ParseError) as err:
        vpd.parse_vpd(bad)
    assert str(err.value) == str(ref_err.value)


def test_vpd_pose_holds_like_the_reference():
    static = ref_model.build_model(two_bone_arm())
    want = ref_anim.bind_motion(static, ref_vpd.parse_vpd(_vpd_bytes()))
    got = anim.bind_motion(convert.model_static(static),
                           vpd.parse_vpd(_vpd_bytes()))
    tables = anim.MotionTables(got, "cpu")
    for frame in (0.0, 7.5, 1000.0):
        rot, trans = ref_anim.sample_bones(want, frame)
        rates = ref_anim.sample_morphs(want, frame)
        p_rot, p_trans, p_rates = anim.sample_motion(
            tables, torch.tensor(frame, dtype=torch.float32))
        np.testing.assert_array_equal(p_rot.numpy(), np.asarray(rot))
        np.testing.assert_array_equal(p_trans.numpy(), np.asarray(trans))
        np.testing.assert_array_equal(p_rates.numpy(), np.asarray(rates))
        np.testing.assert_allclose(p_trans[0].numpy(), [0.1, 2.0, -0.3],
                                   atol=1e-6)
        assert float(p_rates.max()) == pytest.approx(0.75)


@pytest.mark.parametrize("which", ["sample", "arm"])
@pytest.mark.parametrize("utf8", [True, False], ids=["utf8", "utf16"])
def test_write_pmx_matches_reference(which, utf8):
    """The same bytes as the reference's writer; the port's reader of them
    gives the reference reader's model."""
    if which == "sample":
        got = writers.write_pmx(sample_character(), utf8=utf8)
        want = ref_writers.write_pmx(ref_sample_character(), utf8=utf8)
    else:
        got = writers.write_pmx(two_bone_arm(), utf8=utf8)
        want = ref_writers.write_pmx(two_bone_arm(), utf8=utf8)
    assert got == want
    _assert_same(pmx.parse_pmx(got), ref_pmx.parse_pmx(want))


def test_models_index_matches_reference():
    assert models.__all__ == ref_models.__all__
    for name in models.__all__:
        obj = getattr(models, name)
        assert obj.__module__.startswith("simple_mmd_renderer_tpu_torch."), \
            name
        assert obj.__name__ == getattr(ref_models, name).__name__
    assert models.parse_pmd is pmd.parse_pmd
    assert models.load_pmd is pmd.load_pmd
