"""The "wild" asset against the port: tests/wild_assets.py's PMX (120
materials, a 30-bone chain under an 8-link IK with a loop count of 255, a
second IK chain that shares 6 of its bones, 90 bones with every optional
block, 48 box, capsule and sphere bodies of every kind, ghost and strict
included, and 40 joints) and its VMD (keys out of order, junk after the
names' NUL, frames past 100,000).

- Both packages build it: the port's own reader and builders (`parse_pmx`,
  `parse_vmd`, `build_model`, `build_physics`, `bind_motion`) give the
  reference's objects, as `convert` carries them, field by field.
- The scene (96x72, shadow 64^2, no skybox, 2 solver iterations) steps 3
  frames in both packages through tests/test_torch_slice.py's
  `compare_slice`, each frame rendered by the scan raster and by the
  tiled raster.

Tolerances (port vs the jitted reference), each beside its measured value
(this file's configuration, CPU):
- images, as compare_slice: fewer than 2e-3 of the pixels off by more
  than 0.02 and a mean absolute difference below 1/255. Measured: no
  pixel beyond 0.02, mean at most 8.7e-7 (scan and tiled).
- kinematic bodies on IK-driven bones: held at 1e-4, tighter than
  compare_slice's IK_ATOL. Measured: 1.2e-5 (quat), 6.2e-6 (pos).
- the other bodies: held at pos 2e-3, quat 5e-3, vel 6e-2 and omega 0.2,
  about twice the measured pos 8.9e-4, quat 2.7e-3, vel 3.7e-2 and omega
  0.100 (compare_slice's BODY_ATOL of 1e-4 is tighter). The largest sit on
  the dynamic bodies of the IK chain's link bones (bones 24 and 28), whose
  CCD result differs in the last bits (PARITY D1: the posed vertices
  differ by up to 3.2e-3 after frame 1), and grow through the chain's
  joints; the box bodies, strict and ghost, differ by at most 2.3e-5, the
  kinematic bodies that are not IK-driven by 2.3e-10. The reference's own
  eager run differs from its jitted run less on this scene (at most pos
  1.0e-5, quat 3.4e-5, vel 4.0e-4, omega 2.7e-3 over frames 1-3), so
  these are the port's levels, not the reference's.
"""

import numpy as np

from simple_mmd_renderer_tpu.config import AppConfig, RenderConfig
from simple_mmd_renderer_tpu.core import anim as ref_anim
from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.formats import vmd as ref_vmd
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core import anim, model, physics
from simple_mmd_renderer_tpu_torch.formats import pmx, vmd

from test_torch_builders import _assert_same
from test_torch_slice import compare_slice
from wild_assets import (N_BONES, N_JOINTS, N_MATS, N_RIGID, build_wild_pmx,
                         build_wild_vmd)

import torch_threads  # noqa: F401  (the port's tests' thread cap)

BODY_ATOL = {"pos": 2e-3, "quat": 5e-3, "vel": 6e-2, "omega": 0.2}
IK_ATOL = {"pos": 1e-4, "quat": 1e-4}


def _reference():
    pm = ref_pmx.parse_pmx(build_wild_pmx())
    static = ref_model.build_model(pm)
    return (pm, static, ref_physics.build_physics(static),
            ref_anim.bind_motion(static, ref_vmd.parse_vmd(build_wild_vmd())))


def test_wild_asset_builds_the_same_in_both_packages():
    pm, static, phys, motion = _reference()
    assert (len(pm.materials), len(pm.bones), len(pm.rigid_bodies),
            len(pm.constraints)) == (N_MATS, N_BONES, N_RIGID, N_JOINTS)
    port_pm = pmx.parse_pmx(build_wild_pmx())
    _assert_same(port_pm, pm)
    port_static = model.build_model(port_pm)
    _assert_same(port_static, convert.model_static(static))
    _assert_same(physics.build_physics(port_static),
                 convert.physics_static(phys))
    _assert_same(anim.bind_motion(port_static,
                                  vmd.parse_vmd(build_wild_vmd())),
                 convert.motion_arrays(motion))


def test_wild_asset_slice_matches_reference_three_frames():
    _, static, phys, motion = _reference()
    cfg = AppConfig()
    cfg.render = RenderConfig(width=96, height=72, shadow_map_size=64,
                              show_skybox=False, raster_mode="scan")
    cfg.physics.solver_iterations = 2
    ref = RefScene(static, phys, motion, cfg)
    kinds = np.asarray(ref.phys_static.kinematic)
    assert 0 < kinds.sum() < ref.phys_static.n_bodies
    compare_slice(ref, 3, renders={mode: dict(raster_mode=mode)
                                   for mode in ("scan", "tiled")},
                  body_atol=BODY_ATOL, ik_atol=IK_ATOL)
