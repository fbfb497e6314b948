"""The port's extended morphs and true SDEF against the reference, on the
CPU: `utils.math3d.mat3_to_quat`, `core.pose.uv_morph_offsets`,
`ext_uv_morph_offsets` and `material_morph_factors` (on a pose's leaf rates
[M], and a crowd's [I, M]), `Scene.morphed_extra_uvs`, the SDEF tables
`ModelTables` gathers once and `core.pose.deform(sdef=True)` (single and
crowd), and the capturable step with SDEF on.

Inputs: the reference's fixtures (`tests/fixtures.two_bone_arm`, whose
4th vertex is SDEF, and `tests/test_extended_morphs.
_model_with_extended_morphs`: a UV morph, a multiply and an all-materials
additive material morph), and `chip_smoke.content_rig` at density 0.25
(the sample character with its forearm, thigh and shin BDEF2 vertices made
SDEF, a UV morph on part 0, a multiply and an add entry on part 1, through
`write_pmx` and `parse_pmx`), both packages built from the same bytes or
objects. Random inputs from `np.random.default_rng` with fixed seeds.

Tolerances, each with the value measured here:
- the morph tables: bit for bit (measured: equal);
- `mat3_to_quat`: 2e-7 (measured 1.2e-7);
- `deform(sdef=True)`: positions 2e-5, normals 2e-6 on the content rig
  (measured 2.9e-6 and 4.2e-7, the crowd's the same: the blended matrix
  products differ in their last bits); the two-bone arm 1e-6 (measured
  1.2e-7 and 6.0e-8).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.core import model as ref_model
from simple_mmd_renderer_tpu.core import pose as ref_pose
from simple_mmd_renderer_tpu.core import physics as ref_physics
from simple_mmd_renderer_tpu.core.scene import Scene as RefScene
from simple_mmd_renderer_tpu.config import AppConfig as RefAppConfig
from simple_mmd_renderer_tpu.formats import pmx as ref_pmx
from simple_mmd_renderer_tpu.utils import math3d as ref_m3
from simple_mmd_renderer_tpu_torch import convert
from simple_mmd_renderer_tpu_torch.core import pose
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.core.scene import Scene
from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx
from simple_mmd_renderer_tpu_torch.utils import math3d as m3

from fixtures import two_bone_arm
from test_extended_morphs import _model_with_extended_morphs
from test_torch_compiled_step import host_guard

import chip_smoke


def _tables(static):
    return ModelTables(convert.model_static(static), "cpu")


@pytest.fixture(scope="module")
def morphs():
    """(reference ModelStatic, port tables) of the extended-morph fixture
    with a group morph (rate 0.5 onto the multiply morph) appended."""
    pm, _ = _model_with_extended_morphs()
    pm.morphs.append(ref_pmx.Morph("G", "g", 0, ref_pmx.MORPH_GROUP,
                                   group_indices=np.array([4], np.int32),
                                   group_rates=np.array([0.5], np.float32)))
    static = ref_model.build_model(pm)
    return static, _tables(static)


@pytest.fixture(scope="module")
def content():
    """(reference ModelStatic, port tables, SDEF count) of the content rig
    at density 0.25, both built from the port's PMX bytes."""
    pm, n_sdef = chip_smoke.content_rig(0.25)
    static = ref_model.build_model(ref_pmx.parse_pmx(write_pmx(pm)))
    return static, _tables(static), n_sdef


def _quats(rng, n, max_angle):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(-max_angle, max_angle, (n, 1))
    return np.concatenate([axis * np.sin(ang / 2), np.cos(ang / 2)],
                          1).astype(np.float32)


def test_mat3_to_quat_matches_reference_on_every_branch():
    """Random rotations, and rotations of 150-179.9 deg about the three axes,
    reach each of the four pivots (trace, x, y, z)."""
    rng = np.random.default_rng(0)
    qs = [_quats(rng, 2000, np.pi)]
    for k in range(3):
        ang = np.deg2rad(rng.uniform(150, 179.9, 200))
        q = np.zeros((200, 4), np.float32)
        q[:, k] = np.sin(ang / 2)
        q[:, 3] = np.cos(ang / 2)
        qs.append(q)
    q = np.concatenate(qs)
    mats = np.asarray(ref_m3.quat_to_mat3(jnp.asarray(q)))
    d = np.diagonal(mats, axis1=1, axis2=2)
    piv = np.stack([1 + d.sum(1), 1 + d[:, 0] - d[:, 1] - d[:, 2],
                    1 - d[:, 0] + d[:, 1] - d[:, 2],
                    1 - d[:, 0] - d[:, 1] + d[:, 2]], 1)
    assert set(np.argmax(piv, 1).tolist()) == {0, 1, 2, 3}
    want = np.asarray(ref_m3.mat3_to_quat(jnp.asarray(mats)))
    got = m3.mat3_to_quat(torch.as_tensor(mats.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert (got[:, 3] >= 0).all()


def _leaf(static, rates):
    return (np.asarray(rates, np.float32) @ static.morph_expand).astype(
        np.float32)


@pytest.mark.parametrize("fn", ["uv_morph_offsets", "ext_uv_morph_offsets",
                                "material_morph_factors"])
def test_morph_functions_match_reference(morphs, fn):
    """Random rates (the group morph included), one pose's [M] and a crowd's
    [3, M] (each instance against the reference on its own rates)."""
    static, rig = morphs
    rng = np.random.default_rng(1)
    rates = rng.uniform(0, 1, (3, static.n_morphs)).astype(np.float32)
    rates[0] = 0.0
    rates[0, -1] = 1.0          # the group morph alone drives its leaf
    leaf = np.stack([_leaf(static, r) for r in rates])
    crowd = getattr(pose, fn)(rig, torch.as_tensor(leaf))
    for i in range(3):
        want = getattr(ref_pose, fn)(static, jnp.asarray(leaf[i]))
        got = getattr(pose, fn)(rig, torch.as_tensor(leaf[i]))
        for g, c, w in zip(*(x if isinstance(x, tuple) else (x,)
                             for x in (got, crowd, want))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(c[i].numpy(), np.asarray(w))
    if fn == "material_morph_factors":
        mul, _ = pose.material_morph_factors(rig, torch.as_tensor(leaf[0]))
        np.testing.assert_allclose(mul[0].numpy(), [0.75, 1.0, 1.0])


def test_ext_uv_morphs_and_morphed_extra_uvs():
    """Ext-UV morphs on two declared channels (one more dropped at build),
    and `Scene.morphed_extra_uvs` (rest values + offsets) for a pose and a
    crowd's [2, M] rates."""
    pm = two_bone_arm()
    n = len(pm.positions)
    pm.extra_uvs = np.tile(np.asarray([[0.1, 0.2, 0.3, 0.4],
                                       [0.5, 0.6, 0.7, 0.8]], np.float32),
                           (n, 1, 1))
    for ch, verts in ((ref_pmx.MORPH_EXT_UV_1, [1, 2, 1]),
                      (ref_pmx.MORPH_EXT_UV_2, [2]),
                      (ref_pmx.MORPH_EXT_UV_3, [0])):
        pm.morphs.append(ref_pmx.Morph(
            f"X{ch}", "x", 4, ch,
            uv_vertex_indices=np.asarray(verts, np.int32),
            uv_offsets=np.arange(4 * len(verts), dtype=np.float32).reshape(
                -1, 4)))
    static = ref_model.build_model(pm)
    assert static.extra_uvs.shape == (n, 2, 4) and len(static.xum_morph) == 4
    ref = RefScene(static, ref_physics.build_physics(static), None,
                   RefAppConfig())
    port = Scene(convert.model_static(static),
                 convert.physics_static(ref.phys_static), device="cpu")
    rates = np.random.default_rng(2).uniform(
        0, 1, (2, static.n_morphs)).astype(np.float32)
    crowd = port.morphed_extra_uvs(pose.PoseArrays(
        *([None] * 7), leaf_rates=torch.as_tensor(rates)))
    for i in range(2):
        want = np.asarray(ref.morphed_extra_uvs(
            ref_pose.PoseArrays(*([None] * 7),
                                leaf_rates=jnp.asarray(rates[i]))))
        np.testing.assert_array_equal(crowd[i].numpy(), want)
    assert not np.array_equal(crowd[0].numpy(), static.extra_uvs)


def test_sdef_tables_are_gathered_once(content):
    """`ModelTables` holds the SDEF subset (skin type SDEF after
    Model::Normalize) and its gathered tables on its device, and the crowd
    view shares them."""
    static, rig, n_sdef = content
    idx = np.flatnonzero(static.skin_type == ref_pmx.SDEF)
    assert rig.n_sdef == len(idx) == n_sdef > 0
    np.testing.assert_array_equal(rig.sdef_idx.numpy(), idx)
    np.testing.assert_array_equal(rig.sdef_b0.numpy(),
                                  static.skin_bones[idx, 0])
    np.testing.assert_array_equal(rig.sdef_b1.numpy(),
                                  static.skin_bones[idx, 1])
    np.testing.assert_array_equal(rig.sdef_w0.numpy(),
                                  static.skin_weights[idx, 0])
    for name in ("sdef_c", "sdef_r0", "sdef_r1"):
        np.testing.assert_array_equal(getattr(rig, name).numpy(),
                                      getattr(static, name)[idx])
    view = rig.crowd(3)
    assert view.n_sdef == rig.n_sdef and view.sdef_idx is rig.sdef_idx
    plain = _tables(ref_model.build_model(two_bone_arm()))
    assert plain.n_sdef == 1


def _skins(rig, rng, n, max_angle):
    """n poses of random bone rotations (pre-physics posing, capturable)
    -> ([n, B, 4, 4] skin matrices, [n, N, 3] vertex offsets)."""
    skins, offsets = [], []
    for _ in range(n):
        rot = torch.as_tensor(_quats(rng, rig.n_bones, max_angle))
        trans = torch.as_tensor(rng.normal(0, 0.1, (rig.n_bones, 3))
                                .astype(np.float32))
        rates = torch.as_tensor(rng.uniform(0, 1, rig.n_morphs)
                                .astype(np.float32))
        p = pose.pre_physics_posing(rig, rot, trans, rates, capturable=True)
        skins.append(p.skin)
        offsets.append(p.vertex_offsets)
    return torch.stack(skins), torch.stack(offsets)


def _ref_deform(static, skin, offsets, sdef):
    p = ref_pose.PoseArrays(*([None] * 6),
                            vertex_offsets=jnp.asarray(offsets.numpy()),
                            leaf_rates=None)
    p = dataclasses.replace(p, skin=jnp.asarray(skin.numpy()))
    pos, nrm = ref_pose.deform(static, p, sdef=sdef)
    return np.asarray(pos), np.asarray(nrm)


def _port_deform(rig, skin, offsets, sdef):
    p = pose.PoseArrays(*([None] * 6), vertex_offsets=offsets,
                        leaf_rates=None)
    p.skin = skin
    return pose.deform(rig, p, sdef=sdef)


@pytest.mark.parametrize("rig_name,atol", [("arm", (1e-6, 1e-6)),
                                           ("content", (2e-5, 2e-6))])
def test_deform_sdef_matches_reference(content, rig_name, atol):
    """Three random poses, each alone and the three as a crowd of 3 (the
    instance-major view: every instance with its own matrices); the SDEF
    rows move against the matrix-lerp fallback, the others do not."""
    if rig_name == "arm":
        pm = two_bone_arm()
        pm.sdef_r0[3] = [0.8, 0.1, 0.0]
        pm.sdef_r1[3] = [1.2, -0.1, 0.0]
        static = ref_model.build_model(pm)
        rig = _tables(static)
    else:
        static, rig, _ = content
    rng = np.random.default_rng(3)
    skin, offsets = _skins(rig, rng, 3, 1.2)
    idx = rig.sdef_idx.numpy()
    crowd = pose.deform(rig.crowd(3), dataclasses.replace(
        pose.PoseArrays(*([None] * 8)), skin=skin.reshape(-1, 4, 4),
        vertex_offsets=offsets.reshape(-1, 3)), sdef=True)
    for i in range(3):
        want = _ref_deform(static, skin[i], offsets[i], True)
        got = _port_deform(rig, skin[i], offsets[i], True)
        lerp = _port_deform(rig, skin[i], offsets[i], False)
        for k in range(2):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=atol[k])
            np.testing.assert_allclose(crowd[k][i].numpy(), want[k], rtol=0,
                                       atol=atol[k])
        rest = np.setdiff1d(np.arange(rig.n_vertices), idx)
        assert torch.equal(got[0][rest], lerp[0][rest])
        assert float((got[0][idx] - lerp[0][idx]).abs().max()) > 1e-3


def test_capturable_step_with_sdef_reads_nothing_on_the_host(content):
    """The content rig's step with `sdef_true` (the form a CUDA graph holds)
    under the host guard of tests/test_torch_compiled_step.py, single and a
    crowd of 2, and equal to the eager step bit for bit."""
    from simple_mmd_renderer_tpu_torch.core.anim import bind_motion
    from simple_mmd_renderer_tpu_torch.parallel import mesh
    from simple_mmd_renderer_tpu_torch.utils.graph import tree_leaves

    static, _, _ = content
    port_static = convert.model_static(static)
    port = Scene(port_static,
                 convert.physics_static(ref_physics.build_physics(static)),
                 bind_motion(port_static, chip_smoke.content_motion(60, 10)),
                 None, device="cpu")
    port.config.sdef_true = True
    port.config.physics.solver_iterations = 2
    for state in (port.init_state(), mesh.crowd_init(port, 2)):
        if state.time.dim():
            port.rig.crowd(2)
            port.phys.crowd(2, port.rig.n_bones)
        with host_guard():
            got = port.step_pose(state, capturable=True)
        want = port.step_pose(state)
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert torch.equal(a, b)
        lerp = port.rig.crowd(2) if state.time.dim() else port.rig
        assert not torch.equal(got[2], pose.deform(lerp, dataclasses.replace(
            got[1], skin=got[1].skin.reshape(-1, 4, 4),
            vertex_offsets=got[1].vertex_offsets.reshape(-1, 3)))[0]
            .reshape(got[2].shape))
