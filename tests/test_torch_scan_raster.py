"""The exact scan raster (`raster_mode="scan"`): the port against the
reference.

- `render.raster.rasterize` against the reference's `raster.rasterize` on
  random meshes (tests/test_torch_raster.py's `_random_mesh`, 96x64, 200
  triangles and one big one) with each cull mode, `nocull`, a start vis,
  z-ties across draw order and triangles behind the camera, held with
  `_assert_vis_equal` (depth 2e-5, triangle id or barycentric mismatch
  below 1e-3 of the pixels).
- The pixel boxes KS skips triangles by hold every pixel the scan's
  arithmetic could let the triangle pass, on tests/torch_box_meshes.py's
  adversarial sets.
- The scan body's plain version (`ops.tiled_raster.scan_raster_plain`,
  triangles in chunks) bit for bit against the per-triangle loop it
  replaced (`_loop_scan` below, the loop the port ran before, kept here as
  its oracle): [n] and [I, n] setups, a chunk size that does not divide n,
  n = 0 and a start vis.
- `render_frame(raster_mode="scan")` against the reference's at 128x96
  (shadow 128^2): msaa=1, msaa=4 (supersampled: the scan raster has no
  native MSAA), edge outlines, double-sided materials and textures with
  the UVs carried by the raster; the whole-frame tolerance (fewer than
  2e-3 of the pixels off by more than 0.02, mean absolute difference below
  1/255). Measured: no pixel beyond 0.02, mean differences below 1e-6.
- The crowd's per-instance fallback with the scan raster (2 instances of
  tests/test_extended_morphs.py's two-bone arm, 64x48) against the
  reference's vmap(render_frame) fallback, and the Scene's entry points
  (`step_and_render`, `jit_step`, `rollout`, `jit_rollout`) through the
  scan raster; `raster_mode="auto"` stays on the tiled rasters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (the port's tests' thread cap)

from simple_mmd_renderer_tpu.app.sample import (sample_character,
                                                sample_textures)
from simple_mmd_renderer_tpu.config import RenderConfig
from simple_mmd_renderer_tpu.core.model import build_model
from simple_mmd_renderer_tpu.parallel import mesh as ref_par
from simple_mmd_renderer_tpu.render import pipeline as ref_pipeline
from simple_mmd_renderer_tpu.render import raster as ref_raster
from simple_mmd_renderer_tpu_torch import config, convert
from simple_mmd_renderer_tpu_torch.core.model import ModelTables
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.parallel import mesh as par
from simple_mmd_renderer_tpu_torch.render import pipeline, raster

from test_torch_camera_crowd import _arm_scene, _port
from torch_box_meshes import KINDS, screen_setup, screen_triangles
from test_torch_raster import _assert_vis_equal, _random_mesh, _with_big
from test_torch_textured_slice import _assert_frames_close

W, H = 96, 64


def _loop_scan(width, height, s, vis=None):
    """The per-triangle scan loop the port ran before the chunked plain
    version (one step a triangle over the full [H, W] planes), from a
    start vis (None: cleared): the chunked version's oracle."""
    lead = s["xy"].shape[:-3]
    xs = (torch.arange(width, dtype=torch.float32) + 0.5)[None, :]
    ys = (torch.arange(height, dtype=torch.float32) + 0.5)[:, None]
    if vis is None:
        vis = raster.empty_vis(width, height, "cpu", lead)
    depth, tri_id, bary = vis.depth, vis.tri, vis.bary

    def px(t):
        return t[..., None, None]

    for k in range(s["xy"].shape[-3]):
        xy = px(s["xy"][..., k, :, :].movedim(-2, 0).movedim(-1, 1))
        z = px(s["z"][..., k, :].movedim(-1, 0))
        area2, valid = px(s["area2"][..., k]), px(s["valid"][..., k])
        inv_area = torch.where(torch.abs(area2) > 1e-12, 1.0 / area2,
                               torch.zeros_like(area2))

        def edge(a, b):
            return (b[0] - a[0]) * (ys - a[1]) - (b[1] - a[1]) * (xs - a[0])

        b0 = edge(xy[1], xy[2]) * inv_area
        b1 = edge(xy[2], xy[0]) * inv_area
        b2 = edge(xy[0], xy[1]) * inv_area
        cover = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & valid
        zp = b0 * z[0] + b1 * z[1] + b2 * z[2]
        passed = cover & (zp <= depth) & (zp >= 0.0) & (zp <= 1.0)
        depth = torch.where(passed, zp, depth)
        tri_id = torch.where(passed, torch.full_like(tri_id, k), tri_id)
        bary = torch.where(passed[..., None], torch.stack([b1, b2], -1), bary)
    return raster.VisBuffer(depth=depth, tri=tri_id, bary=bary)


def _start_vis(rng, lead=()):
    """A start buffer: random depths in [0.2, 1], a third of the pixels
    holding a made-up triangle id and barycentrics."""
    shape = lead + (H, W)
    held = rng.uniform(size=shape) < 0.33
    return (rng.uniform(0.2, 1.0, shape).astype(np.float32),
            np.where(held, rng.integers(0, 500, shape), -1).astype(np.int32),
            np.where(held[..., None], rng.uniform(size=shape + (2,)),
                     0.0).astype(np.float32))


def _mesh(case):
    """(clip, tris, cull, nocull or None, start vis arrays or None)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    clip, tris = _random_mesh(rng)
    if case != "z_ties":
        clip, tris = _with_big(clip, tris)
    cull = {"front": raster.CULL_FRONT,
            "none": raster.CULL_NONE}.get(case, raster.CULL_BACK)
    nocull = start = None
    if case == "nocull":
        nocull = rng.uniform(size=tris.shape[0]) < 0.5
    elif case == "start_vis":
        start = _start_vis(rng)
    elif case == "z_ties":
        # every triangle at depth 0, where zp = b0*0 + b1*0 + b2*0 is 0 in
        # any order of rounding (at a shared nonzero depth it is not):
        # draw order alone decides
        clip[:, 2] = 0.0
        cull = raster.CULL_NONE
    elif case == "behind_camera":
        # a third of the triangles cross w = 0 or lie behind the camera
        behind = rng.uniform(size=tris.shape[0]) < 0.33
        w = np.where(np.repeat(behind, 3)[:clip.shape[0]],
                     rng.uniform(-1.0, 0.5, clip.shape[0]), 1.0)
        clip = (clip * np.where(w > 0, w, 1.0)[:, None]).astype(np.float32)
        clip[:, 3] = w
    return clip, tris, cull, nocull, start


RASTER_CASES = ["back", "front", "none", "nocull", "start_vis", "z_ties",
                "behind_camera"]


@pytest.mark.parametrize("case", RASTER_CASES)
def test_rasterize_matches_reference(case):
    clip, tris, cull, nocull, start = _mesh(case)
    ref_vis = port_vis = None
    if start is not None:
        ref_vis = ref_raster.VisBuffer(*map(jnp.asarray, start))
        port_vis = raster.VisBuffer(*map(torch.as_tensor, start))
    want = ref_raster.rasterize(
        jnp.asarray(clip), jnp.asarray(tris), W, H, cull, ref_vis,
        None if nocull is None else jnp.asarray(nocull))
    got = raster.rasterize(
        torch.as_tensor(clip), torch.as_tensor(tris), W, H, cull, port_vis,
        None if nocull is None else torch.as_tensor(nocull))
    _assert_vis_equal(got, want)
    drawn = (got.tri.numpy() >= 0).mean()
    assert drawn > 0.1, drawn
    if case == "z_ties":
        # drawn in reverse order, the overlaps go to the other triangle
        rev = raster.rasterize(torch.as_tensor(clip),
                               torch.as_tensor(tris[::-1].copy()), W, H, cull)
        back = np.where(rev.tri.numpy() >= 0,
                        tris.shape[0] - 1 - rev.tri.numpy(), -1)
        assert np.array_equal(back >= 0, got.tri.numpy() >= 0)
        assert (back != got.tri.numpy()).mean() > 0.05
    if case == "start_vis":
        kept = got.tri.numpy() == start[1]
        assert 0.01 < kept.mean() < 0.99


def test_shadow_pass_default_is_the_scan_raster():
    """`shadow_pass` with no raster function (`raster_fn=None`) takes the
    exact scan raster's depth in both packages: the port's equals the
    reference's default at 64^2 (depth 2e-5; measured 4.8e-7), and passing
    `raster.rasterize` gives the same bits."""
    rng = np.random.default_rng(51)
    verts = rng.uniform(-4.0, 4.0, (300, 3)).astype(np.float32)
    verts[:, 1] += 4.0
    tris = rng.integers(0, 300, (100, 3)).astype(np.int32)
    light = np.array(ref_pipeline.build_matrices(RenderConfig())["light_mvp"])
    want = ref_pipeline.shadow_pass(jnp.asarray(verts), jnp.asarray(tris),
                                    jnp.asarray(light), 64)
    args = tuple(map(torch.as_tensor, (verts, tris, light))) + (64,)
    got = pipeline.shadow_pass(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert (got.numpy() < 1.0).mean() > 0.05
    assert torch.equal(pipeline.shadow_pass(*args, raster.rasterize), got)


def _setups():
    """Named scan-body inputs: (setup dict, start vis or None, chunk)."""
    rng = np.random.default_rng(11)
    clip, tris = _with_big(*_random_mesh(rng, t=150))
    single = raster.setup(torch.as_tensor(clip), torch.as_tensor(tris), W, H,
                          raster.CULL_NONE)
    clip2 = np.stack([clip, clip * np.array([1.1, 0.9, 1.0, 1.0],
                                            np.float32)])
    crowd = raster.setup(torch.as_tensor(clip2), torch.as_tensor(tris), W, H,
                         raster.CULL_BACK)
    empty = {k: v[:0] for k, v in single.items()}
    start = raster.VisBuffer(*map(torch.as_tensor, _start_vis(rng)))
    start2 = raster.VisBuffer(*map(torch.as_tensor, _start_vis(rng, (2,))))
    return {"single": (single, None, None), "crowd": (crowd, None, None),
            "ragged_chunk": (single, None, 7),
            "crowd_ragged_chunk": (crowd, start2, 13),
            "empty": (empty, None, None), "empty_start": (empty, start, None),
            "start_vis": (single, start, None)}


@pytest.fixture(scope="module")
def setups():
    return _setups()


@pytest.mark.parametrize("case", ["single", "crowd", "ragged_chunk",
                                  "crowd_ragged_chunk", "empty",
                                  "empty_start", "start_vis"])
def test_chunked_scan_equals_the_loop(setups, case):
    """The chunked plain version gives the per-triangle loop's bits."""
    s, start, chunk = setups[case]
    kept = None if start is None else [t.clone() for t in vars(start).values()]
    want = _loop_scan(W, H, s, start)
    got = tr.scan_raster_plain(W, H, s, start, chunk)
    assert torch.equal(got.depth, want.depth)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.bary, want.bary)
    assert got.depth.shape == s["xy"].shape[:-3] + (H, W)
    assert (got.tri >= 0).any() == (case != "empty")
    if start is not None:       # the start buffer is read, never written
        assert all(torch.equal(a, b)
                   for a, b in zip(kept, vars(start).values()))


@pytest.mark.parametrize("kind", KINDS)
def test_scan_candidates_lie_inside_the_pixel_boxes(kind):
    """KS skips a triangle in every block of pixels its box
    (`_pixel_boxes` at the pixel centre, the margin included) misses. On
    the adversarial sets of tests/torch_box_meshes.py (slivers down to
    the 1e-12 area cut, vertices on pixel centres, sample points and tile
    edges) no pixel where the scan's own arithmetic could let a triangle
    pass (covered, 0 <= zp <= 1) lies outside its box."""
    w, h = 160, 96
    s = screen_setup(*screen_triangles(kind, 5, 300, w, h), 0.0)
    boxes = tr._pixel_boxes(s, 0.0).long()
    xs, ys = raster._pixel_centers(w, h, "cpu")
    ids = torch.arange(300)
    cand = tr._scan_planes(s, ids, tr._inv_area(s["area2"]), xs, ys)[3]
    col = torch.arange(w)[None, None, :]
    row = torch.arange(h)[None, :, None]
    box = boxes[:, :, None, None]
    inside = ((col >= box[:, 0]) & (col <= box[:, 2]) & (row >= box[:, 1])
              & (row <= box[:, 3]))
    assert cand.any()
    assert not (cand & ~inside).any()


FW, FH = 128, 96
_CAM = dict(camera_pos=np.array([0.0, 1.2, -2.6], np.float32),
            camera_target=np.array([0.0, 0.9, 0.0], np.float32))
FRAME_CASES = {"msaa1": {}, "msaa4": dict(msaa=4),
               "edges": dict(show_edges=True, edge_scale=20.0),
               "double_sided": dict(double_sided=True),
               "textured": dict(albedo_window=True)}


@pytest.fixture(scope="module")
def frame_inputs():
    """(reference static with half its triangles double-faced, the
    textures, the rest pose)."""
    static = build_model(sample_character(density=0.5))
    static.nocull_tris[: len(static.nocull_tris) // 2] = True
    return (static, sample_textures((64, 32)),
            np.asarray(static.positions, np.float32),
            np.asarray(static.normals, np.float32))


def _cfg_kw(case):
    return dict(width=FW, height=FH, shadow_map_size=128, show_skybox=False,
                raster_mode="scan", **_CAM, **FRAME_CASES[case])


@pytest.fixture(scope="module")
def ref_frames(frame_inputs):
    """The reference's scan frame of every case, traced into one jitted
    program."""
    static, textures, pos, nrm = frame_inputs

    def frames(p, n):
        return tuple(ref_pipeline.render_frame(
            static, p, n, RenderConfig(**_cfg_kw(case)),
            part_textures=textures if case == "textured" else None)
            for case in FRAME_CASES)
    out = jax.jit(frames)(pos, nrm)
    return {case: np.asarray(f) for case, f in zip(FRAME_CASES, out)}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_render_frame_scan_matches_reference(frame_inputs, ref_frames, case,
                                             monkeypatch):
    static, textures, pos, nrm = frame_inputs
    rig = ModelTables(convert.model_static(static), "cpu")
    calls = []
    scan = tr.scan_raster

    def spy(width, height, s, vis=None):
        calls.append((width, height, s["xy"].shape[0]))
        return scan(width, height, s, vis)
    monkeypatch.setattr(tr, "scan_raster", spy)
    monkeypatch.setattr(tr, "_bin", None)      # no tiled raster runs
    got = pipeline.render_frame(
        rig, torch.as_tensor(pos), torch.as_tensor(nrm),
        config.RenderConfig(**_cfg_kw(case)),
        part_textures=textures if case == "textured" else None)
    _assert_frames_close(got[None].numpy(), ref_frames[case][None], case)
    scale = 2 if case == "msaa4" else 1
    n_tris = static.triangles.shape[0]
    want = [(128, 128, n_tris)]
    if case == "edges":
        want.append((FW * scale, FH * scale, static.edge_tris.shape[0]))
    want.append((FW * scale, FH * scale, n_tris))
    assert calls == want
    # every option moves the frame
    assert case == "msaa1" or (np.abs(got.numpy() - ref_frames["msaa1"])
                               > 0.02).any()


def test_crowd_scan_fallback_matches_reference(capsys):
    """The crowd with the scan raster renders instance by instance, as the
    reference's vmap fallback: 2 frames of a crowd of 2 against it; the
    notice names scan_raster; the fused frame still refuses the scan."""
    ref = _arm_scene(camera=False, light=False)
    ref.config.render = dataclasses.replace(ref.config.render,
                                            raster_mode="scan")
    port = _port(ref)
    assert port.config.render.raster_mode == "scan"
    assert not pipeline.crowd_render_supported(port.config.render)
    step = par.crowd_step_fn(port)
    assert "scan_raster" in capsys.readouterr().err
    ref_state = ref_par.crowd_init(ref, 2)
    state = convert.sim_state_to_torch(ref_state, device="cpu")
    ref_step = jax.jit(ref_par.crowd_step_fn(ref))
    for frame in range(2):
        ref_state, want = ref_step(ref_state)
        state, got = step(state)
        _assert_frames_close(got.numpy(), np.asarray(want), f"frame {frame}")
    assert float((got[0] - got[1]).abs().max()) > 0.1
    with pytest.raises(NotImplementedError, match='raster_mode="scan"'):
        verts = torch.zeros((2, ref.static.positions.shape[0], 3))
        pipeline.crowd_render_frame(port.rig, verts, verts,
                                    port.config.render)


def test_scene_entry_points_render_through_the_scan(monkeypatch):
    """`step_and_render`, `jit_step`, `rollout` and `jit_rollout` of a
    Scene whose config asks for the scan raster render through it (a
    launch of the scan body per raster, no binning), equal to one another
    and to the reference's Scene frame; `raster_mode="auto"` bins."""
    ref = _arm_scene(camera=False, light=False)
    ref.config.render = dataclasses.replace(ref.config.render,
                                            raster_mode="scan")
    port = _port(ref)
    calls = []
    scan, bin_ = tr.scan_raster, tr._bin

    def spy_scan(*a, **kw):
        calls.append("scan")
        return scan(*a, **kw)

    def spy_bin(*a, **kw):
        calls.append("bin")
        return bin_(*a, **kw)
    monkeypatch.setattr(tr, "scan_raster", spy_scan)
    monkeypatch.setattr(tr, "_bin", spy_bin)
    state0 = port.init_state()
    ref_state, want = jax.jit(ref.step_and_render)(ref.init_state())
    state, img = port.step_and_render(state0)
    assert calls == ["scan", "scan"]        # the shadow map, the character
    _assert_frames_close(img[None].numpy(), np.asarray(want)[None], "scene")
    state, img2 = port.step_and_render(state)
    _, got = port.jit_step(donate=False)(state0)
    assert torch.equal(got, img)
    sums = torch.stack([img.mean(), img2.mean()])
    assert torch.equal(port.rollout(state0, 2)[1], sums)
    assert torch.equal(port.jit_rollout(2)(state0)[1], sums)
    assert set(calls) == {"scan"}
    calls.clear()
    port.config.render = dataclasses.replace(port.config.render,
                                             raster_mode="auto")
    port.step_and_render(state0)
    assert calls == ["bin", "bin"], calls
