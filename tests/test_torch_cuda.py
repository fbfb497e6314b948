"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
test, never at import). This file imports no JAX, so it also runs on a
machine without JAX, where tests/conftest.py (which imports JAX) is left
out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

K1, K3, K6 and the depth/tri/b1/b2 (and K4's per-sample depth) of K2 and
K4 must be bit-exact; K2's and K4's attributes within 1e-6 (same
arithmetic, one IEEE division). The crowd kernels K5a, K5b and K5c are
held the same way against their plain versions, give the same bits in two
runs, and fold to K2, K4 and K1 on one instance's own bins. K1, K6, K2,
K4, K5a, K5b and K5c, which evaluate an entry only inside its pixel box
with integer atomics on shared tile state, are also held against the
brute-force plain versions on the adversarial sets of
tests/torch_box_meshes.py (boxes at the pixel centre for
K1/K6/K2/K5a/K5c, over the MSAA samples for K4/K5b), on tiles of only wide
and only small boxes, with shuffled entries, and twice for equal bits;
K6's map must equal K1's on the same bins and boxes, and over 8-row bins
K1's over 32-row bins of the same mesh. K3 runs at sizes whose rows are
and are not a multiple of four columns, on maps at an unaligned base too.
The raster kernels also run at five attributes (the UVs riding the raster
as attributes 3-4), and textured frames (single and crowd) on the card
must match the CPU's within the image tolerance. The content rig of
chip_smoke.py (SDEF vertices, a UV and a material morph) with `sdef_true`
and the extended morphs on: its compiled step replays the eager step's
bits, and its frames on the card match the CPU's. The command-line
renderer's Scene (`app.cli.build_scene`) with VMD camera and light tracks:
its frames (msaa=1 and 4, an orthographic frame, a crowd with the camera
track) match the CPU's, the captured `Scene.seek` equals the eager one bit
for bit, and the tracks' sampling runs under sync debug mode "error".
The scan raster's KS and its bin pass KSb are held bit for bit against
`scan_raster_plain` and `scan_bins_plain` at every coarse tile that
chip_smoke.py sweeps, and KSb + KS captured in a CUDA graph under sync
debug mode "error" replay the eager call's bits. The step's stage clock
(`csrc/stamp.cu`): the stamp kernel captured under sync debug mode
"error", recorded frames' rows surviving later replays, the six stages
summing to within 3 % of the replay timed by CUDA events, and the CCD
counts summed in the graph equal to a recount in the eager capturable
step, the replay's bits the eager step's. The CCD solve (`csrc/ccd.cu`):
its primitives (torch.sum of 3 and 4 terms, vector_norm, linalg.cross, the
4x4 product and the einsum in the order codes found at the batch) equal
torch's at G = 1, 2 and 128, the codes found at every batch from 1 to 2048
reproduce cuBLAS, and each IK group's solve equals the plain loop's bit for
bit (the pose fields and the CCD flags) on the sample rig at 32 seeded
frames, on the 64-instance crowd, and on tests/torch_ik_rigs.py's six
variants (every fix type and Euler order, groups of one and two chains),
on a rig whose chains read each other through append parents, and on
groups of more chains than the kernel's block has threads; the codes of a
new batch are refused inside a capture.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simple_mmd_renderer_tpu_torch.app.sample import sample_character
from simple_mmd_renderer_tpu_torch.core import pose
from simple_mmd_renderer_tpu_torch.core.model import ModelTables, build_model
from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
from simple_mmd_renderer_tpu_torch.render import raster

from torch_box_meshes import (KINDS, boxed_bins, screen_setup,
                              screen_triangles)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bins(device, t, spread, size, w, h, cull, e_max, z=(0.1, 0.9),
          seed=0, n_attrs=3, sample_extent=0.0, tile_h=tr.TILE_H,
          boxes=False, nocull=None):
    """(rows, starts, counts, caster window) of a random mesh; with `boxes`
    (rows, starts, counts, the entries' pixel boxes at `sample_extent`,
    caster window). `nocull` [t] exempts triangles from `cull`."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (t, 2))
    d1 = rng.uniform(-size, size, (t, 2))
    d2 = rng.uniform(-size, size, (t, 2))
    verts = np.stack([v0, v0 + d1, v0 + d2], 1).reshape(-1, 2)
    zs = rng.uniform(*z, (t, 1)).repeat(3, 1).reshape(-1)
    clip = np.concatenate([verts, zs[:, None], np.ones((3 * t, 1))],
                          -1).astype(np.float32)
    clip = torch.as_tensor(clip, device=device)
    tris = torch.arange(3 * t, dtype=torch.int32, device=device).reshape(t, 3)
    attrs = torch.as_tensor(rng.normal(size=(3 * t, n_attrs)).astype(
        np.float32), device=device)
    s = raster.setup(clip, tris, w, h, cull, sample_extent=sample_extent,
                     nocull=None if nocull is None else torch.as_tensor(
                         nocull, device=device))
    s["tris_v"] = tris
    rows = tr._setup_rows(s, torch.arange(t, device=device),
                          attrs if n_attrs else None)
    window = tr._caster_window(s, w, h, tile_h)
    if boxes:
        bins = tr._bin(s, rows, w, h, e_max, t >= tr.COMPACT_MIN_T, tile_h,
                       boxes=tr._pixel_boxes(s, sample_extent))
        return bins[:3] + bins[4:] + (window,)
    bins = tr._bin(s, rows, w, h, e_max, t >= tr.COMPACT_MIN_T, tile_h)[:3]
    return bins + (window,)


CASES = [
    # t, spread, size, w, h, cull, e_max, z
    (300, 0.9, 0.25, 320, 192, raster.CULL_NONE, 9, (0.1, 0.9)),
    (5000, 0.9, 0.05, 640, 360, raster.CULL_BACK, 6, (0.1, 0.9)),
    (2000, 0.05, 0.08, 128, 64, raster.CULL_NONE, 2, (0.5, 0.5)),  # dense
]


@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
def test_depth_kernel_bit_exact(cuda, case):
    t, spread, size, w, h, cull, e_max, z = case
    rows, starts, counts = _bins(cuda, t, spread, size, w, h, cull, e_max,
                                 z)[:3]
    before = tr.depth_launches
    got = tr.depth_tiles(rows, starts, counts, w, h)
    assert tr.depth_launches == before + 1
    want = tr.depth_tiles_plain(rows, starts, counts, w, h)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
@pytest.mark.parametrize("n_attrs", [0, 3])
def test_raster_kernel_bit_exact(cuda, case, n_attrs):
    t, spread, size, w, h, cull, e_max, z = case
    rows, starts, counts = _bins(cuda, t, spread, size, w, h, cull, e_max, z,
                                 n_attrs=n_attrs)[:3]
    got = tr.raster_tiles(rows, starts, counts, w, h, n_attrs)
    want = tr.raster_tiles_plain(rows, starts, counts, w, h, n_attrs)
    for g, p in zip(got[:4], want[:4]):
        assert torch.equal(g, p)
    assert float((got[4] - want[4]).abs().max()) <= 1e-6


PCF_CASES = ([(s, b) for s in (1, 3, 5, 130, 256, 2048) for b in (1, 3)]
             + [(256, 64), (200, 2)])


@pytest.mark.parametrize("per_map", [False, True], ids=["shared", "per_map"])
@pytest.mark.parametrize("s,b", PCF_CASES)
def test_pcf_kernel_bit_exact(cuda, s, b, per_map):
    """K3 against its plain version, bit for bit, one launch each: random
    maps with exact ties zref == depth, zero columns and rows at the edges
    (the edge-clamped taps), and the same maps at a base 4 bytes past a
    16-byte boundary (a view of a larger buffer: the one-column variant,
    as for S not a multiple of 4). The plane is shared (three Python
    floats, the reference's call) or given per map ([b] tensors, its vmap
    over batched planes); per map, each map also equals its own launch
    with its plane as scalars."""
    rng = np.random.default_rng(s + b)
    maps = torch.as_tensor(rng.random((b, s, s), np.float32), device=cuda)
    if per_map:
        k = torch.arange(b, dtype=torch.float32, device=cuda)
        z0, zc, zr = 0.5 - 0.03 * k, 1e-3 * (1.0 + k), -2e-3 + 1e-4 * k
        planes = torch.stack([z0, zc, zr], -1)[:, :, None, None]
    else:
        z0, zc, zr = 0.5, 1e-3, -2e-3
        planes = torch.tensor([z0, zc, zr], dtype=torch.float32,
                              device=cuda)[None, :, None, None]
    # the reference depth in the plain version's order, planted as the
    # depth of a quarter of the texels: ties on their own taps
    col = torch.arange(s, dtype=torch.float32, device=cuda)[None, :]
    row = torch.arange(s, dtype=torch.float32, device=cuda)[:, None]
    zref = (planes[:, 0] + planes[:, 1] * col + planes[:, 2] * row).expand(
        b, s, s)
    tie = torch.as_tensor(rng.random((b, s, s)) < 0.25, device=cuda)
    maps = torch.where(tie, zref, maps)
    maps[:, :, 0] = 0.0
    maps[:, -1, :] = 0.0
    if b > 1:
        maps[1:, 0, :] = 0.0
        maps[1:, :, -1] = 0.0
    want = shadow_pcf.pcf_lit_map_plain(maps, z0, zc, zr)
    if s > 1:      # (a map of one texel is all edge: zero, unlit)
        assert bool((want > 0).any()) and bool((want < 1).any())
    buf = torch.empty(b * s * s + 4, dtype=torch.float32, device=cuda)
    shifted = buf[1:1 + b * s * s].view(b, s, s)
    shifted.copy_(maps)
    assert shifted.data_ptr() % 16 == 4
    for m in (maps, shifted):
        before = shadow_pcf.launches
        got = shadow_pcf.pcf_lit_map(m, z0, zc, zr)
        assert shadow_pcf.launches == before + 1
        assert torch.equal(got, want)
    if per_map:
        for i in range(b):
            one = shadow_pcf.pcf_lit_map_tiled(
                maps[i], float(z0[i]), float(zc[i]), float(zr[i]))
            assert torch.equal(one, want[i])


def test_kernels_on_empty_bins(cuda):
    """A frame with no entry at all (every triangle behind the camera)."""
    rng = np.random.default_rng(3)
    clip = torch.as_tensor(rng.uniform(-1, 1, (30, 4)).astype(np.float32),
                           device=cuda)
    clip[:, 3] = -1.0
    tris = torch.arange(30, dtype=torch.int32, device=cuda).reshape(10, 3)
    s = raster.setup(clip, tris, 256, 128, raster.CULL_NONE)
    rows = tr._setup_rows(s, torch.arange(10, device=cuda))
    rows, starts, counts = tr._bin(s, rows, 256, 128, 8, True)[:3]
    assert int(counts.sum()) == 0
    assert torch.equal(tr.depth_tiles(rows, starts, counts, 256, 128),
                       tr.depth_tiles_plain(rows, starts, counts, 256, 128))
    got = tr.raster_tiles(rows, starts, counts, 256, 128, 0)
    want = tr.raster_tiles_plain(rows, starts, counts, 256, 128, 0)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    got = tr.raster_tiles_ms(rows, starts, counts, 256, 128, 0)
    want = tr.raster_tiles_ms_plain(rows, starts, counts, 256, 128, 0)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    # K5c over two instances of the empty bins, with and without boxes
    starts2, counts2 = torch.cat([starts[:-1], starts]), counts.repeat(2)
    want = tr.depth_tiles_multi_plain(rows, starts2, counts2, 2, 256, 128)
    assert bool((want == 1.0).all())
    boxes = torch.zeros((rows.shape[0], 4), dtype=torch.int16, device=cuda)
    for bx in (boxes, None):
        assert torch.equal(tr.depth_tiles_multi(rows, starts2, counts2, 2,
                                                256, 128, bx), want)
    window = tr._caster_window(s, 256, 128, 32)
    assert window.tolist()[2:] == [0, 0]
    win = tr.depth_tiles_win(rows, starts, counts, window, 256, 128, 32)
    assert bool((win == 1.0).all())


def test_wrappers_reject_bad_inputs(cuda):
    rows, starts, counts, window = _bins(cuda, 50, 0.9, 0.25, 128, 64,
                                         raster.CULL_NONE, 9)
    with pytest.raises(TypeError):
        tr.depth_tiles(rows.double(), starts, counts, 128, 64)
    with pytest.raises(ValueError):
        tr.depth_tiles(rows, starts[:-1], counts, 128, 64)
    with pytest.raises(ValueError):
        tr.raster_tiles(rows[:, :12], starts, counts, 128, 64, 3)
    with pytest.raises(ValueError):
        shadow_pcf.pcf_lit_map(torch.zeros((4, 8), device=cuda), 0.0, 0.0,
                               0.0)
    with pytest.raises(ValueError):
        shadow_pcf.pcf_lit_map(torch.zeros((2, 8, 8), device=cuda),
                               torch.zeros(3, device=cuda), 0.0, 0.0)
    with pytest.raises(ValueError):
        tr.raster_tiles_ms(rows[:, :12], starts, counts, 128, 64, 3)
    with pytest.raises(ValueError):
        tr.depth_tiles_win(rows, starts, counts, window, 128, 64, 16)
    with pytest.raises(TypeError):
        tr.depth_tiles_win(rows, starts, counts, window.long(), 128, 64, 32)


def test_apply_morphs_bitwise_stable(cuda):
    """Vertex-morph entries that share vertices sum in entry order without
    float atomics: two runs on the card give the same bits, and the CPU's."""
    rng = np.random.default_rng(7)
    static = build_model(sample_character(density=0.5))
    e = 400
    static = dataclasses.replace(
        static, vm_vertex=rng.integers(0, 40, e).astype(np.int32),
        vm_morph=rng.integers(0, static.n_morphs, e).astype(np.int32),
        vm_offset=rng.normal(size=(e, 3)).astype(np.float32))
    rates = torch.as_tensor(rng.uniform(0, 1, static.n_morphs).astype(
        np.float32))
    tables = ModelTables(static, cuda)
    first = pose.apply_morphs(tables, rates.to(cuda))[0]
    second = pose.apply_morphs(tables, rates.to(cuda))[0]
    assert torch.equal(first, second)
    want = pose.apply_morphs(ModelTables(static, device="cpu"), rates)[0]
    assert torch.equal(first.cpu(), want)


@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
@pytest.mark.parametrize("n_attrs", [0, 3])
def test_raster_ms_kernel_bit_exact(cuda, case, n_attrs):
    """K4 on bins made with the MSAA sample-point cull (extent 0.375)."""
    t, spread, size, w, h, cull, e_max, z = case
    rows, starts, counts, _ = _bins(cuda, t, spread, size, w, h, cull, e_max,
                                    z, n_attrs=n_attrs, sample_extent=0.375)
    before = tr.raster_ms_launches
    got = tr.raster_tiles_ms(rows, starts, counts, w, h, n_attrs)
    assert tr.raster_ms_launches == before + 1
    want = tr.raster_tiles_ms_plain(rows, starts, counts, w, h, n_attrs)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    assert float((got[4] - want[4]).abs().max()) <= 1e-6
    assert bool((got[1] >= 0).any())


def test_raster_ms_kernel_edge_ties_the_clear(cuda):
    """Entries at zp = 1 that cover samples but not the centre carry the
    biased depth 3.0, equal to the clear: they win it on the id rule."""
    case = (300, 0.9, 0.25, 320, 192, raster.CULL_NONE, 9, (1.0, 1.0))
    rows, starts, counts, _ = _bins(cuda, *case, n_attrs=3,
                                    sample_extent=0.375)
    got = tr.raster_tiles_ms(rows, starts, counts, 320, 192, 3)
    want = tr.raster_tiles_ms_plain(rows, starts, counts, 320, 192, 3)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
@pytest.mark.parametrize("tile_h", [8, 32])
def test_depth_win_kernel_bit_exact(cuda, case, tile_h):
    """K6 against its plain version on the casters' window; on the 32-row
    grid the pasted map also equals K1's over the same bins."""
    t, spread, size, w, h, cull, e_max, z = case
    rows, starts, counts, window = _bins(cuda, t, spread, size, w, h, cull,
                                         e_max, z, n_attrs=0, tile_h=tile_h)
    before = tr.depth_win_launches
    got = tr.depth_tiles_win(rows, starts, counts, window, w, h, tile_h)
    assert tr.depth_win_launches == before + 1
    want = tr.depth_tiles_win_plain(rows, starts, counts, window, w, h,
                                    tile_h)
    assert torch.equal(got, want)
    assert bool((got < 1.0).any())
    if tile_h == 32:
        assert torch.equal(got, tr.depth_tiles(rows, starts, counts, w, h))


@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
def test_depth_kernels_with_boxes_bit_exact(cuda, case):
    """K1 and K6 with the centre boxes the shadow pass bins: equal to the
    brute-force plain versions (the dense case: more entries in a tile than
    a block takes at once, every overlap a z-tie) and to themselves without
    boxes (None: every entry over its whole tile); K6 over the casters'
    window of 32-row bins equal to K1 on the same bins and boxes, and over
    8-row bins equal to K1 over 32-row bins of the same mesh (e_max covers
    either grid, so no triangle is left to the big-triangle merge)."""
    t, spread, size, w, h, cull, _, z = case
    e_max = tr._grid(w, h, 8)[2]
    rows, starts, counts, boxes, window = _bins(
        cuda, t, spread, size, w, h, cull, e_max, z, n_attrs=0, boxes=True)
    before = (tr.depth_launches, tr.depth_win_launches)
    k1 = tr.depth_tiles(rows, starts, counts, w, h, boxes)
    k6 = tr.depth_tiles_win(rows, starts, counts, window, w, h, 32, boxes)
    assert (tr.depth_launches, tr.depth_win_launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert torch.equal(k1, tr.depth_tiles_plain(rows, starts, counts, w, h))
    assert torch.equal(k6, tr.depth_tiles_win_plain(rows, starts, counts,
                                                    window, w, h, 32))
    assert torch.equal(k1, tr.depth_tiles(rows, starts, counts, w, h))
    assert torch.equal(k6, tr.depth_tiles_win(rows, starts, counts, window,
                                              w, h, 32))
    assert torch.equal(k6, k1)
    assert bool((k1 < 1.0).any())
    if spread < 0.1:      # the dense case: tiles beyond a block's chunk
        assert int(counts.max()) > 1024
    rows, starts, counts, boxes, window = _bins(
        cuda, t, spread, size, w, h, cull, e_max, z, n_attrs=0, tile_h=8,
        boxes=True)
    k6 = tr.depth_tiles_win(rows, starts, counts, window, w, h, 8, boxes)
    assert torch.equal(k6, tr.depth_tiles_win_plain(rows, starts, counts,
                                                    window, w, h, 8))
    assert torch.equal(k6, tr.depth_tiles_win(rows, starts, counts, window,
                                              w, h, 8))
    assert torch.equal(k6[:h, :w], k1[:h, :w])


def test_default_device_is_cuda(cuda):
    """The entry points run on the card unless asked for the CPU."""
    scene = build_sample_scene(0.25, 64, 48, 64, n_frames=30, fps_keys=10,
                               solver_iterations=2)
    assert scene.device.type == "cuda"
    assert scene.phys.device.type == "cuda"
    assert scene.motion.b_key.device.type == "cuda"
    static = build_model(sample_character(density=0.25))
    assert ModelTables(static).device.type == "cuda"
    state, image = scene.step_and_render(scene.init_state())
    assert image.device.type == "cuda"


def _crowd_bins(device, n_inst, t, spread, size, w, h, z, sample_extent=0.0,
                seed=5, n_attrs=3, cull=raster.CULL_NONE, nocull=None):
    """Bins of n_inst random meshes over one topology (crowd binning) ->
    (rows, starts, counts, the entries' pixel boxes at `sample_extent`);
    the last instance lies behind the camera and bins nothing. `nocull`
    [t] exempts triangles from `cull`."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_inst, t, 2))
    d1 = rng.uniform(-size, size, (n_inst, t, 2))
    d2 = rng.uniform(-size, size, (n_inst, t, 2))
    verts = np.stack([v0, v0 + d1, v0 + d2], 2).reshape(n_inst, -1, 2)
    zs = rng.uniform(*z, (n_inst, t, 1)).repeat(3, 2).reshape(n_inst, -1, 1)
    clip = np.concatenate([verts, zs, np.ones_like(zs)], -1).astype(
        np.float32)
    clip[-1, :, 3] = -1.0
    clip = torch.as_tensor(clip, device=device)
    tris = torch.arange(3 * t, dtype=torch.int32, device=device).reshape(t, 3)
    attrs = torch.as_tensor(rng.normal(size=(n_inst, 3 * t, n_attrs)).astype(
        np.float32), device=device)
    s, rows = tr._crowd_setup(
        clip, tris, attrs if n_attrs else None, w, h, cull, None, None,
        None if nocull is None else torch.as_tensor(nocull, device=device),
        sample_extent)
    bins = tr._bin_crowd(s, rows, w, h, tr._pixel_boxes(s, sample_extent))
    return bins[:3] + bins[4:]


CROWD_CASES = [
    # n_inst, t, spread, size, w, h, z
    (5, 300, 0.9, 0.25, 256, 144, (0.1, 0.9)),
    (3, 2000, 0.05, 0.08, 128, 64, (0.5, 0.5)),   # dense: every overlap a tie
]


@pytest.mark.parametrize("case", CROWD_CASES, ids=["random", "dense"])
def test_crowd_kernels_bit_exact_and_fold(cuda, case):
    """K5a, K5b, K5c against their plain versions (the dense case: several
    chunks of entries per tile, every overlap a z-tie), the same bits in
    two runs, and instance i's planes equal to K2's, K4's and K1's on that
    instance's own bins. K5c with the boxes of `_bin_crowd` (at the
    centre, and at the MSAA extent: wider, still safe) against the plain
    version with and without them and against itself without them, and
    instance i's map equal to K1's on its bins with the same boxes."""
    n_inst, t, spread, size, w, h, z = case
    n_tiles = tr._grid(w, h)[2]
    for ms in (False, True):
        rows, starts, counts, boxes = _crowd_bins(cuda, n_inst, t, spread,
                                                  size, w, h, z,
                                                  0.375 if ms else 0.0)
        if t >= 2000:
            assert int(counts.max()) > 256
        assert int(counts[-n_tiles:].sum()) == 0
        multi = tr.raster_tiles_ms_multi if ms else tr.raster_tiles_multi
        plain = (tr.raster_tiles_ms_multi_plain if ms
                 else tr.raster_tiles_multi_plain)
        single = tr.raster_tiles_ms if ms else tr.raster_tiles
        counter = "raster_ms_multi_launches" if ms else \
            "raster_multi_launches"
        before = getattr(tr, counter)
        got = multi(rows, starts, counts, n_inst, w, h, 3)
        assert getattr(tr, counter) == before + 1
        again = multi(rows, starts, counts, n_inst, w, h, 3)
        want = plain(rows, starts, counts, n_inst, w, h, 3)
        exact = (0, 1, 2, 3, 5) if ms else (0, 1, 2, 3)
        for k in exact:
            assert torch.equal(got[k], want[k]), (ms, k)
        assert float((got[4] - want[4]).abs().max()) <= 1e-6
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        assert bool((got[1][0] >= 0).any()) and bool((got[1][-1] < 0).all())

        before = tr.depth_multi_launches
        depth = tr.depth_tiles_multi(rows, starts, counts, n_inst, w, h,
                                     boxes)
        assert tr.depth_multi_launches == before + 1
        want = tr.depth_tiles_multi_plain(rows, starts, counts, n_inst, w, h)
        assert torch.equal(depth, want)
        assert torch.equal(want, tr.depth_tiles_multi_plain(
            rows, starts, counts, n_inst, w, h, boxes=boxes))
        assert torch.equal(depth, tr.depth_tiles_multi(rows, starts, counts,
                                                       n_inst, w, h, boxes))
        assert torch.equal(depth, tr.depth_tiles_multi(rows, starts, counts,
                                                       n_inst, w, h))
        assert bool((depth[0] < 1.0).any()) and bool((depth[-1] == 1.0).all())
        for i in range(n_inst):
            sl = slice(i * n_tiles, (i + 1) * n_tiles)
            st_i = torch.cat([starts[sl], starts[sl][-1:] + counts[sl][-1:]])
            one = single(rows, st_i, counts[sl].contiguous(), w, h, 3)
            for a, b in zip(got, one):
                assert torch.equal(a[i], b), (ms, i)
            assert torch.equal(depth[i], tr.depth_tiles(
                rows, st_i, counts[sl].contiguous(), w, h, boxes))


def test_crowd_wrappers_reject_bad_inputs(cuda):
    rows, starts, counts = _crowd_bins(cuda, 2, 50, 0.9, 0.25, 128, 64,
                                       (0.1, 0.9))[:3]
    with pytest.raises(ValueError):      # bins of 2 instances, asked for 3
        tr.depth_tiles_multi(rows, starts, counts, 3, 128, 64)
    with pytest.raises(ValueError):
        tr.raster_tiles_multi(rows[:, :12], starts, counts, 2, 128, 64, 3)
    with pytest.raises(TypeError):
        tr.raster_tiles_ms_multi(rows, starts.long(), counts, 2, 128, 64, 3)


def test_crowd_step_runs_on_the_card_and_matches_the_cpu(cuda):
    """A crowd of 3 through `parallel.mesh` on the card: the crowd kernels
    launch once a frame each, the frames match the CPU's (plain versions)
    within the image tolerance, and the bodies within the posing
    tolerance (2e-2: the card's and the CPU's `acos` may differ in the last
    bit, which the CCD steps amplify, PARITY D1)."""
    from simple_mmd_renderer_tpu_torch.parallel import mesh

    out = {}
    for dev in ("cuda", "cpu"):
        scene = build_sample_scene(0.25, 128, 64, 64, dev, n_frames=60,
                                   fps_keys=10, solver_iterations=4, msaa=4)
        state = mesh.crowd_init(scene, 3)
        before = (tr.depth_multi_launches, tr.raster_ms_multi_launches,
                  shadow_pcf.launches)
        step = mesh.crowd_step_fn(scene)
        for _ in range(2):
            state, images = step(state)
        after = (tr.depth_multi_launches, tr.raster_ms_multi_launches,
                 shadow_pcf.launches)
        grew = 2 if dev == "cuda" else 0
        assert [a - b for a, b in zip(after, before)] == [grew] * 3
        out[dev] = (images.cpu().numpy(), state.physics.pos.cpu().numpy())
    d = np.abs(out["cuda"][0] - out["cpu"][0])
    assert (d > 0.02).mean() < 2e-3 and d.mean() < 1 / 255
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=2e-2)


def _assert_ms_equal(got, want):
    """Bit-exact planes (all but the attributes: depth, tri, b1, b2 and,
    for K4/K5b, sdepth; the depth kernels' maps), attributes within 1e-6."""
    for i in range(len(got)):
        if i != 4:
            assert torch.equal(got[i], want[i]), i
    if len(got) > 4:
        assert float((got[4] - want[4]).abs().max()) <= 1e-6


def _whole_window(w, h, tile_h):
    """K6's window over every tile of the grid."""
    tiles_x, tiles_y, _ = tr._grid(w, h, tile_h)
    return torch.tensor([0, 0, tiles_y, tiles_x], dtype=torch.int32,
                        device="cuda")


def _depth_pair(rows, starts, counts, w, h, n_attrs, boxes=None):
    """K1 and K6 (over the whole window) on the same 32-row bins."""
    del n_attrs
    return (tr.depth_tiles(rows, starts, counts, w, h, boxes),
            tr.depth_tiles_win(rows, starts, counts, _whole_window(w, h, 32),
                               w, h, 32, boxes))


def _depth_pair_plain(rows, starts, counts, w, h, n_attrs):
    want = tr.depth_tiles_plain(rows, starts, counts, w, h)
    return want, want


def _k5c(rows, starts, counts, n_inst, w, h, n_attrs, boxes=None):
    """K5c as the crowd rasters are called (n_attrs unused)."""
    del n_attrs
    return (tr.depth_tiles_multi(rows, starts, counts, n_inst, w, h, boxes),)


def _k5c_plain(rows, starts, counts, n_inst, w, h, n_attrs):
    del n_attrs
    return (tr.depth_tiles_multi_plain(rows, starts, counts, n_inst, w, h),)


def _k6_tile8(rows, starts, counts, w, h, n_attrs, boxes=None):
    del n_attrs
    return (tr.depth_tiles_win(rows, starts, counts, _whole_window(w, h, 8),
                               w, h, 8, boxes),)


def _k6_tile8_plain(rows, starts, counts, w, h, n_attrs):
    del n_attrs
    return (tr.depth_tiles_win_plain(rows, starts, counts,
                                     _whole_window(w, h, 8), w, h, 8),)


# the kernels that cull by pixel boxes: (boxes' sample extent, single
# wrapper, its plain version, crowd wrapper, its plain version, the single
# wrapper's launch counter, tile height of the bins). The depth kernels
# take (rows, starts, counts, w, h, n_attrs, boxes) too, n_attrs unused,
# and give a tuple of maps: "depth" K1 and K6 on 32-row bins (the plain
# version's map twice) and the crowd's K5c, "depth8" K6 on 8-row bins.
BOXED = {
    True: (tr.MSAA4_EXTENT, tr.raster_tiles_ms, tr.raster_tiles_ms_plain,
           tr.raster_tiles_ms_multi, tr.raster_tiles_ms_multi_plain,
           "raster_ms_launches", tr.TILE_H),
    False: (0.0, tr.raster_tiles, tr.raster_tiles_plain,
            tr.raster_tiles_multi, tr.raster_tiles_multi_plain,
            "raster_launches", tr.TILE_H),
    "depth": (0.0, _depth_pair, _depth_pair_plain, _k5c, _k5c_plain,
              "depth_launches", tr.TILE_H),
    "depth8": (0.0, _k6_tile8, _k6_tile8_plain, None, None,
               "depth_win_launches", 8),
}
DEPTH_KERNELS = ("depth", "depth8")


def _covered(planes, ms):
    """Some pixel covered: a sample depth below 1 (K4), a triangle (K2), a
    depth below 1 (K1, K6, K5c)."""
    if ms in DEPTH_KERNELS:
        return bool((planes[0] < 1.0).any())
    return bool((planes[5] < 1.0).any() if ms else (planes[1] >= 0).any())


def _by_kernel(ids, depth=DEPTH_KERNELS):
    """pytest params of (kernel, id): K4/K5b under their ids, K2/K5a under
    "centre-" + id; then the depth kernels of `depth`: "depth" (K1 and K6
    on 32-row bins; the crowd's K5c) under "depth-" + id, "depth8" (K6 on
    8-row bins) under "depth8-" + id."""
    return ([pytest.param(True, i, id=i) for i in ids]
            + [pytest.param(False, i, id="centre-" + i) for i in ids]
            + [pytest.param(k, i, id=f"{k}-{i}") for k in depth
               for i in ids])


@pytest.mark.parametrize("ms,kind", _by_kernel(KINDS))
def test_raster_ms_kernel_adversarial_boxes(cuda, ms, kind):
    """K4 (and K2, K1, K6) with the entries' pixel boxes against the
    brute-force plain version (which takes none), entries shuffled within
    their tiles; the integer atomics are order-free, so a second run gives
    the same bits."""
    extent, fn, plain, _, _, counter, tile_h = BOXED[ms]
    w, h = 320, 192
    rows, starts, counts, boxes = boxed_bins(kind, 11, 600, w, h, n_attrs=3,
                                             device=cuda,
                                             sample_extent=extent,
                                             tile_h=tile_h)
    before = getattr(tr, counter)
    got = fn(rows, starts, counts, w, h, 3, boxes)
    assert getattr(tr, counter) == before + 1
    want = plain(rows, starts, counts, w, h, 3)
    _assert_ms_equal(got, want)
    again = fn(rows, starts, counts, w, h, 3, boxes)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert _covered(got, ms)


@pytest.mark.parametrize("ms,kind", _by_kernel(KINDS, depth=("depth",)))
def test_raster_ms_multi_kernel_adversarial_boxes(cuda, ms, kind):
    """K5b (and K5a, K5c) the same way, over a crowd of three sets."""
    extent, _, _, fn, plain = BOXED[ms][:5]
    w, h, n_inst = 256, 144, 3
    rows, starts, counts, boxes = boxed_bins(kind, 23, 400, w, h, n_attrs=3,
                                             n_inst=n_inst, device=cuda,
                                             sample_extent=extent)
    got = fn(rows, starts, counts, n_inst, w, h, 3, boxes)
    want = plain(rows, starts, counts, n_inst, w, h, 3)
    _assert_ms_equal(got, want)
    again = fn(rows, starts, counts, n_inst, w, h, 3, boxes)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert all(_covered([p[i] for p in got], ms) for i in range(n_inst))


def test_raster_kernel_edge_ties_the_clear(cuda):
    """K2 with its boxes and without: entries at exactly zp = 1 equal the
    clear's depth 1.0 and win it on the id rule (depth 1, their id), as in
    the plain version."""
    case = (300, 0.9, 0.25, 320, 192, raster.CULL_NONE, 9, (1.0, 1.0))
    rows, starts, counts, boxes, _ = _bins(cuda, *case, n_attrs=3,
                                           boxes=True)
    want = tr.raster_tiles_plain(rows, starts, counts, 320, 192, 3)
    won = want[1] >= 0
    assert bool(won.any()) and bool((want[0][won] == 1.0).all())
    for bx in (boxes, None):
        _assert_ms_equal(tr.raster_tiles(rows, starts, counts, 320, 192, 3,
                                         bx), want)


def _wide_only_and_small_only_tiles(cuda, ms):
    """A 256x32 frame of two tiles, each with more entries than one chunk
    of the kernel (1,024; the depth kernels' 256, so that a tile's entries
    spread over six blocks of its cluster): the left one holds only
    boxes wider than WIDE_BOX (the warps share them), the right one only
    small ones (a thread each), all at one depth, so that every overlap is
    a tie on the id rule. K4's boxes over the MSAA samples, K2's, K1's and
    K6's at the pixel centre."""
    extent, fn, plain = BOXED[ms][:3]
    rng = np.random.default_rng(17)
    n = 1400
    corners = np.array([[-12.0, -7.0], [12.0, -7.0], [0.0, 8.0]])
    big = (rng.uniform([20, 4], [100, 28], (n, 1, 2)) + corners
           + rng.uniform(-3, 3, (n, 3, 2)))
    # (at the centre, triangles of 1.5 pixels a side: most of those of 0.7
    # hold no pixel centre and are culled)
    jitter = 0.7 if extent else 1.5
    small = (rng.uniform([130, 1], [254, 31], (n, 1, 2))
             + rng.uniform(-jitter, jitter, (n, 3, 2)))
    xy = np.concatenate([big, small]).astype(np.float32)
    s = {k: v.to(cuda) for k, v in screen_setup(
        xy, np.full((2 * n, 3), 0.5, np.float32), extent).items()}
    rows = tr._setup_rows(s, torch.arange(2 * n, device=cuda))
    rows, starts, counts, _, boxes = tr._bin(
        s, rows, 256, 32, 2, False, boxes=tr._pixel_boxes(s, extent))
    assert int(counts.min()) > 1024
    idx, tile = tr._tile_entries(starts, counts)
    b = boxes[idx].long()
    x0 = tile * tr.TILE_W
    area = ((torch.minimum(b[:, 2], x0 + 127) - torch.maximum(b[:, 0], x0)
             + 1).clamp(min=0)
            * (b[:, 3].clamp(max=31) - b[:, 1].clamp(min=0) + 1).clamp(min=0))
    valid = rows[idx, 9] > 0
    assert bool((area[(tile == 0) & valid] > tr.WIDE_BOX).all())
    assert bool((area[(tile == 1) & valid] <= tr.WIDE_BOX).all())
    want = plain(rows, starts, counts, 256, 32, 0)
    _assert_ms_equal(fn(rows, starts, counts, 256, 32, 0, boxes), want)
    # and with no boxes at all: every entry wide, over its whole tile
    _assert_ms_equal(fn(rows, starts, counts, 256, 32, 0), want)
    cover = want[0] < 1.0 if ms in DEPTH_KERNELS else want[1] >= 0
    assert bool(cover[:, :128].any()) and bool(cover[:, 128:].any())


def test_raster_ms_kernel_wide_only_and_small_only_tiles(cuda):
    _wide_only_and_small_only_tiles(cuda, True)


def test_raster_kernel_wide_only_and_small_only_tiles(cuda):
    _wide_only_and_small_only_tiles(cuda, False)


def test_depth_kernels_wide_only_and_small_only_tiles(cuda):
    """K1 and K6 on the 32-row tiles above."""
    _wide_only_and_small_only_tiles(cuda, "depth")


def _reject_bad_boxes(cuda, ms):
    extent, fn, _, multi = BOXED[ms][:4]
    rows, starts, counts, boxes = boxed_bins("random", 1, 50, 128, 64,
                                             device=cuda,
                                             sample_extent=extent,
                                             tile_h=BOXED[ms][6])
    with pytest.raises(TypeError):
        fn(rows, starts, counts, 128, 64, 0, boxes.int())
    with pytest.raises(TypeError):
        fn(rows, starts, counts, 128, 64, 0, boxes[:-1])
    with pytest.raises(ValueError):
        fn(rows, starts, counts, 128, 64, 0, boxes.cpu())
    with pytest.raises(ValueError):       # rows not a multiple of 4 lanes
        fn(rows[:, :13], starts, counts, 128, 64, 0, boxes)
    if multi is None:
        return
    with pytest.raises(TypeError):        # the crowd form: one instance
        multi(rows, starts, counts, 1, 128, 64, 0, boxes[:-1])
    with pytest.raises(ValueError):
        multi(rows[:, :13], starts, counts, 1, 128, 64, 0, boxes)


def test_raster_ms_wrappers_reject_bad_boxes(cuda):
    _reject_bad_boxes(cuda, True)


def test_raster_wrappers_reject_bad_boxes(cuda):
    _reject_bad_boxes(cuda, False)


@pytest.mark.parametrize("kernel", DEPTH_KERNELS)
def test_depth_wrappers_reject_bad_boxes(cuda, kernel):
    _reject_bad_boxes(cuda, kernel)


# ---------------------------------------------------------------------------
# The compiled frame step: one CUDA-graph replay of pose + physics + deform
# ---------------------------------------------------------------------------

COMPILED_FRAMES = 8


def _compiled_scene(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from simple_mmd_renderer_tpu_torch.parallel import mesh

    if kind == "flagship":      # density 2.0, 1920x1080, 2048^2, msaa=1
        scene = build_sample_scene()
        return scene, scene.init_state()
    scene = build_sample_scene(2.0, 256, 144, 256, n_frames=120, fps_keys=5)
    return scene, mesh.crowd_init(scene, 64)


@pytest.mark.parametrize("kind", ["flagship", "crowd"])
def test_compiled_step_replays_equal_eager_steps(kind):
    """Capture and 8 replays under torch.cuda.set_sync_debug_mode("error")
    give the eager step's bits, frame by frame: every state leaf, pose
    field, position and normal; the flagship and the 64-instance crowd of
    the flagship character."""
    from simple_mmd_renderer_tpu_torch.utils.graph import (sync_errors,
                                                           tree_leaves)

    scene, state = _compiled_scene(kind)
    eager, s = [], state
    for _ in range(COMPILED_FRAMES):
        eager.append(scene.step_pose(s))
        s = eager[-1][0]
    step = scene.jit_step(render=False)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    with sync_errors():
        s = state
        for want in eager:
            got = step(s)
            for a, b in zip(tree_leaves(got), tree_leaves(want),
                            strict=True):
                bad += (a != b).sum()
            s = got[0]
    assert int(bad) == 0
    assert len(scene._graphs) == 1


def test_compiled_rollout_checksums_equal_the_eager_loop():
    """`rollout(render=True)` (replays, each followed by the eager render)
    gives the eager frames' checksums bit for bit."""
    scene, state = _compiled_scene("flagship")
    s, sums = state, []
    for _ in range(3):
        s, image = scene.step_and_render(s)
        sums.append(image.mean())
    final, got = scene.rollout(state, 3)
    assert torch.equal(got, torch.stack(sums))
    assert torch.equal(final.physics.pos, s.physics.pos)


def test_moving_a_scene_drops_its_graphs(cuda):
    from simple_mmd_renderer_tpu_torch.utils.graph import tree_leaves, tree_map

    scene = build_sample_scene(0.25, 64, 48, 64, n_frames=30, fps_keys=10,
                               solver_iterations=2)
    state = scene.init_state()
    first = scene.jit_step(render=False, donate=False)(state)
    assert scene._graphs
    scene.to("cpu")
    assert not scene._graphs
    on_cpu = scene.jit_step(render=False)(tree_map(torch.Tensor.cpu, state))
    assert on_cpu[2].device.type == "cpu"
    scene.to("cuda")
    assert not scene._graphs
    again = scene.jit_step(render=False, donate=False)(state)
    for a, b in zip(tree_leaves(first), tree_leaves(again)):
        assert torch.equal(a, b)


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that reads the host while it is being captured makes the
    capture raise; nothing runs it eagerly instead, and no graph is kept."""
    from simple_mmd_renderer_tpu_torch.core import physics as phys_mod

    scene = build_sample_scene(0.25, 64, 48, 64, n_frames=30, fps_keys=10,
                               solver_iterations=2)
    state = scene.init_state()
    react, calls = phys_mod.physics_react, []

    def reads_the_host(static, ps, st, *args):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            float(st.pos.sum())
        return react(static, ps, st, *args)

    monkeypatch.setattr(phys_mod, "physics_react", reads_the_host)
    with pytest.raises(RuntimeError):
        scene.jit_step(render=False)(state)
    assert calls == [False, True]       # the warm-up, then the capture
    assert not scene._graphs
    monkeypatch.undo()
    got = scene.jit_step(render=False)(state)
    want = scene.step_pose(state)
    assert torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# The step's stage clock (utils/profiling.StepClock, csrc/stamp.cu)
# ---------------------------------------------------------------------------

def _clock_scene():
    return build_sample_scene(0.5, 64, 48, 64, n_frames=30, fps_keys=10)


def test_stamp_kernel_captures_under_sync_errors(cuda):
    """The stamp kernel captured alone in a CUDA graph under sync debug
    mode "error": each replay writes its own row (the clock rising), counts
    the flags and advances the device counter."""
    from simple_mmd_renderer_tpu_torch.utils import profiling
    from simple_mmd_renderer_tpu_torch.utils.graph import sync_errors

    clock = profiling.StepClock(cuda)
    flags = torch.tensor([1, 0, 1, 1, 0] * 300, dtype=torch.bool,
                         device=cuda)
    col = 2                         # a CCD pair's columns: 2 and 3
    work = torch.zeros(1 << 20, device=cuda)
    clock._stamp(1, flags, col)     # the module loads outside the capture;
    torch.cuda.synchronize()        # before a replay's start, no row
    assert int(clock.ring.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with sync_errors(), torch.cuda.graph(graph):
        clock._stamp(0, advance=True)
        work.add_(1.0)
        clock._stamp(1, flags, col)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    rows = clock.ring.cpu()
    assert int(clock.count) == 3
    for r in range(3):
        assert 0 < rows[r, 0] <= rows[r, 1]
        assert rows[r, col] == 1500 and rows[r, col + 1] == 900
    assert rows[0, 1] <= rows[1, 0] and rows[1, 1] <= rows[2, 0]
    assert int(rows[3:].abs().sum()) == 0


def test_ring_ordinals_survive_replays_after_recording(cuda):
    """Frames recorded under the profiler keep their replays' rows: later
    replays change nothing that `recorded()` reads. Each frame carries the
    six device stage spans, in order, and the CCD counts; the replay made
    before the session is the one untraced replay."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.utils import profiling

    scene = _clock_scene()
    step = scene.jit_step(render=False)
    state = step(scene.init_state())[0]         # captured, not recorded
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            state = step(state)[0]
    first = profiling.recorded()
    for _ in range(5):
        state = step(state)[0]
    assert profiling.recorded() == first
    assert [f.ordinal for f in first] == [0, 1, 2]
    for f in first:
        dev = [s for s in f.spans if s.device]
        assert [s.name for s in dev] == list(profiling.STAGES)
        assert all(a.end == b.start for a, b in zip(dev, dev[1:]))
        assert all(s.end >= s.start > 0 for s in dev)
        assert set(f.ccd_iterations) == set(profiling.CCD_PASSES)
        assert f.ccd_iterations["pre_physics"][0] > 0
    assert scene.captured_step(state).clock.replays == 1 + 3 + 5
    # the one replay before the session, at the card's own pace
    (before,) = profiling.untraced_replays(64)
    assert [s.name for s in before] == list(profiling.STAGES)
    assert before[-1].end <= min(s.start for s in first[0].spans
                                 if s.device)
    assert all(s.end >= s.start > 0 and s.frame == -1 for s in before)
    profiling.reset()


def test_stages_sum_to_the_replay_duration(cuda):
    """The six stages of a replay (start stamp to the write-back's end)
    against the replay timed by CUDA events around `graph.replay()`:
    within 3 %."""
    from simple_mmd_renderer_tpu_torch.utils import profiling

    scene = _clock_scene()
    state = scene.init_state()
    step = scene.captured_step(state)
    step.load(state)
    for _ in range(2):          # the graph's upload rides its first launch
        step.replay()
    events = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        first = step.clock.replays
        a.record()
        step.replay()
        b.record()
        events.append((first, a, b))
    torch.cuda.synchronize()
    rows = step.clock.ring.cpu()
    assert [n for n, _ in step.clock.stages] == list(profiling.STAGES)
    end = step.clock.stages[-1][1]
    for ordinal, a, b in events:
        row = rows[ordinal]
        stages_ms = float(row[end] - row[0]) / 1e6
        replay_ms = a.elapsed_time(b)
        assert abs(stages_ms - replay_ms) <= 0.03 * replay_ms, (
            stages_ms, replay_ms)


def test_ccd_counter_on_the_card_equals_the_recount(cuda, monkeypatch):
    """The CCD counts summed inside the graph (the flags of the CUDA
    solve, `csrc/ccd.cu`) equal a recount of the plain masked loop's active
    chains in the capturable step run eagerly on the card from the same
    state; the replay's bits are the eager step's."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.utils import profiling
    from simple_mmd_renderer_tpu_torch.utils.graph import tree_leaves

    scene = _clock_scene()
    state = scene.init_state()
    for _ in range(2):
        state = scene.step_pose(state)[0]
    counts = []
    still = pose._still_active

    def recount(done, out=None):
        counts.append((done.numel(), int((~done).sum())))
        return still(done, out)

    monkeypatch.setattr(pose, "_still_active", recount)
    monkeypatch.setattr(pose, "_solve_ik_group", pose.solve_ik_group_plain)
    scene.step_pose(state, capturable=True)
    monkeypatch.undo()
    want = scene.step_pose(state)
    step = scene.jit_step(render=False, donate=False)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = step(state)
    (frame,) = profiling.recorded()
    profiling.reset()
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(a, b)
    runs = sum(r for r, _ in frame.ccd_iterations.values())
    useful = sum(u for _, u in frame.ccd_iterations.values())
    assert (runs, useful) == (sum(n for n, _ in counts),
                              sum(u for _, u in counts))


# ---------------------------------------------------------------------------
# Textures: the raster kernels at A = 5 (the UVs as attributes 3-4) and
# textured frames on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
@pytest.mark.parametrize("ms", [False, True], ids=["K2", "K4"])
def test_raster_kernels_bit_exact_at_five_attributes(cuda, case, ms):
    """K2 and K4 with five attributes: the vector path's second group of
    four is a partial one."""
    t, spread, size, w, h, cull, e_max, z = case
    rows, starts, counts, _ = _bins(cuda, t, spread, size, w, h, cull, e_max,
                                    z, n_attrs=5,
                                    sample_extent=0.375 if ms else 0.0)
    kernel = tr.raster_tiles_ms if ms else tr.raster_tiles
    plain = tr.raster_tiles_ms_plain if ms else tr.raster_tiles_plain
    got = kernel(rows, starts, counts, w, h, 5)
    want = plain(rows, starts, counts, w, h, 5)
    assert got[4].shape[0] == 5           # planes [A, H, W]
    for i in ((0, 1, 2, 3, 5) if ms else (0, 1, 2, 3)):
        assert torch.equal(got[i], want[i]), i
    assert float((got[4] - want[4]).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", CROWD_CASES, ids=["random", "dense"])
@pytest.mark.parametrize("ms", [False, True], ids=["K5a", "K5b"])
def test_crowd_raster_kernels_bit_exact_at_five_attributes(cuda, case, ms):
    n_inst, t, spread, size, w, h, z = case
    rows, starts, counts, _ = _crowd_bins(cuda, n_inst, t, spread, size, w,
                                          h, z, 0.375 if ms else 0.0,
                                          n_attrs=5)
    kernel = tr.raster_tiles_ms_multi if ms else tr.raster_tiles_multi
    plain = (tr.raster_tiles_ms_multi_plain if ms
             else tr.raster_tiles_multi_plain)
    got = kernel(rows, starts, counts, n_inst, w, h, 5)
    want = plain(rows, starts, counts, n_inst, w, h, 5)
    for i in ((0, 1, 2, 3, 5) if ms else (0, 1, 2, 3)):
        assert torch.equal(got[i], want[i]), i
    assert float((got[4] - want[4]).abs().max()) <= 1e-6


TEXTURED = {
    "deferred-16-parts-resident": dict(textures=(64, 32, 16, 8) * 4,
                                       n_parts=16, texture_mips=4),
    "msaa4-kernel-uv": dict(textures=(64, 16), msaa=4, albedo_window=False),
    "crowd-msaa1-mips": dict(textures=(64, 16), texture_mips=4),
    "crowd-msaa4": dict(textures=(64, 16), msaa=4),
}


@pytest.mark.parametrize("kind", list(TEXTURED))
def test_textured_frames_on_the_card_match_the_cpu(cuda, kind):
    """Two textured frames on the card and on the CPU (plain versions)
    within the image tolerance: a single frame of 16 parts through the
    deferred-UV path with mips and the resident mini-atlas, a single
    msaa=4 frame with the UVs through K4, and a crowd of 3 through the
    shared atlas (a mip atlas passed per call, and at msaa=4)."""
    from simple_mmd_renderer_tpu_torch.parallel import mesh

    crowd = kind.startswith("crowd")
    out = {}
    for dev in ("cuda", "cpu"):
        scene = build_sample_scene(0.5, 128, 64 if crowd else 96, 64, dev,
                                   n_frames=60, fps_keys=10,
                                   solver_iterations=4, **TEXTURED[kind])
        if crowd:
            state = mesh.crowd_init(scene, 3)
            step = mesh.crowd_step_fn(scene, atlas_arg=True)
            for _ in range(2):
                state, images = step(state, scene.packed_atlas())
        else:
            state = scene.init_state()
            for _ in range(2):
                state, images = scene.step_and_render(state)
        out[dev] = images.cpu().numpy()
    d = np.abs(out["cuda"] - out["cpu"])
    assert (d > 0.02).mean() < 2e-3 and d.mean() < 1 / 255



# ---------------------------------------------------------------------------
# The rest of the reference frame: the edge hull's rasters (front faces
# only, K2 at 0 attributes, K5a at 1), double-sided triangles (both
# windings in one bin) and the full look on the card against the CPU
# ---------------------------------------------------------------------------

def _windings(rows, starts, counts):
    """(entries of negative and of positive signed area, tiles holding
    both): a row's barycentric slopes give w1x * w2y - w1y * w2x =
    1 / area2."""
    idx, tile = tr._tile_entries(starts, counts)
    r = rows[idx]
    pos = (r[:, 2] * r[:, 5] - r[:, 3] * r[:, 4]) > 0
    n = counts.shape[0]
    both = ((torch.bincount(tile[pos], minlength=n) > 0)
            & (torch.bincount(tile[~pos], minlength=n) > 0))
    return int((~pos).sum()), int(pos.sum()), int(both.sum())


@pytest.mark.parametrize("case", CASES, ids=["random", "compacted", "dense"])
def test_edge_hull_raster_kernel_bit_exact(cuda, case):
    """K2 at 0 attributes on a front-culled mesh (the edge hull's raster):
    bit-exact against its plain version, with boxes and without; only
    triangles of positive area are binned."""
    t, spread, size, w, h, _, e_max, z = case
    rows, starts, counts, boxes, _ = _bins(cuda, t, spread, size, w, h,
                                           raster.CULL_FRONT, e_max, z,
                                           n_attrs=0, boxes=True)
    neg, pos, _ = _windings(rows, starts, counts)
    assert neg == 0 and pos > 0
    want = tr.raster_tiles_plain(rows, starts, counts, w, h, 0)
    for bx in (boxes, None):
        got = tr.raster_tiles(rows, starts, counts, w, h, 0, bx)
        for g, p in zip(got, want):
            assert torch.equal(g, p)


@pytest.mark.parametrize("case", CROWD_CASES, ids=["random", "dense"])
def test_edge_hull_crowd_raster_kernel_bit_exact(cuda, case):
    """K5a at 1 attribute on front-culled meshes (the crowd's edge hull):
    bit-exact against its plain version, the attribute plane included."""
    n_inst, t, spread, size, w, h, z = case
    rows, starts, counts, boxes = _crowd_bins(cuda, n_inst, t, spread, size,
                                              w, h, z, n_attrs=1,
                                              cull=raster.CULL_FRONT)
    neg, pos, _ = _windings(rows, starts, counts)
    assert neg == 0 and pos > 0
    got = tr.raster_tiles_multi(rows, starts, counts, n_inst, w, h, 1, boxes)
    want = tr.raster_tiles_multi_plain(rows, starts, counts, n_inst, w, h, 1)
    for g, p in zip(got, want):
        assert torch.equal(g, p)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5a", "K5b"])
@pytest.mark.parametrize("case", ["random", "dense"])
def test_raster_kernels_bit_exact_with_nocull(cuda, kernel, case):
    """Back culling with every other triangle double-sided: both windings
    in one bin (some tile holds both), each kernel bit-exact against its
    plain version (the attributes within 1e-6). K1 is the depth raster's
    (`rasterize_depth_tiled(nocull=)`)."""
    ms = kernel in ("K4", "K5b")
    ext = 0.375 if ms else 0.0
    crowd = kernel.startswith("K5")
    t, spread, size, w, h = ((300, 0.9, 0.25, 256, 144) if case == "random"
                             else (2000, 0.05, 0.08, 128, 64))
    z = (0.1, 0.9) if case == "random" else (0.5, 0.5)
    nocull = np.arange(t) % 2 == 0
    if crowd:
        rows, starts, counts, boxes = _crowd_bins(
            cuda, 3, t, spread, size, w, h, z, ext, cull=raster.CULL_BACK,
            nocull=nocull)
        args = (rows, starts, counts, 3, w, h, 3)
        fn, plain = ((tr.raster_tiles_ms_multi, tr.raster_tiles_ms_multi_plain)
                     if ms else (tr.raster_tiles_multi,
                                 tr.raster_tiles_multi_plain))
    else:
        rows, starts, counts, boxes, _ = _bins(
            cuda, t, spread, size, w, h, raster.CULL_BACK, 6, z,
            sample_extent=ext, boxes=True, nocull=nocull)
        args = (rows, starts, counts, w, h, 3)
        fn, plain = ((tr.raster_tiles_ms, tr.raster_tiles_ms_plain) if ms
                     else (tr.raster_tiles, tr.raster_tiles_plain))
    neg, pos, both = _windings(rows, starts, counts)
    assert neg > 0 and pos > 0 and both > 0
    if kernel == "K1":
        args = args[:5]
        assert torch.equal(tr.depth_tiles(*args, boxes),
                           tr.depth_tiles_plain(*args))
        return
    got = fn(*args, boxes)
    want = plain(*args)
    for i in ((0, 1, 2, 3, 5) if ms else (0, 1, 2, 3)):
        assert torch.equal(got[i], want[i]), i
    assert float((got[4] - want[4]).abs().max()) <= 1e-6


def test_depth_entry_with_nocull_on_the_card_matches_the_cpu(cuda):
    """`rasterize_depth_tiled(..., nocull=)` on the card (K1 on the
    double-sided triangles' bins, their big-triangle merge on KSb + KS)
    equals the same call on the CPU (the plain versions), bit for bit, and
    differs from the call without the exemption."""
    rng = np.random.default_rng(21)
    t = 400
    v0 = rng.uniform(-0.9, 0.9, (t, 2))
    verts = np.stack([v0, v0 + rng.uniform(-0.3, 0.3, (t, 2)),
                      v0 + rng.uniform(-0.3, 0.3, (t, 2))], 1).reshape(-1, 2)
    verts[:3] = [[-1.0, -1.0], [1.0, -1.0], [0.0, 1.0]]   # a big one
    clip = np.concatenate([verts, rng.uniform(0.1, 0.9, (3 * t, 1)),
                           np.ones((3 * t, 1))], -1).astype(np.float32)
    tris = np.arange(3 * t, dtype=np.int32).reshape(t, 3)
    nocull = np.arange(t) % 2 == 0
    out = {}
    for dev in ("cpu", cuda):
        c, tt = torch.as_tensor(clip, device=dev), torch.as_tensor(
            tris, device=dev)
        out[str(dev)] = [tr.rasterize_depth_tiled(
            c, tt, 256, 256, raster.CULL_BACK, 2,
            nocull=None if nc is None else torch.as_tensor(nc, device=dev))
            for nc in (nocull, None)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got.cpu(), want)
    assert not torch.equal(out["cpu"][0], out["cpu"][1])


def _look(n_parts=2):
    from simple_mmd_renderer_tpu_torch.app.sample import (sample_equirect,
                                                          sample_mmd_maps)
    from simple_mmd_renderer_tpu_torch.render.ibl import equirect_to_cubemap

    return dict(cubemap=equirect_to_cubemap(sample_equirect(32, 64), 16,
                                            device="cpu"),
                show_edges=True, double_sided_parts=(1,),
                mmd_maps=sample_mmd_maps(n_parts, 32, 16))


@pytest.mark.parametrize("kind", ["single-msaa1", "single-msaa4",
                                  "crowd-msaa1", "crowd-msaa4"])
def test_full_look_frames_on_the_card_match_the_cpu(cuda, kind):
    """Two frames with the skybox, edges, a double-sided part and the MMD
    maps (textured) on the card and on the CPU (plain versions) within the
    image tolerance; the card launches the edge hull's raster beside the
    character's every frame."""
    from simple_mmd_renderer_tpu_torch.parallel import mesh

    crowd = kind.startswith("crowd")
    msaa = 4 if kind.endswith("4") else 1
    out = {}
    for dev in ("cuda", "cpu"):
        scene = build_sample_scene(0.5, 128, 64 if crowd else 96, 64, dev,
                                   n_frames=60, fps_keys=10,
                                   solver_iterations=4, textures=(64, 16),
                                   msaa=msaa, **_look())
        before = (tr.raster_launches, tr.raster_multi_launches)
        if crowd:
            state = mesh.crowd_init(scene, 3)
            step = mesh.crowd_step_fn(scene)
            for _ in range(2):
                state, images = step(state)
        else:
            state = scene.init_state()
            for _ in range(2):
                state, images = scene.step_and_render(state)
        if dev == "cuda":
            k2 = tr.raster_launches - before[0]
            k5a = tr.raster_multi_launches - before[1]
            if crowd:
                assert k5a == (2 if msaa == 4 else 4) and k2 == 0
            else:
                assert k2 == (2 if msaa == 4 else 4) and k5a == 0
        out[dev] = images.cpu().numpy()
    d = np.abs(out["cuda"] - out["cpu"])
    assert (d > 0.02).mean() < 2e-3 and d.mean() < 1 / 255


def _content_scene(device, density, *args, **kw):
    """A scene of chip_smoke's content rig (SDEF vertices, a UV and a
    material morph, through write_pmx and parse_pmx) at `density` on
    `content_motion(12, 2)` (both morphs well above 0 from frame 1), with
    `sdef_true` and the extended morphs on."""
    import chip_smoke

    return chip_smoke.build_content(None, density, *args, device=device,
                                    n_frames=12, fps_keys=2, **kw)


@pytest.mark.parametrize("kind", ["single", "crowd"])
def test_content_step_replays_equal_eager_steps(cuda, kind):
    """The content rig's step with `sdef_true` captured and replayed 4
    times under torch.cuda.set_sync_debug_mode("error"): the eager step's
    bits, every state leaf, pose field, position and normal; the single
    rig at density 2.0, 64 instances of it at 0.5."""
    from simple_mmd_renderer_tpu_torch.parallel import mesh
    from simple_mmd_renderer_tpu_torch.utils.graph import (sync_errors,
                                                           tree_leaves)

    if kind == "single":
        scene = _content_scene("cuda", 2.0)
        state = scene.init_state()
    else:
        scene = _content_scene("cuda", 0.5, 256, 144, 256)
        state = mesh.crowd_init(scene, 64)
    assert scene.rig.n_sdef > 0 and scene.config.sdef_true
    eager, s = [], state
    for _ in range(4):
        eager.append(scene.step_pose(s))
        s = eager[-1][0]
    step = scene.jit_step(render=False)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    with sync_errors():
        s = state
        for want in eager:
            got = step(s)
            for a, b in zip(tree_leaves(got), tree_leaves(want),
                            strict=True):
                bad += (a != b).sum()
            s = got[0]
    assert int(bad) == 0


@pytest.mark.parametrize("kind", ["single-msaa1", "single-msaa4",
                                  "crowd-msaa1", "crowd-msaa4"])
def test_content_frames_on_the_card_match_the_cpu(cuda, kind):
    """Two textured frames of the content rig (SDEF, UV and material
    morphs) on the card and on the CPU (plain versions) within the image
    tolerance; the morphs move the card's frame."""
    import copy

    from simple_mmd_renderer_tpu_torch.parallel import mesh

    crowd = kind.startswith("crowd")
    msaa = 4 if kind.endswith("4") else 1
    out = {}
    for dev in ("cuda", "cpu"):
        scene = _content_scene(dev, 0.25 if crowd else 0.5, 128,
                               64 if crowd else 96, 64, solver_iterations=4,
                               textures=(64, 16), msaa=msaa)
        plain = copy.copy(scene)
        plain.config = dataclasses.replace(scene.config,
                                           apply_extended_morphs=False)
        if crowd:
            state, step = mesh.crowd_init(scene, 3), mesh.crowd_step_fn(scene)
            for _ in range(2):
                state, images = step(state)
            off = mesh.crowd_step_fn(plain)(state)[1]
            images = step(state)[1]
        else:
            state = scene.init_state()
            for _ in range(2):
                state, images = scene.step_and_render(state)
            off = plain.step_and_render(state)[1]
            images = scene.step_and_render(state)[1]
        assert float((images - off).abs().max()) > 0.05
        out[dev] = images.cpu().numpy()
    d = np.abs(out["cuda"] - out["cpu"])
    assert (d > 0.02).mean() < 2e-3 and d.mean() < 1 / 255


def _cli_scene(device, directory, density, width, height, *flags):
    """The CLI's Scene (`app.cli.build_scene`) of chip_smoke's written PMX
    and VMD (camera and light tracks) with `flags`, on `device`."""
    import chip_smoke
    from simple_mmd_renderer_tpu_torch.app import cli

    pmx, vmd = chip_smoke.cli_files(directory, density=density)
    args = cli.parse_args([pmx, vmd, "--use-camera", "--use-light",
                           "--width", str(width), "--height", str(height),
                           "--shadow-size", "256", *flags])
    return cli.build_scene(args, torch.device(device))


@pytest.mark.parametrize("kind", ["msaa1", "msaa4", "ortho", "crowd"])
def test_camera_track_frames_on_the_card_match_the_cpu(cuda, tmp_path,
                                                       kind):
    """Frames of the CLI's Scene with the camera and light tracks on the
    card and on the CPU (plain versions) within the image tolerance: two
    frames at msaa=1 and 4, an orthographic frame (frame 5, inside the
    track's "perspective off" range), and a crowd of 3 with the camera
    track (the per-instance fallback: K1, K2, K3 an instance)."""
    from simple_mmd_renderer_tpu_torch.parallel import mesh

    out = {}
    for dev in ("cuda", "cpu"):
        flags = ("--msaa", "4") if kind == "msaa4" else ()
        scene = _cli_scene(dev, str(tmp_path), 0.25 if kind == "crowd"
                           else 0.5, 128, 96, *flags)
        scene.config.physics.solver_iterations = 4
        if kind == "crowd":
            state, step = mesh.crowd_init(scene, 3), mesh.crowd_step_fn(scene)
        else:
            state, step = scene.init_state(), scene.step_and_render
        if kind == "ortho":
            state = scene.seek(state, 4 / 30)
            assert bool(scene.frame_config(
                state.time + 1 / 30).camera_orthographic)
        for _ in range(1 if kind == "ortho" else 2):
            state, images = step(state)
        out[dev] = images.cpu().numpy()
    d = np.abs(out["cuda"] - out["cpu"])
    assert (d > 0.02).mean() < 2e-3 and d.mean() < 1 / 255


def test_captured_seek_equals_eager_seek(cuda, tmp_path):
    """The seek captured as a CUDA graph (once per scene) equals the eager
    seek bit for bit at three times, and a seek after playback equals a
    seek from a fresh state."""
    scene = _cli_scene("cuda", str(tmp_path), 0.5, 128, 96)
    fresh = scene.init_state()

    def leaves(s):
        return [s.time, s.physics.pos, s.physics.quat, s.physics.vel,
                s.physics.omega]

    for t in (0.1, 0.5, 2.0):
        got, want = scene.seek(fresh, t), scene.seek(fresh, t, compiled=False)
        assert all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                     leaves(want))), t
    graph = scene._seek
    step = scene.jit_step(render=False, donate=False)
    s = fresh
    for _ in range(3):
        s = step(s)[0]
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(scene.seek(s, 0.5)), leaves(scene.seek(fresh, 0.5))))
    assert scene._seek is graph


def test_track_sampling_has_no_host_sync(cuda, tmp_path):
    """sample_camera, sample_light, the Scene's frame config (tracks and a
    device camera_override) and build_matrices with the tensor ortho flag
    run under sync debug mode "error"."""
    from simple_mmd_renderer_tpu_torch.render import camera_anim, pipeline
    from simple_mmd_renderer_tpu_torch.utils.graph import sync_errors

    scene = _cli_scene("cuda", str(tmp_path), 0.5, 128, 96)
    state = scene.seek(scene.init_state(), 4 / 30)
    override = tuple(torch.zeros(3, device=cuda) + v for v in (1.0, 0.5))
    fov = torch.full((), 30.0, device=cuda)
    with sync_errors():
        frame = state.time * scene.config.fps
        cam = camera_anim.sample_camera(scene.camera, frame)
        light = camera_anim.sample_light(scene.light, frame)
        cfg = scene.frame_config(state.time)
        mats = pipeline.build_matrices(cfg, device=cuda)
        live = scene.frame_config(state.time, override + (fov,))
        pipeline.build_matrices(live, device=cuda)
    assert cam["ortho"].is_cuda and light["direction"].is_cuda
    assert bool(cfg.camera_orthographic) and mats["proj"].is_cuda


def test_capture_survives_dead_graphs(cuda):
    """Scenes dropped with their captured steps (a scene and its graphs
    form a reference cycle) are freed by the cyclic collector; with the
    collector set to run at almost every allocation, a later capture must
    still succeed (a graph destroyed while a stream captures invalidates
    the capture) and replay the eager step's bits."""
    import gc

    def scene():
        return build_sample_scene(0.25, 64, 48, 64, "cuda", n_frames=30,
                                  fps_keys=10, solver_iterations=2)

    threshold = gc.get_threshold()
    try:
        for _ in range(3):
            dead = scene()
            dead.seek(dead.init_state(), 0.2)
            dead.jit_step(render=False)(dead.init_state())
            del dead
        gc.set_threshold(1, 1, 1)
        live = scene()
        state = live.init_state()
        got = live.jit_step(render=False, donate=False)(state)[0]
    finally:
        gc.set_threshold(*threshold)
    want = live.step_pose(state)[0]
    assert torch.equal(got.physics.pos, want.physics.pos)
    assert torch.equal(got.time, want.time)


def _scan_setup(device, t, w, h, seed, cull=raster.CULL_NONE, n_inst=None):
    """`raster.setup` of a random mesh (one big triangle among t) on the
    device, [t + 1, ...], or [n_inst, t + 1, ...] (instances moved
    apart)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-0.9, 0.9, (t, 2))
    verts = np.stack([v0, v0 + rng.uniform(-0.3, 0.3, (t, 2)),
                      v0 + rng.uniform(-0.3, 0.3, (t, 2))], 1).reshape(-1, 2)
    zs = rng.uniform(0.05, 0.95, 3 * t)
    clip = np.concatenate([verts, zs[:, None], np.ones((3 * t, 1))], -1)
    clip = np.concatenate([clip, [[-3, -3, 0.9, 1], [3, -3, 0.9, 1],
                                  [0, 3, 0.9, 1]]]).astype(np.float32)
    if n_inst:
        shift = rng.uniform(-0.2, 0.2, (n_inst, 1, 4)) * [1, 1, 0, 0]
        clip = (clip[None] + shift).astype(np.float32)
    tris = torch.arange(3 * t + 3, dtype=torch.int32,
                        device=device).reshape(-1, 3)
    return raster.setup(torch.as_tensor(clip, device=device), tris, w, h,
                        cull)


def _assert_vis_bits(got, want):
    assert torch.equal(got.depth, want.depth)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.bary, want.bary)


SCAN_CASES = {"random": dict(t=699), "back": dict(t=300, cull=1),
              "stage": dict(t=255), "one": dict(t=0),
              "start": dict(t=700), "crowd": dict(t=515, n_inst=3),
              "off_frame": None, "ragged": None, "off_frame_pair": None,
              "corner_start": None}
# the coarse tiles chip_smoke.py sweeps (tr.SCAN_TILE among them)
SCAN_TILES = (16, 32, 64, 128)


def _scan_case(device, case, w, h):
    """The setup of SCAN_CASES[case] on the device: `_scan_setup`'s random
    meshes, or tests/test_torch_scan_bins.py's with triangles over the
    whole frame, off it, across its corner, beyond it at `_BOX_MAX` and of
    zero area ("off_frame": n = 206; "ragged": n = 33; "off_frame_pair":
    two instances); "corner_start": 300 triangles near the top-left
    corner, so that most tiles are empty."""
    from test_torch_scan_bins import _random_setup

    kw = SCAN_CASES[case]
    if kw is not None:
        return _scan_setup(device, seed=len(case), w=w, h=h, **kw)
    if case == "corner_start":
        xy, z = screen_triangles("random", 5, 300, w, h)
        s = screen_setup(xy * np.float32(0.3), z, 0.0)
        return {k: v.to(device) for k, v in s.items()}
    t, n_inst = {"off_frame": (200, None), "ragged": (27, None),
                 "off_frame_pair": (150, 2)}[case]
    s = _random_setup(len(case), t, w, h, n_inst)
    return {k: v.to(device) for k, v in s.items()}


@pytest.mark.parametrize("tile", SCAN_TILES)
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_kernel_bit_exact(cuda, monkeypatch, case, tile):
    """KS against its plain version: depth, triangle ids and barycentrics
    bit for bit (triangle counts 1, 33, 256, 301, 516, 700 and 701 against
    the staging chunk of 256 and the 32-bit words of the bins), from a
    start buffer, over two and three instances, with triangles off the
    frame, over it and at the boxes' limit, in a corner only (the blocks
    of empty tiles keep the start buffer), at every swept tile (none
    divides 333 x 197); a second run gives the same bits; the counters
    count one KSb and one KS launch."""
    w, h = 333, 197
    s = _scan_case(cuda, case, w, h)
    vis = None
    if case in ("start", "corner_start"):
        rng = np.random.default_rng(3)
        vis = raster.VisBuffer(
            torch.as_tensor(rng.uniform(0.3, 1.0, (h, w)).astype(np.float32),
                            device=cuda),
            torch.as_tensor(rng.integers(-1, 50, (h, w)).astype(np.int32),
                            device=cuda),
            torch.as_tensor(rng.uniform(size=(h, w, 2)).astype(np.float32),
                            device=cuda))
    monkeypatch.setattr(tr, "SCAN_TILE", tile)
    before = tr.scan_launches, tr.scan_bin_launches
    got = tr.scan_raster(w, h, s, vis)
    assert (tr.scan_launches, tr.scan_bin_launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = tr.scan_raster_plain(w, h, s, vis)
    _assert_vis_bits(got, want)
    _assert_vis_bits(tr.scan_raster(w, h, s, vis), got)
    assert (got.tri >= 0).float().mean() > 0.3
    if case in ("crowd", "off_frame_pair"):
        assert got.depth.shape == (s["xy"].shape[0], h, w)
        assert not torch.equal(got.tri[0], got.tri[1])


@pytest.mark.parametrize("tile", SCAN_TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_scan_kernel_adversarial_boxes(cuda, monkeypatch, kind, tile):
    """KS skips a triangle where its pixel box misses the block, and KSb
    leaves it out of a tile its box misses: on the adversarial sets
    (slivers, vertices on centres, samples and edges, ties) it must still
    equal the brute-force plain version, at every swept tile."""
    w, h = 320, 192
    s = screen_setup(*screen_triangles(kind, 11, 600, w, h), 0.0)
    s = {k: v.to(cuda) for k, v in s.items()}
    monkeypatch.setattr(tr, "SCAN_TILE", tile)
    _assert_vis_bits(tr.scan_raster(w, h, s), tr.scan_raster_plain(w, h, s))


@pytest.mark.parametrize("tile", SCAN_TILES)
@pytest.mark.parametrize("case", ["off_frame", "ragged", "off_frame_pair",
                                  "crowd", "slivers", "edges", "random"])
def test_scan_bins_kernel_bit_exact(cuda, case, tile):
    """KSb's words against scan_bins_plain's bit for bit (the clear
    included: the buffer is filled with ones first), on the random,
    off-frame, ragged and crowd setups and on adversarial sets; the
    counter counts the launch, and KS is not launched."""
    w, h = 333, 197
    if case in KINDS:
        s = screen_setup(*screen_triangles(case, 7, 600, w, h), 0.0)
        s = {k: v.to(cuda) for k, v in s.items()}
    else:
        s = _scan_case(cuda, case, w, h)
    n = s["xy"].shape[-3]
    table = tr._scan_table(s).reshape(-1, n, 16).contiguous()
    before = tr.scan_launches, tr.scan_bin_launches
    fill = torch.empty(1 << 24, dtype=torch.int32, device=cuda).fill_(-1)
    del fill                 # the allocator hands the ones out again
    got = tr.scan_bins(table, w, h, tile)
    assert (tr.scan_launches, tr.scan_bin_launches) == (before[0],
                                                        before[1] + 1)
    want = tr.scan_bins_plain(table, w, h, tile)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert want.any() and (want != -1).any()


@pytest.mark.parametrize("n_big", [1, tr.BIG_TRI_CAP])
def test_scan_kernel_big_triangle_subset(cuda, n_big):
    """A big-triangle subset as the tiled rasters' merges hand it to KS
    (`_big_subset`: the first 1 or BIG_TRI_CAP oversized triangles of a
    mesh, at 1920 x 1080): the same bits as the plain scan."""
    w, h = 1920, 1080
    rng = np.random.default_rng(n_big)
    t = 200
    v0 = rng.uniform(-0.9, 0.9, (t, 2))
    verts = np.stack([v0, v0 + rng.uniform(-1.2, 1.2, (t, 2)),
                      v0 + rng.uniform(-1.2, 1.2, (t, 2))], 1).reshape(-1, 2)
    zs = rng.uniform(0.05, 0.95, 3 * t)
    clip = torch.as_tensor(np.concatenate(
        [verts, zs[:, None], np.ones((3 * t, 1))], -1).astype(np.float32),
        device=cuda)
    tris = torch.arange(3 * t, dtype=torch.int32, device=cuda).reshape(-1, 3)
    s = raster.setup(clip, tris, w, h, raster.CULL_NONE)
    big = s["valid"] & (torch.cumsum(s["valid"].int(), 0) <= n_big)
    _, s_big = tr._big_subset(s, big)
    assert s_big["xy"].shape[0] == n_big
    got = tr.scan_raster(w, h, s_big)
    _assert_vis_bits(got, tr.scan_raster_plain(w, h, s_big))
    assert (got.tri >= 0).any()


def test_scan_kernel_captured(cuda):
    """KSb and KS captured in a CUDA graph under sync debug mode "error"
    (no host read: the tile follows from the shapes, the bins are
    allocated from the graph's pool and cleared on the stream), replayed
    equal to the eager call, also after the inputs change in place."""
    w, h = 333, 197
    s = _scan_setup(cuda, 699, w, h, 5, n_inst=2)
    eager = tr.scan_raster(w, h, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = tr.scan_launches, tr.scan_bin_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = tr.scan_raster(w, h, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (tr.scan_launches, tr.scan_bin_launches) == (before[0] + 1,
                                                        before[1] + 1)
    graph.replay()
    torch.cuda.synchronize()
    _assert_vis_bits(out, eager)
    for key, value in _scan_setup(cuda, 699, w, h, 6, n_inst=2).items():
        s[key].copy_(value)
    graph.replay()
    torch.cuda.synchronize()
    _assert_vis_bits(out, tr.scan_raster_plain(w, h, s))
    assert not torch.equal(out.tri, eager.tri)


def test_scan_kernel_on_nothing(cuda):
    """No triangle, or no pixel: the start buffer comes back, no launch."""
    s = _scan_setup(cuda, 10, 64, 48, 1)
    empty = {k: v[:0] for k, v in s.items()}
    before = tr.scan_launches, tr.scan_bin_launches
    got = tr.scan_raster(64, 48, empty)
    assert (tr.scan_launches, tr.scan_bin_launches) == before
    assert (got.depth == 1).all() and (got.tri == -1).all()
    assert not got.bary.any()


@pytest.mark.parametrize("path", ["attrs", "msaa", "depth", "window",
                                  "crowd", "crowd_msaa", "crowd_depth"])
def test_big_triangle_merge_on_the_scan_kernel(cuda, monkeypatch, path):
    """A tiled raster whose big-triangle merge is live (e_max 2 on the
    single frame, the crowd's own e_max; one frame-filling triangle among
    many large ones) gives the same bits with the merge on KS as with the
    merge on the plain scan, in every raster that merges."""
    w, h = 320, 192
    rng = np.random.default_rng(4)
    t = 400
    v0 = rng.uniform(-0.9, 0.9, (t, 2))
    verts = np.stack([v0, v0 + rng.uniform(-0.6, 0.6, (t, 2)),
                      v0 + rng.uniform(-0.6, 0.6, (t, 2))], 1).reshape(-1, 2)
    zs = rng.uniform(0.05, 0.95, 3 * t)
    clip = np.concatenate([verts, zs[:, None], np.ones((3 * t, 1))], -1)
    clip = np.concatenate([clip, [[-3, -3, 0.9, 1], [3, -3, 0.9, 1],
                                  [0, 3, 0.9, 1]]]).astype(np.float32)
    tris = torch.arange(3 * t + 3, dtype=torch.int32,
                        device=cuda).reshape(-1, 3)
    crowd = path.startswith("crowd")
    if crowd:
        clip = np.stack([clip, clip * np.float32([0.8, 1.1, 1, 1])])
    clip = torch.as_tensor(clip, device=cuda)
    attrs = torch.as_tensor(rng.normal(size=clip.shape[:-1] + (3,)).astype(
        np.float32), device=cuda)
    cull = raster.CULL_NONE
    run = {
        "attrs": lambda: tr.rasterize_attrs_tiled(clip, tris, attrs, w, h,
                                                  cull, 2),
        "msaa": lambda: tr.rasterize_attrs_tiled_msaa(clip, tris, attrs, w, h,
                                                      cull, 2),
        "depth": lambda: (tr.rasterize_depth_tiled(clip, tris, w, h, cull,
                                                   2),),
        "window": lambda: (tr.rasterize_depth_tiled_window(
            clip, tris, w, h, cull, 2, tile_h=8),),
        "crowd": lambda: tr.rasterize_attrs_tiled_crowd(clip, tris, attrs, w,
                                                        h, cull),
        "crowd_msaa": lambda: tr.rasterize_attrs_tiled_msaa_crowd(
            clip, tris, attrs, w, h, cull),
        "crowd_depth": lambda: (tr.rasterize_depth_tiled_crowd(
            clip, tris, w, h, cull),),
    }[path]
    before = tr.scan_launches
    on_kernel = run()
    assert tr.scan_launches == before + 1, "the merge must be live"
    monkeypatch.setattr(tr, "scan_raster", tr.scan_raster_plain)
    on_plain = run()
    for a, b in zip(on_kernel, on_plain):
        if isinstance(a, raster.VisBuffer):
            _assert_vis_bits(a, b)
        else:
            assert torch.equal(a, b)


def _calls_bit_exact(seen):
    """Every recorded kernel call (chip_smoke.capture_frame) against its
    plain version on the call's own arguments: every plane bit-exact and
    equal to what the frame computed, the attributes within 1e-6."""
    import chip_smoke

    table = chip_smoke._kernel_table()
    for key, calls in seen.items():
        fn, plain, n_args, attr_at = table[key]
        for args, out in calls:
            got, want = fn(*args), plain(*args[:n_args])
            got, want, out = ((x,) if isinstance(x, torch.Tensor) else x
                              for x in (got, want, out))
            for j, (a, b, c) in enumerate(zip(got, want, out)):
                if j == attr_at:
                    assert float((a - b).abs().max()) <= 1e-6, key
                else:
                    assert torch.equal(a, b) and torch.equal(a, c), key


@pytest.mark.parametrize("built_on", ["cuda", "cpu"])
def test_banded_frame_on_a_repeated_mesh(cuda, built_on):
    """`frame_jit` over `make_mesh(["cuda:0"] * 2)`: both bands' kernel
    calls bit-exact against their plain versions, the gathered frame
    within the image tolerance of the unbanded frame of the same state,
    state' equal to the unbanded step's. A scene built on the CPU is
    replicated to the card (`Scene.replica`) and gives the same frame."""
    import chip_smoke
    from simple_mmd_renderer_tpu_torch.parallel import mesh
    from simple_mmd_renderer_tpu_torch.utils.graph import tree_map

    scene = build_sample_scene(0.5, 256, 192, 256, built_on, n_frames=30,
                               fps_keys=10, solver_iterations=2)
    step = mesh.frame_jit(scene, mesh.make_mesh(["cuda:0"] * 2))
    state0 = scene.init_state()
    state, image, seen = chip_smoke.capture_frame(
        step, state0, {"K1": 2, "K2": 2, "K3": 2})
    _calls_bit_exact(seen)
    assert image.devices == (torch.device("cuda", 0),) * 2
    assert all(b.is_cuda and b.shape == (96, 256, 3) for b in image.shards)
    card = scene if built_on == "cuda" else scene.replica("cuda")
    state_1, full = card.jit_step(donate=False)(
        tree_map(lambda t: t.to(card.device), state0))
    d = (image.gather() - full).abs()
    assert float((d > 0.02).float().mean()) < 2e-3
    assert float(d.mean()) < 1 / 255
    assert torch.equal(state.physics.pos, state_1.physics.pos)
    assert torch.equal(state.time, state_1.time)


def test_sharded_crowd_on_a_repeated_mesh(cuda):
    """`crowd_jit` over `make_mesh(["cuda:0"] * 2)`: both shards' kernel
    calls bit-exact against their plain versions; the gathered images and
    state against `crowd_step_fn` over all 4 instances on the card (the
    image tolerance; state 1e-4), the shards' outputs their own tensors."""
    import chip_smoke
    from simple_mmd_renderer_tpu_torch.parallel import mesh

    scene = build_sample_scene(0.25, 128, 64, 64, "cuda", n_frames=60,
                               fps_keys=10, solver_iterations=4)
    m = mesh.make_mesh(["cuda:0"] * 2)
    step = mesh.crowd_jit(scene, m)
    state0 = mesh.crowd_init(scene, 4)
    state, images, seen = chip_smoke.capture_frame(
        step, mesh.shard_crowd(state0, m), {"K5c": 2, "K5a": 2, "K3": 2})
    _calls_bit_exact(seen)
    assert len({x.data_ptr() for x in images.shards}) == 2
    state_1, images_1 = mesh.crowd_step_fn(scene)(state0)
    d = (images.gather() - images_1).abs()
    assert float((d > 0.02).float().mean()) < 2e-3
    assert float(d.mean()) < 1 / 255
    whole = state.gather()
    for name in ("pos", "quat", "vel", "omega"):
        gap = (getattr(whole.physics, name) - getattr(state_1.physics, name))
        assert float(gap.abs().max()) <= 1e-4, name


def test_native_pmx_parser_loads(cuda, monkeypatch):
    """The card's machine has a host compiler (nvcc needs one), so the
    PMX reader's native vertex parser builds and loads there and reads the
    sample character as the Python loop does."""
    from simple_mmd_renderer_tpu_torch import native
    from simple_mmd_renderer_tpu_torch.formats import pmx
    from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx

    assert native.get_lib() is not None
    data = write_pmx(sample_character(density=0.5))
    fast = pmx.parse_pmx(data)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = pmx.parse_pmx(data)
    for f in ("positions", "normals", "uvs", "skin_type", "skin_bones",
              "skin_weights", "sdef_c", "edge_scale", "triangles"):
        assert np.array_equal(getattr(fast, f), getattr(slow, f)), f


# ---------------------------------------------------------------------------
# The CCD solve (`csrc/ccd.cu`): its primitives against torch's, the
# order codes against cuBLAS at every batch, and the whole solve of each
# IK group against the plain loop, bit for bit
# ---------------------------------------------------------------------------

def _ccd_data(g, seed, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape: torch.randn(shape, device="cuda",
                                      generator=gen) * scale


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("g", [1, 2, 128])
def test_ccd_primitives_equal_torch(cuda, g):
    """The kernel's torch.sum of 3 and 4 terms, vector_norm of 3,
    linalg.cross, and the 4x4 product and einsum("gji,gj->gi") in the order
    codes found at batch g, bit for bit against torch's own calls at batch
    g, over 40 draws at magnitudes 1e-3 to 1e3."""
    from simple_mmd_renderer_tpu_torch.ops import ccd

    codes = ccd.orders(cuda, g).tolist()
    assert min(codes) >= 0, codes
    for k in range(40):
        rnd = _ccd_data(g, 1000 * g + k, 10.0 ** (k % 7 - 3))
        v, w, q = rnd(g, 3), rnd(g, 3), rnd(g, 4)
        sq = v * v
        pairs = [
            (ccd.primitive("sum3", sq), torch.sum(sq, -1)),
            (ccd.primitive("sum4", q * q), torch.sum(q * q, dim=-1)),
            (ccd.primitive("norm3", v),
             torch.linalg.vector_norm(v, dim=-1, keepdim=True)[:, 0]),
            (ccd.primitive("cross", v, w), torch.linalg.cross(v, w, dim=-1)),
        ]
        a, b = rnd(g, 4, 4), rnd(g, 4, 4)
        pairs.append((ccd.primitive("mm4", a, b, codes[0]), a @ b))
        pairs.append((ccd.primitive("rotate_t", a, v, codes[1]),
                      torch.einsum("gji,gj->gi", a[:, :3, :3], v)))
        for i, (got, want) in enumerate(pairs):
            assert torch.equal(_bits(got), _bits(want)), (i, k)


def test_ccd_orders_reproduce_cublas_at_every_batch(cuda):
    """At each batch from 1 to 260 and at 300-2048, the order codes the
    device finds are candidates (not -1), and the 4x4 product and the
    einsum in those orders give torch's bits on fresh data."""
    from simple_mmd_renderer_tpu_torch.ops import ccd

    batches = list(range(1, 261)) + [300, 384, 512, 640, 1000, 1024, 2048]
    found = torch.stack([ccd.orders(cuda, g) for g in batches]).tolist()
    bad = []
    for g, codes in zip(batches, found):
        if min(codes) < 0:
            bad.append((g, codes))
            continue
        rnd = _ccd_data(g, 77 + g)
        a, b, v = rnd(g, 4, 4), rnd(g, 4, 4), rnd(g, 3)
        if not torch.equal(_bits(ccd.primitive("mm4", a, b, codes[0])),
                           _bits(a @ b)):
            bad.append((g, "mm4", codes))
        if not torch.equal(
                _bits(ccd.primitive("rotate_t", a, v, codes[1])),
                _bits(torch.einsum("gji,gj->gi", a[:, :3, :3], v))):
            bad.append((g, "rotate_t", codes))
    assert not bad, bad


def _ccd_calls_bit_equal(calls):
    """Each recorded IK group solved again by the kernel (the dispatcher,
    capturable, with flags) and by the plain loop from the same inputs:
    world, total_rot, total_trans, pre_ik_rot, ik_rot and the flags bit
    for bit. -> (active, converged) chain-iterations over the calls."""
    from simple_mmd_renderer_tpu_torch.ops import ccd

    seen = [0, 0]
    for static, p, seg, ar, at, mr, mt in calls:
        n = seg.loop * seg.links.shape[0]
        flags_plain = torch.zeros(n, dtype=torch.bool, device="cuda")
        flags_kernel = torch.ones(n, dtype=torch.bool, device="cuda")
        want = pose.solve_ik_group_plain(static, p, seg, ar, at, mr, mt,
                                         True, flags_plain)
        before = ccd.launches
        got = pose._solve_ik_group(static, p, seg, ar, at, mr, mt, True,
                                   flags_kernel)
        assert ccd.launches == before + 1
        for f in ("world", "total_rot", "total_trans", "pre_ik_rot",
                  "ik_rot"):
            d = int((_bits(getattr(got, f)) != _bits(getattr(want, f))).sum())
            assert d == 0, (f, d, seg.loop, seg.links.shape, seg.fix_types,
                            seg.orders)
        assert torch.equal(flags_plain, flags_kernel)
        seen[0] += int(flags_plain.sum())
        seen[1] += int((~flags_plain).sum())
    return seen


def test_ccd_kernel_equals_the_plain_loop_on_the_sample_rig(cuda,
                                                            monkeypatch):
    """The sample rig's leg group (2 chains, 2 links, 40 iterations) and
    toe group (2 chains, 1 link, 8) at 32 seeded frames of the sample
    dance: chains that converge within the loop and chains that do not."""
    from torch_ik_rigs import frame_inputs, record_groups

    from simple_mmd_renderer_tpu_torch.app.sample import sample_motion
    from simple_mmd_renderer_tpu_torch.core import anim

    static = build_model(sample_character(density=0.5))
    tables = ModelTables(static, device=cuda)
    motion = anim.MotionTables(anim.bind_motion(
        static, sample_motion(240, fps_keys=5)), device=cuda)
    calls = record_groups(monkeypatch, pose)
    frames = np.random.default_rng(2026).uniform(0, 240, 32)
    for fr in frames:
        pose.pre_physics_posing(tables, *frame_inputs(motion, fr),
                                capturable=True)
    monkeypatch.undo()
    assert len(calls) == 64
    active, converged = _ccd_calls_bit_equal(calls)
    assert active > 0 and converged > 0, (active, converged)


@pytest.mark.parametrize("n_inst", [64, 160])
def test_ccd_kernel_equals_the_plain_loop_on_the_crowd(cuda, monkeypatch,
                                                       n_inst):
    """The crowd's groups (2 n_inst chains each, instance-major rows,
    staggered clocks) through three eager crowd steps; at 160 instances
    more chains than the kernel's block of 256 threads, so threads take
    two chains each."""
    from torch_ik_rigs import record_groups

    from simple_mmd_renderer_tpu_torch.parallel import mesh

    scene = build_sample_scene(0.5, 64, 48, 64, n_frames=240, fps_keys=5)
    state = mesh.crowd_init(scene, n_inst)
    calls = record_groups(monkeypatch, pose)
    for _ in range(3):
        state = scene.step_pose(state)[0]
    monkeypatch.undo()
    assert calls and all(c[2].links.shape[0] == 2 * n_inst for c in calls)
    active, _ = _ccd_calls_bit_equal(calls)
    assert active > 0


@pytest.mark.parametrize("variant", list(range(6)) + ["cross"])
def test_ccd_kernel_equals_the_plain_loop_on_synthetic_rigs(cuda,
                                                            monkeypatch,
                                                            variant):
    """tests/torch_ik_rigs.py's variants: every fix type and all six Euler
    orders, limited and not, in the legs' group of two chains and the arms'
    groups of one chain of three and two links (one an append-rotated
    bone), at 8 frames each; and the "cross" rig, whose legs' chains read
    each other through append parents, in the pre-loop FK phase that
    writes them and after the loop's refresh (the kernel's lockstep)."""
    from torch_ik_rigs import frame_inputs, ik_rig, record_groups

    tables, motion = ik_rig(variant, device=cuda)
    calls = record_groups(monkeypatch, pose)
    for fr in (1, 9, 23, 37, 50, 61, 74, 88):
        pose.pre_physics_posing(tables, *frame_inputs(motion, fr),
                                capturable=True)
    monkeypatch.undo()
    assert sorted({c[2].links.shape[0] for c in calls}) == [1, 2]
    _ccd_calls_bit_equal(calls)


def test_ccd_orders_are_found_before_a_capture(cuda):
    """The order codes of a batch not yet seen are refused inside a
    capture (the eager warm-up finds them)."""
    from simple_mmd_renderer_tpu_torch.ops import ccd

    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside a capture"):
        with torch.cuda.graph(graph):
            ccd.orders(cuda, 4093)
    assert all(g != 4093 for _, g in ccd._orders)
