"""Adversarial triangle sets for the pixel boxes of the port's rasters.

Shared by tests/test_torch_boxes.py (CPU: the masked plain versions against
the unmasked ones) and tests/test_torch_cuda.py (card: K1, K6, K2, K4, K5a
and K5b against their plain versions). numpy and torch only, no JAX. Triangles are
given in screen space, so that vertices can sit exactly on pixel centres, on
sample points and on tile and frame edges; `screen_setup` then computes
what `render.raster.setup` computes from clip coordinates.
"""

import numpy as np
import torch

from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

KINDS = ("random", "subpixel", "slivers", "centres", "samples", "edges",
         "ties")


def screen_setup(xy, z, sample_extent=tr.MSAA4_EXTENT):
    """`raster.setup`'s dict from screen-space vertices xy [..., T, 3, 2]
    and depths z [..., T, 3] (float32 arrays), with no face culling."""
    xy = torch.as_tensor(np.asarray(xy, np.float32))
    z = torch.as_tensor(np.asarray(z, np.float32))
    d1 = xy[..., 1, :] - xy[..., 0, :]
    d2 = xy[..., 2, :] - xy[..., 0, :]
    area2 = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    xmin, xmax = torch.amin(xy[..., 0], -1), torch.amax(xy[..., 0], -1)
    ymin, ymax = torch.amin(xy[..., 1], -1), torch.amax(xy[..., 1], -1)
    e = float(sample_extent)
    hits = ((torch.ceil(xmin - 0.5 - e) <= torch.floor(xmax - 0.5 + e))
            & (torch.ceil(ymin - 0.5 - e) <= torch.floor(ymax - 0.5 + e)))
    valid = (torch.abs(area2) > 1e-12) & hits
    return dict(xy=xy, z=z, inv_w=torch.ones_like(z), area2=area2,
                valid=valid)


def _slivers(rng, t, w, h):
    """Triangles whose doubled area runs from 1e-10 to 10 (log-uniform;
    float32 coordinates quantise the smallest to zero area) at edge lengths
    of 0.5 to 40 pixels: a long edge and a third vertex almost on it, on
    both sides of the boxes' trust test. Half lie at random; the others
    run along a row or a column of sample points, which then sit on (or a
    rounding away from) the long edge, so that some are covered."""
    a = rng.uniform(-4, [w + 4, h + 4], (t, 2))
    ang = rng.uniform(0, 2 * np.pi, t)
    length = rng.uniform(0.5, 40.0, t)
    lined = rng.random(t) < 0.5
    off = np.asarray(tr.MSAA4_OFFSETS)[rng.integers(0, 4, t)]
    a = np.where(lined[:, None], np.floor(a) + 0.5 + off, a)
    ang = np.where(lined, rng.integers(0, 4, t) * (np.pi / 2), ang)
    u = np.round(np.stack([np.cos(ang), np.sin(ang)], -1), 12)
    n = np.stack([-u[:, 1], u[:, 0]], -1)
    b = a + u * length[:, None]
    area2 = 10.0 ** rng.uniform(-10, 1, t) * rng.choice([-1, 1], t)
    c = (a + u * (rng.uniform(0, 1, t) * length)[:, None]
         + n * (area2 / length)[:, None])
    return np.stack([a, b, c], 1)


def screen_triangles(kind, seed, t, w, h):
    """-> (xy [t, 3, 2], z [t, 3]) float32 screen-space triangles."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-8, [w + 8, h + 8], (t, 2))
    z = rng.uniform(0.05, 0.95, (t, 3))
    if kind == "random":
        xy = v0[:, None] + rng.uniform(-30, 30, (t, 3, 2))
    elif kind == "subpixel":
        xy = v0[:, None] + rng.uniform(-0.6, 0.6, (t, 3, 2))
    elif kind == "slivers":
        xy = _slivers(rng, t, w, h)
    elif kind == "centres":       # every vertex on a pixel centre
        xy = (np.floor(v0)[:, None] + rng.integers(-6, 7, (t, 3, 2))) + 0.5
    elif kind == "samples":       # every vertex on an MSAA sample point
        off = np.asarray(tr.MSAA4_OFFSETS)[rng.integers(0, 4, (t, 3))]
        xy = (np.floor(v0)[:, None] + rng.integers(-3, 4, (t, 3, 2))
              + 0.5 + off)
    elif kind == "edges":         # vertices on tile and frame edges
        gx = np.concatenate([np.arange(0, w + 1, tr.TILE_W), [w]])
        gy = np.concatenate([np.arange(0, h + 1, tr.TILE_H), [h]])
        xy = np.stack([rng.choice(gx, (t, 3)), rng.choice(gy, (t, 3))], -1)
        xy = xy + rng.choice([0.0, 0.0, -0.5, 0.5, 0.375, -0.125], (t, 3, 2))
        xy[:, 1:] += rng.uniform(-20, 20, (t, 2, 2)) * (rng.random((t, 2, 1))
                                                         < 0.5)
    elif kind == "ties":          # small triangles, all at one depth
        xy = v0[:, None] + rng.uniform(-5, 5, (t, 3, 2))
        z = np.full((t, 3), 0.5)
    else:
        raise ValueError(kind)
    return xy.astype(np.float32), z.astype(np.float32)


def shuffle_within_tiles(rng, starts, counts, *per_entry):
    """Permute the entries of every tile (the same way in each tensor of
    `per_entry`)."""
    idx = torch.arange(per_entry[0].shape[0])
    for t in range(counts.shape[0]):
        a, n = int(starts[t]), int(counts[t])
        idx[a:a + n] = torch.as_tensor(rng.permutation(n)) + a
    return tuple(x[idx.to(x.device)] for x in per_entry)


def boxed_bins(kind, seed, t, w, h, n_attrs=0, n_inst=None, device="cpu",
               e_max=9, sample_extent=tr.MSAA4_EXTENT, tile_h=tr.TILE_H):
    """Bins of an adversarial set with their pixel boxes -> (sorted_rows,
    starts, counts, boxes), entries shuffled within their tiles. With
    n_inst, a crowd of that many sets over one topology (`_bin_crowd`, at
    most 6 tiles a triangle). `sample_extent` 0.375 for the MSAA raster
    (K4, K5b), 0 for the centre-sampled one and the depth rasters (K2,
    K5a, K1, K6). `tile_h`: the single binning's tile height (K6 also takes
    8)."""
    rng = np.random.default_rng(seed + 1000)
    if n_inst is None:
        xy, z = screen_triangles(kind, seed, t, w, h)
    else:
        sets = [screen_triangles(kind, seed + i, t, w, h)
                for i in range(n_inst)]
        xy, z = (np.stack([s[k] for s in sets]) for k in (0, 1))
    s = {k: v.to(device) for k, v in screen_setup(xy, z,
                                                   sample_extent).items()}
    attrs = None
    if n_attrs:
        lead = () if n_inst is None else (n_inst,)
        attrs = torch.zeros(lead + (3 * t, n_attrs), device=device)
        s["va"] = torch.as_tensor(
            rng.normal(size=lead + (t, 3, n_attrs)).astype(np.float32),
            device=device)
    rows = tr._setup_rows(s, torch.arange(t, device=device), attrs)
    boxes = tr._pixel_boxes(s, sample_extent)
    if n_inst is None:
        rows, starts, counts, _, boxes = tr._bin(s, rows, w, h, e_max, False,
                                                 tile_h, boxes=boxes)
    else:
        rows, starts, counts, _, boxes = tr._bin_crowd(s, rows, w, h, boxes)
    rows, boxes = shuffle_within_tiles(rng, starts.cpu(), counts.cpu(), rows,
                                       boxes)
    return rows, starts, counts, boxes
