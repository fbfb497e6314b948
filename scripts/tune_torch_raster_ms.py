"""K4's and K5b's time on the card against the wide-box threshold.

    python3 scripts/tune_torch_raster_ms.py [--wide 0,32,128,512,4096]

The MSAA tile body (`raster_tile_ms`, csrc/tiled_raster.cu) lets one thread
walk an entry's pixel box alone when the box holds at most
`tiled_raster.WIDE_BOX` pixels, and shares a wider box among the lanes of a
warp. This script measures that threshold: it captures the arguments K4
gets in frame 1 of the flagship scene (1920x1080, msaa=4 + shadow_window)
and K5b's in frame 1 of the 64-instance crowd at density 2.0 (256x144,
msaa=4), as `chip_smoke.py` does, holds each kernel against its brute-force
plain version once, and then times both kernels (CUDA events, 20 launches)
at every threshold of `--wide`, in two rounds so that drift shows. It also
prints how large the entries' clamped boxes are (the work the kernel does)
and times both kernels without boxes (every entry over its whole tile).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def box_sizes(args, boxes, crowd):
    """Pixels of every real entry's box clamped to its tile."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    starts, counts = args[1], args[2]
    width, height = args[4:6] if crowd else args[3:5]
    tiles_x, _, n_tiles = tr._grid(width, height)
    idx, tile = tr._tile_entries(starts, counts)
    tile = tile % n_tiles
    x0 = (tile % tiles_x) * tr.TILE_W
    y0 = (tile // tiles_x) * tr.TILE_H
    b = boxes[idx].long()
    w = (torch.minimum(b[:, 2], x0 + tr.TILE_W - 1)
         - torch.maximum(b[:, 0], x0) + 1).clamp(min=0)
    h = (torch.minimum(b[:, 3], y0 + tr.TILE_H - 1)
         - torch.maximum(b[:, 1], y0) + 1).clamp(min=0)
    return w * h


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wide", default="0,16,32,64,128,256,512,1024,4096")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_torch_raster_ms: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    print(cs.smi_name_power(), flush=True)
    scene = build_sample_scene(cs.DENSITY, cs.WIDTH, cs.HEIGHT, cs.SHADOW,
                               "cuda", **cs.MSAA_PATH)
    _, _, seen = cs.capture_frame(scene.step_and_render, scene.init_state(),
                                  cs.path_kernels(True))
    k4_args = seen["K4"][0]
    step, state = cs.build_crowd(cs.DENSITY, "crowd-dense")[True]
    _, _, seen = cs.capture_frame(step, state, cs.crowd_kernels(True))
    k5b_args = seen["K5b"][0]

    cases = (("K4", tr.raster_tiles_ms, tr.raster_tiles_ms_plain, k4_args,
              False),
             ("K5b", tr.raster_tiles_ms_multi, tr.raster_tiles_ms_multi_plain,
              k5b_args, True))
    for key, fn, plain, args, crowd in cases:
        got, want = fn(*args), plain(*args[:-1])
        bad = [int((got[i] != want[i]).sum()) for i in (0, 1, 2, 3, 5)]
        attr = float((got[4] - want[4]).abs().max())
        size = box_sizes(args, args[-1], crowd).float()
        q = torch.quantile(size, torch.tensor([0.5, 0.9, 0.99],
                                              device=size.device))
        print(f"{key}: mismatches {bad}, attr max err {attr:.3g}; "
              f"{size.numel()} entries, fullest tile {int(args[2].max())}; "
              f"clamped box pixels: sum {int(size.sum())}, mean "
              f"{float(size.mean()):.1f}, median {float(q[0]):.0f}, 90% "
              f"{float(q[1]):.0f}, 99% {float(q[2]):.0f}, max "
              f"{int(size.max())}", flush=True)
        if any(bad) or attr > 1e-6:
            raise AssertionError(f"{key} disagrees with its plain version")

    default = tr.WIDE_BOX
    try:
        for rnd in range(2):
            for wide in [int(v) for v in opts.wide.split(",")]:
                tr.WIDE_BOX = wide
                line = [f"round {rnd}, wide_box {wide}:"]
                for key, fn, _, args, _ in cases:
                    ms = cs.cuda_ms(lambda: fn(*args), 20)
                    line.append(f"{key} {ms:.4f} ms")
                print(" ".join(line), flush=True)
    finally:
        tr.WIDE_BOX = default
    for key, fn, _, args, _ in cases:
        print(f"{key} without boxes (every entry over its whole tile, "
              f"wide_box {default}): "
              f"{cs.cuda_ms(lambda: fn(*args[:-1]), 3):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
