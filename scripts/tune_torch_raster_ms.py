"""The boxed kernels' time on the card against the wide-box threshold and
the block size of their tile bodies.

    python3 scripts/tune_torch_raster_ms.py [--wide 0,32,128,512,4096]
        [--variants base,threads_512]

The boxed tile bodies (`raster_tile` for K2/K5a, `raster_tile_ms` for
K4/K5b, `depth_tile` for K1/K6/K5c, csrc/tiled_raster.cu) let one thread walk
an entry's pixel box alone when the box holds at most
`tiled_raster.WIDE_BOX` pixels, and share a wider box among the lanes of a
warp. This script measures that threshold and the
block size: it captures the arguments K1, K2, K6 and K4 get in frame 1 of
the flagship scene (1920x1080, shadow map 2048^2, msaa=1 and msaa=4 +
shadow_window) and K5c's, K5a's and K5b's in frame 1 of the 64-instance
crowd at density 2.0 (256x144, msaa=1 and msaa=4), as `chip_smoke.py` does,
holds
each kernel against its brute-force plain version once, and then times
them (20 launches back to back, `chip_smoke.primed_ms`) at every
threshold of `--wide`, in two rounds so that drift shows, once for each
build of `--variants` (variants of scripts/probe_torch_raster_ms.py, built
beside the library: `base` is the source as it is, `threads_512` the
raster bodies at 512 threads, `depth_cluster_1` the depth body without its
cluster split ...). It also prints how large the entries' clamped boxes are (the work the
kernels do) and times the kernels without boxes (every entry over its whole
tile).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

# the kernels whose frame size follows a leading argument (the crowd's
# instance count, K6's window)
SHIFTED = ("K5a", "K5b", "K5c", "K6")


def box_sizes(args, shifted):
    """Pixels of every real entry's box clamped to its tile."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    starts, counts, boxes = args[1], args[2], args[-1]
    width, height = args[4:6] if shifted else args[3:5]
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
    ap.add_argument("--variants", default="base,threads_512")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_torch_raster_ms: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import chip_smoke as cs
    import probe_torch_raster_ms as probe
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    print(cs.smi_name_power(), flush=True)
    plains = {"K1": tr.depth_tiles_plain, "K6": tr.depth_tiles_win_plain,
              "K2": tr.raster_tiles_plain, "K5a": tr.raster_tiles_multi_plain,
              "K4": tr.raster_tiles_ms_plain,
              "K5b": tr.raster_tiles_ms_multi_plain,
              "K5c": tr.depth_tiles_multi_plain}
    cases = probe.capture()
    for key, (fn, args) in cases.items():
        got = probe._planes(fn(*args))
        want = probe._planes(plains[key](*args[:-1]))
        bad = [int((got[i] != want[i]).sum()) for i in range(len(got))
               if i != 4]
        attr = float((got[4] - want[4]).abs().max()) if len(got) > 4 else 0.0
        size = box_sizes(args, key in SHIFTED).float()
        q = torch.quantile(size, torch.tensor([0.5, 0.9, 0.99],
                                              device=size.device))
        print(f"{key}: mismatches {bad}, attr max err {attr:.3g}; "
              f"{size.numel()} entries, fullest tile {int(args[2].max())}; "
              f"clamped box pixels: sum {int(size.sum())}, mean "
              f"{float(size.mean()):.1f}, median {float(q[0]):.0f}, 90% "
              f"{float(q[1]):.0f}, 99% {float(q[2]):.0f}, max "
              f"{int(size.max())}, over {tr.WIDE_BOX}: "
              f"{int((size > tr.WIDE_BOX).sum())}", flush=True)
        if any(bad) or attr > 1e-6:
            raise AssertionError(f"{key} disagrees with its plain version")

    variants = opts.variants.split(",")
    built = probe.build_variants(variants)
    default = tr.WIDE_BOX
    try:
        for rnd in range(2):
            for name in variants:
                with probe.use(built[name][0]):
                    for wide in [int(v) for v in opts.wide.split(",")]:
                        tr.WIDE_BOX = wide
                        line = [f"round {rnd}, {name}, wide_box {wide}:"]
                        for key, (fn, args) in cases.items():
                            ms = cs.primed_ms(lambda: fn(*args), 20)
                            line.append(f"{key} {ms:.4f} ms")
                        print(" ".join(line), flush=True)
    finally:
        tr.WIDE_BOX = default
    for key, (fn, args) in cases.items():
        print(f"{key} without boxes (every entry over its whole tile, "
              f"wide_box {default}): "
              f"{cs.primed_ms(lambda: fn(*args[:-1]), 3):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
