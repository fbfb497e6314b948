"""The manifest's cells cut to a size that a CPU test holds: the same
kinds, numbers and limits, on a small frame, a light character, small
textures and sky, and a short stretch."""

from __future__ import annotations

import copy

from port_bench.cells import load_cell


def tiny_cell(name: str):
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["render"].update(width=64, height=48, shadow_map_size=128,
                         cubemap_size=16)
    cfg["character"].update(density=0.3)
    cfg["textures"].update(sizes=[64, 32])
    cfg["sky"].update(height=32, width=64)
    traffic = dict(cell.traffic)
    if "block_frames" in traffic:
        traffic.update(block_frames=3)
    traffic.update(warmup_frames=min(traffic["warmup_frames"], 3),
                   sample_frames=3, trace_frames=2, stretch_frames=3)
    cell.config, cell.traffic = cfg, traffic
    return cell
