"""The metric arithmetic: window statistics, the reduction of a trace on a
synthetic event list, and the raster bound counted from inputs."""

from __future__ import annotations

import pytest
import torch

from port_bench.cells import metric_reader
from port_bench.yardstick import raster_bound, stats
from port_bench.yardstick.peaks import PEAK_BYTES_PER_S, PEAK_FP32_PER_S
from port_bench.yardstick.trace import FRAMES, Event, summarize


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95.0) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95.0) == 3.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 50.0) == 2.5


def test_a_stall_shows_in_the_window_metrics():
    even = [0.1] * 200
    stalled = [0.1] * 189 + [1.0] * 11
    # the frame time is the window's time over all its frames
    assert stats.per_item_ms(sum(even), len(even)) == pytest.approx(100.0)
    assert stats.per_item_ms(sum(stalled), len(stalled)) == \
        pytest.approx(149.5)
    # eleven stalls in two hundred frames reach the 95th percentile
    assert 1e3 * stats.percentile(even, 95.0) == pytest.approx(100.0)
    assert 1e3 * stats.percentile(stalled, 95.0) > 500.0
    assert stats.per_second(64 * 20, 2.0) == 640.0


def _trace():
    """Two frames: a graph launch (two kernels), kernels launched inside
    the `shadow` and `character` labels and outside any, a copy."""
    host = [
        Event(FRAMES, 0, 1000, label=True),
        Event("bench.jit_step", 5, 990, label=True),
        Event("shadow", 100, 200, label=True),
        Event("character", 300, 420, label=True),
        Event("cudaGraphLaunch", 10, 12, corr=1),
        Event("cudaLaunchKernel", 150, 152, corr=2),
        Event("cudaLaunchKernel", 350, 352, corr=3),
        Event("cudaLaunchKernel", 500, 502, corr=4),
        Event("cudaMemcpyAsync", 600, 602, corr=5),
        Event("aten::nonzero", 560, 690),
        Event("cudaLaunchKernel", 1500, 1502, corr=6),  # after the window
    ]
    device = [
        Event("graph_kernel_a", 20, 120, corr=1),
        Event("graph_kernel_b", 130, 230, corr=1),
        Event("raster_depth", 240, 260, corr=2),
        Event("raster_tile", 400, 450, corr=3),
        Event("other", 460, 470, corr=4),
        Event("Memcpy DtoH (Device -> Pageable)", 700, 720, corr=5),
        Event("late", 1600, 1700, corr=6),
    ]
    return summarize(host, device, "play", frames=2)


def test_trace_reduction_by_correlation_and_label():
    s = _trace()
    assert s.window_s == pytest.approx(1000e-9)
    assert s.graph_launches == 1 and s.graph_kernels == 2
    assert s.graph_device_s == pytest.approx(200e-9)
    assert s.other_device_s == pytest.approx(100e-9)
    assert s.other_launches == 4
    assert s.label_device_s == pytest.approx({"shadow": 20e-9,
                                              "character": 50e-9})
    assert s.busy_s == pytest.approx(300e-9)
    assert s.unmatched == 0
    assert s.device_ops[0][1] == pytest.approx(100e-9)
    # the longest gap is the end of the window, then the one under the
    # host's nonzero (its middle at 585 ns lies inside it)
    assert s.idle_gaps[0][1] == pytest.approx(280e-9)
    assert s.idle_gaps[1] == ["bench.jit_step/aten::nonzero",
                              pytest.approx(230e-9)]


def test_readers_on_the_synthetic_trace():
    s = _trace()
    s.raster_bound_s = 7e-9
    assert metric_reader("step_device_ms.play")(s) == pytest.approx(1e-4)
    assert metric_reader("render_launches.play")(s) == 2.0
    assert metric_reader("render_device_ms.play")(s) == pytest.approx(5e-5)
    assert metric_reader("device_idle_pct.play")(s) == pytest.approx(70.0)
    assert metric_reader("raster_roofline_pct.play")(s) == pytest.approx(10.0)
    # another kind's readers find nothing to read
    assert metric_reader("step_device_ms.bake")(s) is None
    assert metric_reader("step_kernels.bake")(s) is None
    assert metric_reader("device_idle_pct.bake")(s) is None
    # a roofline with no bound or no raster time reads nothing, never 0
    s.raster_bound_s = None
    assert metric_reader("raster_roofline_pct.play")(s) is None


def test_box_work_counts_tiles_and_pixels():
    xy = torch.tensor([[[10.2, 5.3], [140.7, 20.0], [60.0, 40.1]],
                       [[0.1, 0.1], [0.2, 0.1], [0.1, 0.2]]])
    s = {"xy": xy, "valid": torch.tensor([True, True])}
    entries, pixels = raster_bound._box_work(s, 256, 64, 0.0)
    # columns 10..140, rows 5..39: 131 x 35 pixels over 2 x 2 tiles; the
    # second triangle covers no pixel centre
    assert (entries, pixels) == (4, 131 * 35)
    entries, pixels = raster_bound._box_work(s, 256, 64, 0.375)
    assert (entries, pixels) == (4 + 1, 131 * 35 + 1)


def test_frame_bound_from_a_tiny_scene():
    from port_bench.gen.sample import sample_character
    from port_bench.reference.config import RenderConfig
    from port_bench.reference.core.model import build_model

    static = build_model(sample_character(density=0.3))
    pos = torch.as_tensor(static.positions)
    tris = torch.as_tensor(static.triangles)
    for msaa in (1, 4):
        rcfg = RenderConfig(width=320, height=180, shadow_map_size=256,
                            msaa=msaa)
        b = raster_bound.frame_bound_s(pos, tris, rcfg, n_attrs=3)
        planes = 4 + 3 + (4 if msaa == 4 else 0)
        least_bytes = 4 * planes * 320 * 180
        assert b["character"] >= least_bytes / PEAK_BYTES_PER_S
        assert b["character"] >= 320 * 180 * (12 + 15) / PEAK_FP32_PER_S
        assert b["shadow"] >= 4 * 256 * 256 / PEAK_BYTES_PER_S
        assert b["character"] < 1e-3 and b["shadow"] < 1e-3
