"""raster_roofline_pct.play: the least time of the frame's raster work (`yardstick.raster_bound`,
counted from the frame's inputs) as a share (%) of the device time
launched under the program's `shadow` and `character` pass labels
(binning, setup, the rasters and their merges).

Read from the traced frames of a `play` cell (kernels layer); nothing is
returned for another kind of cell or where the trace holds nothing to read.
"""

KIND = "play"


def read(t):
    if t.kind != KIND or t.raster_bound_s is None or not _raster_s(t):
        return None
    return 100.0 * t.raster_bound_s / _raster_s(t)


def _raster_s(t):
    return sum(t.label_device_s.get(k, 0.0) for k in ("shadow", "character"))
