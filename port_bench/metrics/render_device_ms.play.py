"""render_device_ms.play: device milliseconds a frame of the work launched outside the step's
CUDA graph.

Read from the traced frames of a `play` cell (render layer); nothing is
returned for another kind of cell or where the trace holds nothing to read.
"""

KIND = "play"


def read(t):
    if t.kind != KIND:
        return None
    return 1e3 * t.other_device_s / t.frames
