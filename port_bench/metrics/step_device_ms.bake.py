"""step_device_ms.bake: device milliseconds a frame of the work the step's CUDA-graph launch
put on the card (every kernel, copy and fill whose correlation id is a
`cudaGraphLaunch`'s).

Read from the traced frames of a `bake` cell (step graph layer); nothing is
returned for another kind of cell or where the trace holds nothing to read.
"""

KIND = "bake"


def read(t):
    if t.kind != KIND or not t.graph_launches:
        return None
    return 1e3 * t.graph_device_s / t.frames
