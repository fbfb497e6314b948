"""step_kernels.bake: device kernels a replay of the step's CUDA graph (copies and fills
not counted).

Read from the traced frames of a `bake` cell (step graph layer); nothing is
returned for another kind of cell or where the trace holds nothing to read.
"""

KIND = "bake"


def read(t):
    if t.kind != KIND or not t.graph_launches:
        return None
    return t.graph_kernels / t.graph_launches
