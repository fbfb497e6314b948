"""render_launches.play: host calls a frame that put work on the card outside the step's
graph launch (kernel launches of every kind, copies, fills).

Read from the traced frames of a `play` cell (render layer); nothing is
returned for another kind of cell or where the trace holds nothing to read.
"""

KIND = "play"


def read(t):
    if t.kind != KIND:
        return None
    return t.other_launches / t.frames
