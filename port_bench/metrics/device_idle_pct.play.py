"""device_idle_pct.play: the share (%) of the traced window in which no kernel, copy or fill
ran on the card.

Read from the traced frames of a `play` cell (device layer); nothing is
returned for another kind of cell or where the trace holds nothing to read.
"""

KIND = "play"


def read(t):
    if t.kind != KIND or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
