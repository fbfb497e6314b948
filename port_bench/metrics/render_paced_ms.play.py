"""render_paced_ms.play: host milliseconds a frame in the program's
`render` span after its first `host_read.*` span returns, outside later
host reads: the render's host time spent after a wait for the card, while
the card waits for the host. A frame with no host read reads 0.

Read from the program's record of the traced frames of a `play` cell
(render layer); nothing is returned for another kind of cell or where the
program recorded nothing.
"""

from port_bench.yardstick.program import render_paced_ms

KIND = "play"


def read(t):
    if t.kind != KIND:
        return None
    return render_paced_ms(t)
