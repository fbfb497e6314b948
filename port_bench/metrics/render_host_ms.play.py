"""render_host_ms.play: host milliseconds a frame in the program's `render`
span outside its `host_read.*` spans (the render's own host time, waits
left out).

Read from the program's record of the traced frames of a `play` cell
(render layer); nothing is returned for another kind of cell or where the
program recorded nothing.
"""

from port_bench.yardstick.program import render_host_ms

KIND = "play"


def read(t):
    if t.kind != KIND:
        return None
    return render_host_ms(t)
