"""render_host_reads.play: host reads of the card a frame in the render
(the program's counter `host_reads`, summed over its sites).

Read from the program's record of the traced frames of a `play` cell
(render layer); nothing is returned for another kind of cell or where the
program recorded nothing.
"""

from port_bench.yardstick.program import render_host_reads

KIND = "play"


def read(t):
    if t.kind != KIND:
        return None
    return render_host_reads(t)
