"""ccd_useful_pct.bake: the share (%) of the CCD chain-iterations that the
step graph's masked loop runs in which the chain was still active (the
program's counter `ccd_iterations`, summed on the card inside the graph),
both posing passes, over the traced frames.

Read from the program's record of the traced frames of a `bake` cell
(step graph layer); nothing is returned for another kind of cell or where
the program recorded nothing.
"""

from port_bench.yardstick.program import ccd_useful_pct

KIND = "bake"


def read(t):
    if t.kind != KIND:
        return None
    return ccd_useful_pct(t)
