"""deform_device_ms.bake: device milliseconds of the step graph's `deform` stage in a
replay, from the program's stage clock (`%globaltimer` stamps written
inside the graph at the stage's ends, `utils/profiling.StepClock`), over
the 64 replays just before the traced segment (the window's last; under
the profiler a replay runs at the traced host's pace).

Read in a traced run of a `bake` cell (step graph layer); nothing is
returned for another kind of cell or where the program recorded nothing.
"""

from port_bench.yardstick.program import stage_device_ms

KIND = "bake"


def read(t):
    if t.kind != KIND:
        return None
    return stage_device_ms(t, "deform")
