"""The control on the card: the plain reference in TF32 (the configuration
states float32 with TF32 off) put in the program's place fails the cell's
limits, while the program passes them, at each cell's own size on a short
window. Needs the card (`python -m pytest port_bench/tests -m cuda` there).
"""

from __future__ import annotations

import pytest

from port_bench import check, run
from port_bench.cells import load_cell, manifest

WORKLOADS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_and_program_passes(card, name):
    cell = load_cell(name)
    out = run.run_cell(cell, 2 ** 31 + 4242, 2.0, trace=False, device=card,
                       control=True)
    assert out["correct"]
    assert not check.within(out["_check"]["control"], cell.limits)
