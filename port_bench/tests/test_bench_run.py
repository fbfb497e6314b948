"""A whole run of each cell rehearsed on the CPU at a tiny size: the
program's CPU path against the plain reference, the result's form, a run
without a card, and what the run's process and the benchmark's files
import."""

from __future__ import annotations

import ast
import json
import sys

import pytest
import torch

from port_bench import run
from port_bench.cells import HERE, manifest
from port_bench.tests.tiny import tiny_cell

WORKLOADS = [w["name"] for w in manifest()["workloads"]]
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def rehearsals():
    torch.set_num_threads(2)
    return {name: run.run_cell(tiny_cell(name), SEED, 0.5, trace=False,
                               device="cpu")
            for name in WORKLOADS}


@pytest.mark.parametrize("name", WORKLOADS)
def test_reference_agrees_with_the_programs_cpu_path(rehearsals, name):
    out = rehearsals[name]
    assert out["correct"] and out["failed"] == 0
    # the reference is the program's plain path frozen: on the CPU the two
    # give the same bits
    assert all(v == 0.0 for v in out["_check"]["numbers"].values())
    assert out["attempted"] >= 1


@pytest.mark.parametrize("name", WORKLOADS)
def test_result_form(rehearsals, name):
    out = dict(rehearsals[name])
    out.pop("_check")
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    cell = tiny_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(cell.limits)
    json.dumps(out)


def test_traced_rehearsal_reports_per_layer_metrics_only():
    cell = tiny_cell("play.ref_frame_720p")
    out = run.run_cell(cell, SEED + 1, 0.3, trace=True, device="cpu")
    assert out["correct"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= per_layer
    # no card: no graph launch and no device time, so the readers of the
    # step graph and the roofline find nothing to read
    assert "step_device_ms.play" not in out["metrics"]
    assert "raster_roofline_pct.play" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_fails_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.card_error(1) is not None


def _top(name: str) -> str:
    return name.split(".")[0]


def test_the_run_loads_no_jax(rehearsals):
    assert run.forbidden_modules() == []
    tops = {_top(m) for m in sys.modules}
    assert not tops & {"jax", "jaxlib", "flax", "simple_mmd_renderer_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "simple_mmd_renderer_tpu_torch.fake",
                        types.ModuleType("fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("fake"))
    assert run.forbidden_modules() == ["jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args:
            # import_module(f"{PROGRAM}.core.scene"): the literal text of the
            # name, with each {...} part read as the module constant it
            # names (PROGRAM, REFERENCE)
            yield _literal(node.args[0])


def _literal(arg) -> str:
    from port_bench import scenes
    if isinstance(arg, ast.Constant):
        return str(arg.value)
    if isinstance(arg, ast.JoinedStr):
        return "".join(
            str(v.value) if isinstance(v, ast.Constant)
            else getattr(scenes, getattr(v.value, "id", ""), "?")
            for v in arg.values)
    return "?"


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert _top(name) not in ("jax", "jaxlib", "flax",
                                      "simple_mmd_renderer_tpu"), (f, name)


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        for name in _imports(f):
            assert _top(name) in ("torch", "numpy", "dataclasses", "math",
                                  "struct", "typing", "types", "contextlib",
                                  "__future__", "bisect", "re", "os",
                                  "collections", "functools"), (f, name)
