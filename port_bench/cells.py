"""The cells of `BENCHMARK.json` and the files each names, found by name."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def manifest() -> dict:
    with open(MANIFEST, encoding="utf-8") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<cell>.json: number -> limit
    end_to_end: list        # the manifest's end-to-end metrics of this cell
    per_layer: list         # the manifest's per-layer metrics of this cell


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell `name` of the manifest (or of `spec`, a manifest's dict)."""
    spec = spec if spec is not None else manifest()
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(work))})")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(ROOT / cfg["file"]),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reported(m, name)])


def metric_reader(name: str):
    """The `read(trace)` function of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
