"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import math
import re

import pytest

from port_bench.cells import HERE, ROOT, load_cell, manifest, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SPEC = manifest()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_sizes():
    assert set(SPEC) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51
    for kind, entries, lo, hi in (("config", "configs", 1, 24),
                                  ("workload", "workloads", 1, 24),
                                  ("end_to_end", "end_to_end", 1, 16),
                                  ("per_layer", "per_layer", 1, 128)):
        assert lo <= len(SPEC[entries]) <= hi
        names = [e["name"] for e in SPEC[entries]]
        assert len(set(names)) == len(names)
        for e in SPEC[entries]:
            extra = {"workloads"} if kind in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]


def test_check_fits_in_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"].startswith("port_bench/configs/")
    body = json.loads((ROOT / cfg["file"]).read_text(encoding="utf-8"))
    assert body["name"] == cfg["name"]
    assert cfg["source"].startswith("https://") and _line(cfg["source"])
    assert _line(cfg["why"]) and len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_resolves(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    cell = load_cell(name)
    assert (HERE / "kinds" / f"{cell.traffic['kind']}.py").is_file()
    assert "clock" in cell.limits and cell.limits["clock"] == 0.0
    assert all(v >= 0 and math.isfinite(v) for v in cell.limits.values())
    # setup_s, one more end-to-end metric and one per-layer metric a cell
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert _line(m["layer"])
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    assert m["moves"] in e2e
    for w in m.get("workloads", WORKLOADS):
        assert w in e2e[m["moves"]].get("workloads", WORKLOADS)
    if m["unit"] == "%" and m["name"].endswith("_roofline_pct"):
        assert m["better"] == "higher"
    assert callable(metric_reader(m["name"]))
    assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_layers_are_named_alike():
    # one name a layer, letter for letter: names that differ only in case
    # or spacing are one layer misspelt
    layers = {m["layer"] for m in SPEC["per_layer"]}
    folded = {" ".join(x.lower().split()) for x in layers}
    assert len(folded) == len(layers)


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_builds_its_app_config(cfg):
    from port_bench.reference.config import AppConfig
    from port_bench.scenes import REFERENCE, app_config
    body = json.loads((ROOT / cfg["file"]).read_text(encoding="utf-8"))
    app = app_config(REFERENCE, body)
    assert isinstance(app, AppConfig)
    for block, obj in (("render", app.render), ("physics", app.physics),
                       ("app", app)):
        for k, v in body.get(block, {}).items():
            assert getattr(obj, k) == pytest.approx(v), (block, k)


def test_unknown_settings_are_refused():
    from port_bench.scenes import REFERENCE, app_config
    for block in ("render", "physics", "app"):
        with pytest.raises(KeyError):
            app_config(REFERENCE, {block: {"no_such_setting": 1}})
    app = app_config(REFERENCE, {"render": {"show_edges": True,
                                            "clear_color": [0, 0, 0]},
                                 "app": {"sdef_true": True}})
    assert app.render.show_edges and app.sdef_true
    assert app.render.clear_color.dtype.kind == "f"


def test_generator_blocks_pass_every_key():
    from port_bench.inputs import generate, rng_of
    pm = generate({"generator": "sample.sample_character", "density": 0.3,
                   "n_parts": 3}, rng_of(1))
    assert len(pm.materials) == 3
    with pytest.raises(TypeError):
        generate({"generator": "sample.sample_character", "no_such_key": 1},
                 rng_of(1))
    a = generate({"generator": "sample.sample_motion", "length": 30,
                  "fps_keys": 5}, rng_of(7))
    b = generate({"generator": "sample.sample_motion", "length": 30,
                  "fps_keys": 5}, rng_of(7))
    c = generate({"generator": "sample.sample_motion", "length": 30,
                  "fps_keys": 5}, rng_of(8))
    assert a == b != c


def test_paths_hold_only_the_benchmark():
    names = [p.relative_to(ROOT).as_posix()
             for p in HERE.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    assert all(allowed.match(n) for n in names)
