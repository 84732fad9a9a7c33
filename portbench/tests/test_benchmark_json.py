"""``BENCHMARK.json`` keeps to the benchmark contract's forms, and every
name in it resolves to its files by name alone."""
import json
import re
from pathlib import Path

import pytest

from portbench import layout

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert layout.applies(moved, m["workloads"][0])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(cell):
    c = layout.cell(cell["name"])
    assert (c["config"], c["traffic"], c["chips"]) == (cell["config"], cell["traffic"], cell["chips"])
    cfg = layout.config(c["config"])
    assert cfg["name"] == c["config"] and cfg["tf32"] is False and cfg["precision"] == "f32"
    kind = layout.traffic(c["traffic"])["kind"]
    assert hasattr(layout.driver(kind), "run")
    for m in BENCH["per_layer"]:
        if layout.applies(m, cell["name"]):
            assert hasattr(layout.metric(m["name"]), "read")
    reported = [m for m in BENCH["end_to_end"] if layout.applies(m, cell["name"])]
    assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
    assert any(layout.applies(m, cell["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = REPO / config["file"]
    assert path.is_file() and config["file"].startswith(BENCH["paths"][0] + "/")
    assert config["reduced"] == [] and config["source"].startswith("https://")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
