"""BENCHMARK.json against the files the harness finds by name."""

import json
import os

import pytest

from gpubench import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert "setup_s" in E2E


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    conf = cells.config(entry["name"])
    assert entry["file"] == f"gpubench/configs/{entry['name']}.json"
    assert conf["reduced"] == entry["reduced"]
    assert conf["source"] == entry["source"]
    cells.mesh_generator(conf["mesh"]["generator"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(entry):
    cell = cells.cell(entry["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    cells.kind(cell["kind"])
    reported = set(cell["end_to_end"])
    assert "setup_s" in reported and len(reported) >= 2
    for name, unit in cell["end_to_end"].items():
        assert E2E[name]["unit"] == unit
        assert entry["name"] in E2E[name].get("workloads", [entry["name"]])
    assert cell["per_layer"]


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(entry):
    reader = cells.metric(entry["name"])
    assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.SOURCE,
            reader.MOVES, reader.WORKLOADS) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"],
        entry["moves"], entry["workloads"])
    for name in entry["workloads"]:
        cell = cells.cell(name)
        assert entry["name"] in cell["per_layer"]
        assert entry["moves"] in cell["end_to_end"]


def test_every_cell_metric_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    for w in BENCH["workloads"]:
        assert set(cells.cell(w["name"])["per_layer"]) <= listed


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        cells.cell("no.such.cell")
    with pytest.raises(FileNotFoundError):
        cells.metric("no_such_metric")
