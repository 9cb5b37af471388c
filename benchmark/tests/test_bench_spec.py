"""BENCHMARK.json against the contract's shape rules, and every name in it
against the folders the harness finds things in."""
import json
import re

import pytest

from benchmark import harness
from conftest import spec

ROOT = harness.ROOT
SPEC = spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def names():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        yield m["name"]
    for c in SPEC["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_use_legal_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert "\n" not in metric.get("layer", "") and "\t" not in metric.get(
        "layer", "")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (ROOT / "benchmark" / "metrics"
                / f"{metric['name']}.py").is_file()
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}


def test_top_level_and_limits():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in spec["paths"])
    assert len(spec["command"]) <= 32
    assert not any(a.startswith("/") or ".." in a for a in spec["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in SPEC[group]]
        assert len(seen) == len(set(seen)), group


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files_and_report_enough(cell):
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    _, config, traffic = harness.find_cell(SPEC, cell["name"])
    assert (ROOT / "benchmark" / "runners"
            / f"{traffic['runner']}.py").is_file()
    assert set(traffic["limits"])
    e2e, layer = harness.cell_metrics(SPEC, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer and all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_state_source_reduced_assumed(conf):
    f = ROOT / conf["file"]
    assert f.is_file() and conf["file"].startswith("benchmark/")
    data = json.loads(f.read_text())
    assert data["source"] == conf["source"]
    assert set(data["reduced"]) == set(conf["reduced"])
    assert all(k in data for k in conf["reduced"])
    assert data["assumed"]
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
