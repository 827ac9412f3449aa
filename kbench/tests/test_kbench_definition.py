"""BENCHMARK.json against the contract's shape, and the files its names
lead to."""

import json
import re

import pytest

from kbench import harness

SPEC = harness.Bench().spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "kbench/run.py"]
    assert SPEC["paths"] == ["kbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in SPEC[key]]
    assert len(set(names)) == len(names)
    for e in SPEC["workloads"]:
        for v in (e["name"], e["config"], e["traffic"]):
            assert NAME.match(v), v
        assert LINE.match(e["why"]) and e["chips"] in (1, 4)
    for e in SPEC["configs"]:
        assert NAME.match(e["name"]) and LINE.match(e["source"])
        assert LINE.match(e["why"]) and len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(e["name"]), e["name"]
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for word in SPEC["command"]:
        assert LINE.match(word)


def test_entries_have_just_the_contract_keys():
    for e in SPEC["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
    for e in SPEC["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
    for e in SPEC["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in SPEC["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(e["layer"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    bench = harness.Bench()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for cell in cells:
        e2e = {m["name"] for m in bench.metrics_for(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.metrics_for(cell, "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    bench = harness.Bench()
    w = bench.workload(cell)
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    mix = bench.traffic(w["traffic"])
    loop = bench.loop(mix["loop"])
    assert callable(loop.drive) and isinstance(loop.CHECK_CONTENTS, bool)
    assert loop.query_sets(mix)
    import kmerind_tpu_torch as kt
    assert callable(getattr(getattr(kt, cfg["index"]), loop.METHOD))
    assert isinstance(loop.TINY, dict) and set(loop.TINY) <= set(mix)
    judge = bench.judge(mix.get("judge", cfg["judge"]))
    assert all(callable(getattr(judge, f))
               for f in ("collect", "compare", "control"))
    assert bench.cell(cell).sets == loop.query_sets(mix)
    for e in SPEC["configs"]:
        assert e["file"].startswith("kbench/configs/")


@pytest.mark.parametrize("entry", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_reader_declares_what_the_entry_says(entry):
    mod = harness.Bench().metric(entry["name"])
    assert mod.SOURCE == entry["source"]
    assert callable(mod.read)
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])


def test_layers_of_one_name_are_spelled_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"io", "index.api", "ops.sortops", "kernels", "device",
                      "query"}
