"""BENCHMARK.json against the contract's shape, and every file the
harness finds by name."""

import json
import os
import re

import pytest

from portbench import harness, kernels

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# widths: sizes of hidden, intermediate, latent, state, projection or head
# vectors, expansion factors, experts per token
WIDTH_ENDINGS = ("_size", "_dim", "_rank", "_factor", "_per_tok")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_names_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        allowed = ENTRY_KEYS[section] | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[section] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        texts = [e[k] for k in ("why", "layer") if k in e] + ([e["source"]] if section == "configs" else [])
        for text in texts:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_sources_bounds_and_moves():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported, (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_each_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        cell = harness.resolve(SPEC, w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_layers_are_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_file_is_found_by_name(name):
    cell = harness.resolve(SPEC, name)
    assert cell.name == f"{cell.workload['config']}.{cell.workload['traffic']}"
    assert harness.module("builders", cell.config["builder"]).build
    assert harness.module("loops", cell.traffic["loop"]).Loop
    for m in cell.end_to_end:
        if m["name"] != "setup_s":
            assert callable(harness.reader("e2e", m["name"]))
    for m in cell.per_layer:
        assert callable(harness.reader("metrics", m["name"]))


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"] if m["name"].endswith("_roofline")])
def test_kernel_rooflines_declare_their_kernel(name):
    import importlib

    mod = harness.load_reader("metrics", name)
    assert kernels.declares_kernel(mod)
    module_name, attribute = mod.ENTRY.split(":")
    assert callable(getattr(importlib.import_module(module_name), attribute))


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configs_state_their_source_and_cuts(entry):
    assert entry["file"].startswith("portbench/configs/")
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(WIDTH_ENDINGS)
        assert cfg[key] != cfg["published"][key]
    assert sum(1 for e in SPEC["configs"] if e["file"] == entry["file"]) == 1
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


def test_four_chip_cells_within_a_quarter():
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
