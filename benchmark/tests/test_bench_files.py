"""BENCHMARK.json and the files the harness finds by name: every cell's
configuration, traffic mix and limits, every per-layer metric's reader,
and the contract's names, units and shapes."""

import ast
import json
import re

import pytest

import check
from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(names) == len(set(names))


def test_entries_have_only_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_cell_reports_what_it_must():
    """Every cell reports every metric (the harness reads no ``workloads``
    key), so set-up, another end-to-end metric and a per-layer one."""
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and SPEC["per_layer"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_files_found_by_name():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        body = json.loads(path.read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert {"model", "loss", "optim"} <= set(body)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"] and set(limits["limits"]) <= set(check.NUMBERS)
    for m in SPEC["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        tree = ast.parse(path.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)


def test_the_configurations_are_the_programs():
    """Each configuration file holds the program's preset as it is run."""
    import dataclasses

    from triad_tpu_torch.config import (OptimConfig, default_train_config,
                                        perf_train_loss_config, perf_train_model_config)

    def as_json(x):
        return json.loads(json.dumps(dataclasses.asdict(x)))

    perf = json.loads((BENCH / "configs" / "triad-base-perf.json").read_text())
    assert perf["model"] == as_json(perf_train_model_config())
    assert perf["loss"] == as_json(perf_train_loss_config())
    assert perf["optim"] == as_json(OptimConfig(gradient_accumulation_steps=1))
    d = default_train_config()
    default = json.loads((BENCH / "configs" / "triad-base-default.json").read_text())
    assert default["model"] == as_json(d.model)
    assert default["loss"] == as_json(d.loss)
    assert default["optim"] == as_json(d.train.optim)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cells_load(name):
    import harness

    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert cell.traffic["ring"] >= cell.traffic["check_micro_steps"]
