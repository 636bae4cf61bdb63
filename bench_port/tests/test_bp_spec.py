"""BENCHMARK.json and the files it names: the contract's shape, every
file present, every per-layer metric moving an end-to-end metric that
its cells report."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "bench_port/run.py"]
    assert spec["paths"] == ["bench_port"]
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_a_full_check_fits_its_time(spec):
    cells = 24
    need = ((2 + 14 * cells) * (spec["run_seconds"] + 60)
            + cells * 2 * 90 + 1200)
    assert need <= 43200


def test_names_units_and_keys(spec):
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in spec[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"])
            assert len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["name"] not in names
        names.add(e["name"])
    for e in spec["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in spec["end_to_end"]}
    for e in spec["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in e["layer"] and 1 <= len(e["layer"]) <= 200


def test_configs_and_cells_load(spec):
    import harness

    configs = {c["name"]: c for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in configs
        used.add(w["config"])
        cell = harness.cell_from_spec(spec, ROOT, w["name"])
        assert cell.limits, f"{w['name']}: no limits"
        assert cell.model["dtype"] in ("float32", "float64")
        conf = configs[w["config"]]
        assert conf["file"].startswith("bench_port/")
        assert sorted(cell.config["reduced"]) == sorted(conf["reduced"])
        assert cell.config["name"] == conf["name"]
    assert used == set(configs)
    assert len({(w["config"], w["traffic"])
                for w in spec["workloads"]}) == len(spec["workloads"])


def test_every_layer_metric_moves_a_reported_metric(spec):
    e2e = {e["name"]: e for e in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for w in cells:
        assert any(w in m["workloads"] for m in spec["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
