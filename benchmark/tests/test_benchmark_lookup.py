"""Cells, configurations, traffic, tasks, counts, references, metrics and
limits are found by name, and BENCHMARK.json keeps its form."""
import json
import os
import re

import pytest

from benchmark import lookup
from benchmark.tests import short

SPEC = lookup.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    path = os.path.join(lookup.CHECKOUT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_cells_in_order_one_chip_each():
    assert CELLS == ["wire300.denoise", "wire300.denoise_seeds4"]
    assert set(CELLS) <= set(short.CELLS)
    assert all(c["chips"] == 1 for c in SPEC["workloads"])
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_names_units_and_entry_keys():
    cfg_keys = {"name", "source", "file", "reduced", "why"}
    cell_keys = {"name", "config", "traffic", "chips", "why"}
    for c in SPEC["configs"]:
        assert set(c) == cfg_keys and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/configs/")
        assert c["reduced"] == []
    for c in SPEC["workloads"]:
        assert set(c) == cell_keys and NAME.match(c["name"])
        assert len(c["why"]) <= 200 and "\n" not in c["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] == "fit_coords_per_s"
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]


@pytest.mark.parametrize("cell", list(short.CELLS))
def test_cell_pieces_found_by_name(cell):
    """Every cell with files: those of BENCHMARK.json and those PERF.md
    keeps for later (their files stay, found the same way)."""
    entry = lookup.cell(short.spec(), cell)
    config = lookup.config(entry["config"])
    traffic = lookup.traffic(entry["traffic"])
    assert config["name"] == entry["config"]
    path = os.path.join(lookup.CHECKOUT, "benchmark", "configs",
                        entry["config"] + ".json")
    listed = [c["file"] for c in SPEC["configs"]
              if c["name"] == entry["config"]]
    assert listed in ([], [os.path.relpath(path, lookup.CHECKOUT)])
    with open(path) as f:
        assert json.load(f) == config
    task = lookup.module("tasks", traffic["task"])
    assert callable(task.fit) and callable(task.reference)
    assert callable(lookup.module("reference", config["family"]).apply)
    assert callable(lookup.module("counts", config["family"]).step)
    if "operator" in traffic:
        assert callable(lookup.module("reference", traffic["operator"]).radon)
        lookup.module("counts", traffic["operator"])
    limits = lookup.limits(cell)
    assert set(limits) == {"loss_gap", "grad_gap", "change_gap", "best_gap",
                           "rule"}
    assert all(limits[k]["lower"] < limits[k]["limit"] < limits[k]["upper"]
               for k in limits if k != "rule")
    for metric in (lookup.metrics_for(SPEC, cell, False)
                   + lookup.metrics_for(SPEC, cell, True)):
        assert callable(lookup.module("metrics", metric["name"]).read)


def test_configs_are_each_used_by_a_cell():
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_metrics_for_selects_by_trace_and_workloads():
    e2e = [m["name"] for m in lookup.metrics_for(SPEC, "wire300.denoise",
                                                 False)]
    assert e2e == ["fit_coords_per_s", "epoch_ms_p95", "setup_s"]
    for cell in CELLS:
        assert len(lookup.metrics_for(SPEC, cell, True)) == 6
    fourier = {"name": "operators.fourier_ms", "unit": "ms",
               "better": "lower", "source": "device_trace",
               "layer": "operators", "moves": "fit_coords_per_s",
               "workloads": ["wire300.ct"]}
    spec = dict(short.spec(), per_layer=SPEC["per_layer"] + [fourier])
    ct = [m["name"] for m in lookup.metrics_for(spec, "wire300.ct", True)]
    den = [m["name"] for m in lookup.metrics_for(spec, "wire300.denoise",
                                                 True)]
    assert ct[-1] == "operators.fourier_ms" and len(ct) == 7
    assert "operators.fourier_ms" not in den


def test_lookup_refuses_other_names():
    with pytest.raises(ValueError):
        lookup.traffic("../BENCHMARK")
    with pytest.raises(KeyError):
        lookup.cell(SPEC, "no.such.cell")
    with pytest.raises(FileNotFoundError):
        lookup.module("metrics", "no_such_metric")
