"""BENCHMARK.json against the contract's rules, and against the files the
harness finds by name."""
import json
import os
import re

import pytest

from portbench.harness import BENCH, ROOT, Cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    M = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in M["configs"]] + CELLS
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in M[group]}) == len(M[group])
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_command_and_paths_stay_inside_the_benchmark():
    assert M["paths"] == ["portbench"]
    for word in M["command"]:
        assert not word.startswith("/") and ".." not in word
    script = [w for w in M["command"] if w.endswith(".py")]
    assert script and all(w.startswith("portbench/") for w in script)
    assert all(os.path.exists(os.path.join(ROOT, w)) for w in script)


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]


def test_every_cell_has_its_traffic_and_limits_files():
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == \
        len(M["workloads"])


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer(name):
    cell = Cell(name)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()


def test_a_per_layer_metrics_moves_is_reported_where_it_is_listed():
    by_name = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        moved = by_name[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], \
                (m["name"], cell)


def test_every_per_layer_metric_has_its_reader_and_one_layer_name():
    layers = {}
    for m in M["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_whys_are_one_short_line():
    for x in M["workloads"] + M["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
        assert "\t" not in x["why"]
