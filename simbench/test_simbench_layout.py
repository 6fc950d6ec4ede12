"""The benchmark's files: BENCHMARK.json against the contract's shape, and
every cell, configuration, traffic mix and metric found by its name."""
import json
import re
from pathlib import Path

import pytest

from simbench import cell as C
from simbench.harness import metric_list, reader

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["simbench"]
    assert BENCH["command"] == ["python3", "simbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert {(w["config"], w["traffic"]) for w in BENCH["workloads"]} \
        .__len__() == len(BENCH["workloads"])


def test_end_to_end_bounds():
    by = {m["name"]: m for m in BENCH["end_to_end"]}
    assert by["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = C.find_cell(BENCH, name)
    assert cell.chips == 1
    assert set(cell.check["limits"]) == set(C.CHECKS)
    assert cell.traffic["n_clients"] >= 1
    cfg = next(c for c in BENCH["configs"] if c["name"] ==
               next(w["config"] for w in BENCH["workloads"]
                    if w["name"] == name))
    assert cfg["source"] == cell.config["source"]
    assert cfg["reduced"] == cell.config["reduced"]
    e2e = {m["name"] for m in metric_list(BENCH, name, False)}
    assert "setup_s" in e2e and e2e - {"setup_s"}
    assert metric_list(BENCH, name, True)


@pytest.mark.parametrize("name", CELLS)
def test_configuration_matches_the_program(name):
    C.check_sizes(C.find_cell(BENCH, name))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(reader(metric))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_an_end_to_end_metric(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]
    assert m["name"].split(".")[0] in {x.name[:-3] for x in
                                       (ROOT / "simbench" / "metrics").glob("*.py")}
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")


@pytest.mark.parametrize("extra", [{"no_such_field": 1},
                                   {"scenario": "churn-heavy"},
                                   {"reconfigure_every": 3},
                                   {"fault_mode": "deadline"}])
def test_traffic_keys_outside_the_reference_are_refused(extra):
    """A traffic file's key is a spec field or an error, and a spec field
    the reference does not model is refused rather than run unchecked."""
    cell = C.find_cell(BENCH, CELLS[0])
    cell.traffic.update(extra)
    with pytest.raises((ValueError, NotImplementedError)):
        C.spec_for(cell, 1, 10)


@pytest.mark.parametrize("name", CELLS)
def test_check_follows_the_first_eq7_round(name):
    cell = C.find_cell(BENCH, name)
    interval = cell.traffic["sfl"]["agg_interval"]
    assert C.checked_rounds(cell.traffic) == interval
