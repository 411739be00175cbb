"""``BENCHMARK.json`` and the files it names agree: names and units in
the allowed characters, every file there, each per-layer metric's reader
declaring what the entry says, every cell on one chip and reporting the
end-to-end metric each of its per-layer metrics moves."""
import json
import re
from pathlib import Path

import pytest

from benchlib import cell, check

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([m["name"] for m in METRICS] + CELLS
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        seen = [x["name"] for x in BENCH[group]]
        assert len(seen) == len(set(seen)), group
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_cells_and_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in configs and 1 <= len(w["why"]) <= 200
        c = cell.load(w["name"], ROOT)
        assert "loss" in c.spec["limits"]
        assert set(c.spec["limits"]) <= set(check.NUMBERS)
        assert c.spec["warmup_steps"] >= cell.COMPARED
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_and_what_it_moves(metric):
    mod = cell.metric_module(metric["name"])
    assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        metric["unit"], metric["layer"], metric["source"], metric["moves"])
    moved = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    for name in CELLS:
        if _reports(metric, name):
            assert _reports(moved, name), (metric["name"], name)
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for name in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, name)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, name) for m in BENCH["per_layer"])


def test_command_and_paths():
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1].startswith("bench/")
    assert len(json.dumps(BENCH)) < 64 * 1024
