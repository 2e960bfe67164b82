"""BENCHMARK.json and the files it names: every cell file parses into
valid SolverOptions, every metric has its reader, every configuration its
file, and the names keep to the benchmark's contract."""

import json
import math
import os
import re

import pytest

from benchmark.harness import BENCH, ROOT, _selected, load_cell, load_reader, solver_options

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCHMARK = json.load(f)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
# every cell file, those that BENCHMARK.json does not list yet included
CELL_FILES = sorted(n[: -len(".json")] for n in os.listdir(os.path.join(BENCH, "workloads")))
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELL_FILES)
def test_cell_options(cell):
    c = load_cell(cell)
    entry = next((w for w in BENCHMARK["workloads"] if w["name"] == cell), None)
    assert entry is None or (c["config"] == entry["config"] and entry["chips"] == 1)
    options = solver_options(c, "cpu", c["dtype"])
    assert options.is_valid()[0] and not options.run_full_iteration_budget
    assert (options.function_tolerance, options.gradient_tolerance,
            options.parameter_tolerance, options.max_num_iterations) == (1e-6, 1e-10, 1e-8, 50)
    assert c["warmup_max_num_iterations"] >= 1
    assert {"path_gap", "final_cost_gap"} <= set(c["checks"]) <= {"path_gap", "param_gap", "final_cost_gap"}
    assert all(0 < v < 1 and math.isfinite(v) for v in c["checks"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader(metric):
    reader = load_reader(metric)
    assert callable(reader.read)
    m = next(m for m in METRICS if m["name"] == metric)
    if "roofline" in metric:
        assert m["unit"] == "%" and m["source"] == "device_trace" and hasattr(reader, "ENTRY")


def test_contract():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"] and 1 <= BENCHMARK["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert {"solve_s", "lm_steps_per_s", "peak_mem_gib", "setup_s"} <= e2e
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCHMARK["configs"]]
    assert all(NAME.match(n) for n in names)
    for kind in (METRICS, BENCHMARK["workloads"], BENCHMARK["configs"]):
        assert len({x["name"] for x in kind}) == len(kind)
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCHMARK["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCHMARK["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["reduced"] == []
        assert c["file"].startswith("benchmark/configs/")
    assert {w["config"] for w in BENCHMARK["workloads"]} == {c["name"] for c in BENCHMARK["configs"]}
    assert len(json.dumps(BENCHMARK)) < 64 * 1024
    assert set(CELLS) <= set(CELL_FILES)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_metrics(cell):
    """Each cell reports set-up, another end-to-end metric and a per-layer
    one; each per-layer entry names its cells, and each of them reports
    the end-to-end metric it moves."""
    e2e, per_layer = _selected(BENCHMARK, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    assert any(n.split(".")[0] == "solve_s" for n in names)  # the time to a converged solve
    for m in per_layer:
        assert "workloads" in m and m["moves"] in names


def test_metric_files_are_read():
    """Every reader file is the reader of some metric: a per-cell name
    reuses its base's file, and no file is a copy kept for a name."""
    used = {load_reader(m["name"]).__file__ for m in METRICS}
    files = {os.path.join(BENCH, "metrics", n) for n in os.listdir(os.path.join(BENCH, "metrics"))
             if n.endswith(".py") and n != "__init__.py"}
    assert files == {os.path.abspath(u) for u in used}
