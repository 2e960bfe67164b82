"""The program's own timing, as the benchmark reads it: the device loop's
stamped ``Summary`` timers through the existing readers, and the
program's ``skeres.*`` spans in a made-up profile, which name idle gaps
and add nothing to the device's busy time."""

import json
import os

import pytest

from benchmark.harness import ROOT, _selected, load_reader
from benchmark.tests.test_bench_trace import Event, _profile
from benchmark.trace import reduce_profile

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCHMARK = json.load(f)

CELL = "ladybug49.device-loop"


def _solve(linear_s, jacobian_s, residual_s, steps):
    """A device-loop solve's record as ``harness.timed_solve`` keeps it."""
    return dict(linear_solver_s=linear_s, jacobian_eval_s=jacobian_s, residual_eval_s=residual_s,
                linear_solves=steps, steps=steps)


@pytest.mark.parametrize("metric,want", [
    ("eval_ms_per_step.device_loop", 1e3 * (0.004 + 0.002 + 0.005 + 0.003) / 8),
    ("linear_solve_ms.device_loop", 1e3 * (0.010 + 0.012) / 8),
])
def test_device_loop_timers(metric, want):
    """The cell reports the metric, read by its base's reader off the
    stamped timers; a device loop that stamps nothing reads nothing."""
    _, per_layer = _selected(BENCHMARK, CELL)
    entry = next(m for m in per_layer if m["name"] == metric)
    assert entry["workloads"] == [CELL] and entry["moves"] == "lm_steps_per_s.ladybug49"
    reader = load_reader(metric)
    rec = {"solves": [_solve(0.010, 0.004, 0.002, 4), _solve(0.012, 0.005, 0.003, 4)]}
    assert reader.read(rec) == pytest.approx(want)
    assert reader.read({"solves": [_solve(0.0, 0.0, 0.0, 4)]}) is None


def test_program_spans_in_a_profile():
    """``skeres.*`` ranges are host operations of the function scope, with
    no device-side mirror: the busy time and the kernel entry's device time
    read as without them, and an idle gap is named by the innermost one."""
    ms = 1_000_000
    base = [
        Event("bench.solve", "CPU", 0, 100 * ms),
        Event("layer.schur_plan", "CPU", 0, 40 * ms),
        Event("layer.damped_solve", "CPU", 45 * ms, 45 * ms),
        Event("port.blocked_cholesky_factor#0", "CPU", 50 * ms, 10 * ms),
        Event("cudaLaunchKernel", "CPU", 51 * ms, ms // 10, corr=7),
        Event("syrk_lower_f64_kernel", "CUDA", 52 * ms, 20 * ms, corr=7),
    ]
    program = [
        Event("skeres.plan.schur", "CPU", 1 * ms, 38 * ms),
        Event("skeres.plan.pairs", "CPU", 2 * ms, 30 * ms),
        Event("skeres.schur.factor", "CPU", 49 * ms, 30 * ms),
    ]
    without, with_spans = reduce_profile(_profile(base)), reduce_profile(_profile(base + program))
    for key in ("window_s", "busy_s", "range_device_s", "span_busy", "device_ops"):
        assert with_spans[key] == without[key], key
    assert dict(without["idle_gaps"])["layer.schur_plan"] == pytest.approx(0.052)
    assert dict(with_spans["idle_gaps"])["skeres.plan.pairs"] == pytest.approx(0.052)
