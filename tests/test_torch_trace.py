"""The port's spans (``utils/trace.py``) and the device loop's stamps: no
range opened without a profiler; under ``torch.profiler`` the named spans
of a BA solve, nested as the code nests them, each under the
``skeres.solve`` of its solve with that solve's number; and the timers
the eager device loop fills from its stamps on the CPU."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import skeres_tpu_torch as stt
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.utils.trace import span


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread each: the test workers share a few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _solve(**kw):
    problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(6, 60, 3))
    return stt.solve(stt.SolverOptions(device="cpu", dtype=torch.float64, **kw), problem)


def test_no_profiler_no_range(monkeypatch):
    """Without a profiler every span is the one shared null context, and a
    solve opens no range."""
    assert span("skeres.a") is span("skeres.b", solve=3)
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *args: opened.append(args))
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    s = _solve(linear_solver_type=LinearSolverType.DENSE_SCHUR, jacobian_sort_threshold=1,
               jacobian_pad_waste=100)
    assert s.termination_type.value == "CONVERGENCE" and opened == []


# each span's nearest enclosing span, as the code nests them
PARENT = {
    "skeres.plan.compile": "skeres.solve",
    "skeres.plan.evaluator": "skeres.solve",
    "skeres.plan.schur": "skeres.solve",
    "skeres.plan.pairs": "skeres.plan.schur",
    "skeres.plan.pairs.metadata": "skeres.plan.pairs",
    "skeres.plan.pairs.sums": "skeres.plan.pairs",
    "skeres.plan.layout": "skeres.plan.schur",
    "skeres.minimize": "skeres.solve",
    "skeres.step.linearize": "skeres.minimize",
    "skeres.eval.chunk": "skeres.step.linearize",
    "skeres.schur.place": "skeres.step.linearize",
    "skeres.schur.prepare": "skeres.step.linearize",
    "skeres.schur.grid": "skeres.schur.prepare",
    "skeres.step.damped_solve": "skeres.minimize",
    "skeres.schur.s_build": "skeres.step.damped_solve",
    "skeres.schur.factor": "skeres.step.damped_solve",
    "skeres.schur.pcg": "skeres.step.damped_solve",
    "skeres.schur.s_product": "skeres.schur.pcg",
    "skeres.schur.back_substitute": "skeres.step.damped_solve",
    "skeres.step.candidate_cost": "skeres.minimize",
    "skeres.postprocess": "skeres.solve",
}
COMMON = {"skeres.solve", "skeres.plan.compile", "skeres.plan.evaluator", "skeres.plan.schur",
          "skeres.plan.layout", "skeres.minimize", "skeres.step.linearize", "skeres.eval.chunk",
          "skeres.schur.place", "skeres.schur.prepare", "skeres.step.damped_solve",
          "skeres.schur.back_substitute", "skeres.step.candidate_cost", "skeres.postprocess"}


@pytest.mark.parametrize("solver,want,blocks_in", [
    ("DENSE_SCHUR", {"skeres.plan.pairs", "skeres.plan.pairs.metadata", "skeres.plan.pairs.sums",
                     "skeres.schur.grid", "skeres.schur.s_build", "skeres.schur.factor",
                     "skeres.schur.blocks"}, "skeres.schur.s_build"),
    ("ITERATIVE_SCHUR", {"skeres.schur.pcg", "skeres.schur.s_product", "skeres.schur.blocks"},
     "skeres.schur.pcg"),
])
def test_spans_of_a_solve(monkeypatch, solver, want, blocks_in):
    """Two solves under one profiler (DENSE_SCHUR on the explicit S; both on
    the camera-padded layout): every span of the path, inside the
    ``skeres.solve`` of its own solve, whose numbers follow each other. The
    camera blocks (``skeres.schur.blocks``) lie in the explicit S's build or
    in PCG, where SCHUR_JACOBI reads them."""
    parent = {**PARENT, "skeres.schur.blocks": blocks_in}
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    kw = dict(linear_solver_type=LinearSolverType[solver],
              preconditioner_type=PreconditionerType.SCHUR_JACOBI,
              jacobian_sort_threshold=1, jacobian_pad_waste=100)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            _solve(**kw)
    spans = [e for e in prof.events() if e.name.startswith("skeres.")]
    assert {e.name for e in spans} == COMMON | want

    def enclosing(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith("skeres."):
            e = e.cpu_parent
        return e

    roots = [e for e in spans if e.name == "skeres.solve"]
    numbers = [e.kwinputs["solve"] for e in roots]
    assert len(roots) == 2 and enclosing(roots[0]) is None and numbers[1] == numbers[0] + 1
    for e in spans:
        if e.name == "skeres.solve":
            continue
        assert enclosing(e).name == parent[e.name], e.name
        root = e
        while root.name != "skeres.solve":
            root = enclosing(root)
        assert root in roots
    # each solve's own plans and steps
    for root in roots:
        inside = [e for e in spans if root.time_range.start <= e.time_range.start
                  and e.time_range.end <= root.time_range.end and e is not root]
        assert {e.name for e in inside} == (COMMON | want) - {"skeres.solve"}


@pytest.mark.parametrize("chunk,max_iterations,full_budget", [(2, 50, False), (4, 7, True)])
def test_device_loop_times_its_steps(chunk, max_iterations, full_budget):
    """The eager device loop stamps each step's phases: the linear-solver
    and evaluation timers above 0, each iteration's times, cumulative
    times that increase, and one replay counted for each of a chunk's
    ``limit``."""
    s = _solve(linear_solver_type=LinearSolverType.DENSE_SCHUR, use_device_loop=True,
               device_loop_chunk_iterations=chunk, max_num_iterations=max_iterations,
               run_full_iteration_budget=full_budget)
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    assert s.num_linear_solves == steps >= 2
    assert min(s.linear_solver_time_in_seconds, s.residual_evaluation_time_in_seconds,
               s.jacobian_evaluation_time_in_seconds) > 0
    assert (s.linear_solver_time_in_seconds + s.residual_evaluation_time_in_seconds
            + s.jacobian_evaluation_time_in_seconds) <= s.minimizer_time_in_seconds
    its = s.iterations[1:]
    assert all(0 < it.step_solver_time_in_seconds < it.iteration_time_in_seconds for it in its)
    cumulative = [it.cumulative_time_in_seconds for it in s.iterations]
    assert all(b > a for a, b in zip(cumulative, cumulative[1:]))
    assert cumulative[-1] <= s.minimizer_time_in_seconds
    chunks = math.ceil(steps / chunk)
    assert s.num_device_loop_replays == sum(
        min(chunk, max_iterations - k * chunk) for k in range(chunks))


class _Event:
    """A kineto event as ``tools_torch/trace_spans.py:span_table`` reads it."""

    def __init__(self, name, device, start, length, corr=0, thread=1):
        self._v = (name, device, start, length, corr, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return type("DeviceType", (), {"name": self._v[1]})

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_span_table_counts_what_a_span_launched():
    """A kernel counts to every span open at its launch on the launching
    thread, a copy of a span's range on the device counts to none, and a
    launch outside the span or on another thread adds nothing."""
    from tools_torch.trace_spans import span_table

    events = [
        _Event("skeres.step.damped_solve", "CPU", 100, 200),
        _Event("skeres.schur.factor", "CPU", 150, 50),
        _Event("cudaLaunchKernel", "CPU", 160, 5, corr=7),
        _Event("syrk_lower_f64_kernel", "CUDA", 400, 30, corr=7),
        _Event("skeres.schur.factor", "CUDA", 170, 500, corr=8),  # the range's copy
        _Event("cudaLaunchKernel", "CPU", 250, 5, corr=9),
        _Event("trsm_kernel", "CUDA", 600, 11, corr=9),
        _Event("cudaLaunchKernel", "CPU", 260, 5, corr=10, thread=2),
        _Event("other_thread_kernel", "CUDA", 700, 13, corr=10),
        _Event("cudaMemcpyAsync", "CPU", 320, 5, corr=11),
        _Event("Memcpy DtoH", "CUDA", 800, 17, corr=11),
    ]
    table = span_table(events)
    assert list(table) == ["skeres.step.damped_solve", "skeres.schur.factor"]
    assert table["skeres.schur.factor"] == pytest.approx(
        {"count": 1, "host_s": 50e-9, "device_s": 30e-9})
    assert table["skeres.step.damped_solve"] == pytest.approx(
        {"count": 1, "host_s": 200e-9, "device_s": 41e-9})


def test_trace_spans_tool_traces_a_whole_solve():
    """``tools_torch/trace_spans.py`` on the CPU: one solve's plans, capture
    and steps, each span inside ``skeres.solve``, and no device time."""
    from tools_torch import trace_spans

    out = trace_spans.run(trace_spans.parse_args(
        ["--device", "cpu", "--num_cameras", "6", "--num_points", "60", "--obs_per_point", "3",
         "--iters", "4", "--device_loop", "--device_loop_chunk", "2"]))
    spans = out["spans"]
    assert {"skeres.solve", "skeres.plan.compile", "skeres.plan.schur",
            "skeres.device_loop.capture", "skeres.minimize", "skeres.device_loop.chunk",
            "skeres.postprocess"} <= set(spans)
    assert next(iter(spans)) == "skeres.solve" and spans["skeres.solve"]["count"] == 1
    assert all(0 < row["host_s"] <= spans["skeres.solve"]["host_s"] and row["device_s"] == 0
               for row in spans.values())
    assert out["solve"]["device_loop_replays"] == 2 * spans["skeres.device_loop.chunk"]["count"]
    assert out["device"] == "cpu"
