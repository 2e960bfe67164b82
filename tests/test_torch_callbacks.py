"""The minimizer's hooks against the JAX package's: iteration callbacks
(``core/callbacks.py``), ``update_state_every_iteration``, the evaluation
callback, and checkpoint/resume (``utils/checkpoint.py``) across the two
packages. float64 on the CPU, synthetic_bal(16, 500, 4) at initial radius
1 (every decision made far above rounding): costs and radii to rtol 1e-8,
parameters to rtol 1e-6, as tests/test_torch_solve.py."""

import numpy as np
import pytest

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core import callbacks as jcb
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.io import bal as jbal
from skeres_tpu.utils import checkpoint as jck
from skeres_tpu_torch.core import callbacks as tcb
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.utils import checkpoint as tck

BASE = dict(initial_trust_region_radius=1.0)


@pytest.fixture(scope="module")
def bal16():
    return jbal.synthetic_bal(16, 500, 4)


def _jax(bal, make_callbacks=lambda problem, cams: [], **kw):
    problem, cams, pts = jbal.build_bal_problem(bal)
    opts = JOptions(linear_solver_type=JLinearSolverType.DENSE_SCHUR,
                    callbacks=make_callbacks(problem, cams), **BASE, **kw)
    return st.solve(opts, problem), cams, pts


def _port(bal, make_callbacks=lambda problem, cams: [], **kw):
    problem, cams, pts = tbal.build_bal_problem(bal)
    opts = stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu",
                             callbacks=make_callbacks(problem, cams), **BASE, **kw)
    return stt.solve(opts, problem), cams, pts


def _assert_rows_equal(a_rows, b_rows):
    assert len(a_rows) == len(b_rows)
    for a, b in zip(a_rows, b_rows):
        assert (a.iteration, a.step_is_valid, a.step_is_successful) == (
            b.iteration, b.step_is_valid, b.step_is_successful)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-8)


@pytest.mark.parametrize("successfully,want", [(True, "USER_SUCCESS"), (False, "USER_FAILURE")])
def test_abort_callbacks_stop_like_jax(bal16, successfully, want):
    js, _, _ = _jax(bal16, lambda p, c: [jcb.AbortAtIterationCallback(3, successfully)],
                    max_num_iterations=10)
    ts, _, _ = _port(bal16, lambda p, c: [tcb.AbortAtIterationCallback(3, successfully)],
                     max_num_iterations=10)
    assert ts.termination_type.value == js.termination_type.value == want
    assert ts.message == js.message
    assert len(ts.iterations) == len(js.iterations) == 4
    _assert_rows_equal(ts.iterations, js.iterations)


def test_history_callback_rows_match_jax(bal16):
    jh, th = jcb.HistoryCallback(), tcb.HistoryCallback()
    kw = dict(max_num_iterations=8, run_full_iteration_budget=True)
    js, _, _ = _jax(bal16, lambda p, c: [jh], **kw)
    ts, _, _ = _port(bal16, lambda p, c: [th], **kw)
    assert len(th.history) >= 2
    _assert_rows_equal(th.history, jh.history)
    assert [it.iteration for it in th.history] == [
        it.iteration for it in ts.iterations if it.step_is_valid]


@pytest.mark.parametrize("mode", ["option", "state_updating_callback"])
def test_state_written_back_every_step(bal16, mode):
    """With update_state_every_iteration (or a StateUpdatingCallback), the
    problem's camera array holds each step's iterate when the callbacks
    run: the JAX package's iterates, and the last one the solution."""
    kw = dict(max_num_iterations=6, run_full_iteration_budget=True)
    seen = {"jax": [], "port": []}

    def callbacks(key, module):
        def make(problem, cams):
            record = lambda it: seen[key].append(cams.values.copy())  # noqa: E731
            if mode == "option":
                return [record]
            return [module.StateUpdatingCallback(problem), record]
        return make

    if mode == "option":
        kw["update_state_every_iteration"] = True
    _jax(bal16, callbacks("jax", jcb), **kw)
    ts, tcams, _ = _port(bal16, callbacks("port", tcb), **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 7
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    accepted = [it.step_is_successful for it in ts.iterations[1:]]
    for k, acc in enumerate(accepted):
        assert acc == (not np.array_equal(seen["port"][k + 1], seen["port"][k]))
    np.testing.assert_array_equal(seen["port"][-1], tcams.values)


def test_evaluation_callback_fires_like_jax(bal16):
    class Recorder:
        def __init__(self):
            self.calls = []

        def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
            self.calls.append((evaluate_jacobians, new_evaluation_point))

    jr, tr = Recorder(), Recorder()
    kw = dict(max_num_iterations=5, run_full_iteration_budget=True)
    _jax(bal16, evaluation_callback=jr, **kw)
    _port(bal16, evaluation_callback=tr, **kw)
    assert tr.calls == jr.calls
    assert tr.calls[0] == (True, True) and (False, True) in tr.calls
    with pytest.raises(NotImplementedError):  # the protocol's base
        tcb.EvaluationCallback().prepare_for_evaluation(True, True)


def test_logging_callback_prints_the_jax_line(capsys):
    from skeres_tpu.core.summary import IterationSummary as JRow
    from skeres_tpu_torch.core.summary import IterationSummary as TRow

    fields = dict(iteration=3, cost=1.5, cost_change=0.25, gradient_max_norm=2e-3,
                  step_norm=0.5, relative_decrease=0.9, trust_region_radius=3e4,
                  linear_solver_iterations=2, iteration_time_in_seconds=0.01,
                  cumulative_time_in_seconds=0.1)
    jcb.LoggingCallback()(JRow(**fields))
    want = capsys.readouterr().out
    assert tcb.LoggingCallback()(TRow(**fields)).value == "SOLVER_CONTINUE"
    assert capsys.readouterr().out == want and want.startswith("   3: f: 1.500000e+00")


def _checkpoint_with(solve, bal, path):
    """Three steps, a checkpoint at every accepted one."""
    solve(bal, max_num_iterations=3, checkpoint_path=str(path), checkpoint_every_n_iterations=1,
          run_full_iteration_budget=True)
    return path


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(bal16, tmp_path, writer):
    """A checkpoint written by either package loads in both, and both
    resume from it (host loop and device loop) to the same trajectory."""
    path = _checkpoint_with(_jax if writer == "jax" else _port, bal16, tmp_path / "ck.npz")
    jg, jr, ji, jc = jck.load_checkpoint(str(path))
    tg, tr, ti, tc = tck.load_checkpoint(str(path))
    assert (tr, ti, tc) == (jr, ji, jc) and ti >= 1 and np.isfinite(tc)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a, b)
    kw = dict(max_num_iterations=5, resume_from=str(path), run_full_iteration_budget=True)
    for loop in ({}, dict(use_device_loop=True, device_loop_chunk_iterations=5)):
        js, jcams, _ = _jax(bal16, **kw, **loop)
        ts, tcams, _ = _port(bal16, **kw, **loop)
        np.testing.assert_allclose(ts.initial_cost, tc, rtol=1e-8)
        np.testing.assert_allclose(ts.iterations[1].trust_region_radius, tr, rtol=1e-12)
        _assert_rows_equal(ts.iterations[1:], js.iterations[1:])
        np.testing.assert_allclose(ts.iterations[0].cost, js.iterations[0].cost, rtol=1e-8)
        np.testing.assert_allclose(tcams.values, jcams.values, rtol=1e-6, atol=1e-9)


def test_checkpoint_files_of_the_two_packages_agree(bal16, tmp_path):
    """The same three steps checkpointed by each package: the same
    iteration and radius, values to rtol 1e-8, in the same layout."""
    jg, jr, ji, jc = tck.load_checkpoint(str(_checkpoint_with(_jax, bal16, tmp_path / "j.npz")))
    tg, tr, ti, tc = tck.load_checkpoint(str(_checkpoint_with(_port, bal16, tmp_path / "t.npz")))
    assert ti == ji and len(tg) == len(jg) == 2
    np.testing.assert_allclose([tr, tc], [jr, jc], rtol=1e-8)
    for a, b in zip(tg, jg):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    with np.load(str(tmp_path / "t.npz")) as zt, np.load(str(tmp_path / "j.npz")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
