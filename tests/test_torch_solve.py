"""The port's solve() end to end against ``skeres_tpu.solve`` for every
linear solver and preconditioner, the LM strategy recurrence, what the
port refuses, and that it imports neither jax nor skeres_tpu. float64 on
the CPU: per-iteration cost and radius to rtol 1e-8, final parameters to
rtol 1e-6, unless a test states another tolerance."""

import enum
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.core.types import PreconditionerType as JPreconditionerType
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.solver import TRACE_FILE
from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.models.reprojection import snavely_reprojection_error


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers run side by side on a few cores: one thread each for
    the small problems here, or the workers' thread pools fight over the
    cores (a DENSE_QR case took minutes that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _solve_both(bal, solver="DENSE_SCHUR", precond="JACOBI", **kw):
    jprob, jcams, jpts = jbal.build_bal_problem(bal)
    js = st.solve(JOptions(linear_solver_type=JLinearSolverType[solver],
                           preconditioner_type=JPreconditionerType[precond], **kw), jprob)
    tprob, tcams, tpts = tbal.build_bal_problem(bal)
    ts = stt.solve(SolverOptions(linear_solver_type=LinearSolverType[solver],
                                 preconditioner_type=PreconditionerType[precond], device="cpu",
                                 **kw), tprob)
    return (js, jcams.values, jpts.values), (ts, tcams.values, tpts.values)


@pytest.fixture(scope="module")
def bal16():
    return jbal.synthetic_bal(16, 500, 4)


def test_full_solve_matches_jax(bal16):
    """10 steps, full budget. Initial radius 1: every accept/reject decision
    is made on a cost change far above rounding (at the default radius the
    scene converges by step 6, after which the decisions and the radius
    recurrence compare rounding noise)."""
    (js, jc, jp), (ts, tc, tp) = _solve_both(
        bal16, max_num_iterations=10, run_full_iteration_budget=True,
        initial_trust_region_radius=1.0,
    )
    assert len(ts.iterations) == len(js.iterations) == 11
    for a, b in zip(ts.iterations, js.iterations):
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-8)
        np.testing.assert_allclose(a.gradient_max_norm, b.gradient_max_norm, rtol=1e-6)
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-8)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-9)
    assert ts.termination_type.value == js.termination_type.value == "NO_CONVERGENCE"
    assert "DENSE_SCHUR" in ts.full_report() and "dense-W" in ts.full_report()


def _replay_radius(summary, options):
    """The reference LM radius recurrence over the recorded accept/reject
    trajectory (as tests/test_lm_strategy.py)."""
    radius = options.initial_trust_region_radius
    decrease_factor = 2.0
    for it in summary.iterations[1:]:
        np.testing.assert_allclose(it.trust_region_radius, radius, rtol=1e-12)
        if not it.step_is_valid:
            radius = max(radius / decrease_factor, options.min_trust_region_radius)
            decrease_factor *= 2.0
        elif it.step_is_successful:
            q = it.relative_decrease
            radius = min(radius / max(1.0 / 3.0, 1.0 - (2.0 * q - 1.0) ** 3),
                         options.max_trust_region_radius)
            decrease_factor = 2.0
        else:
            radius = radius / decrease_factor
            decrease_factor *= 2.0


def test_default_radius_solve_costs_and_radius_recurrence(bal16):
    """Default options: the cost trajectory matches the JAX package, and
    the radius follows the reference recurrence through accepted and
    rejected steps."""
    kw = dict(max_num_iterations=10, run_full_iteration_budget=True)
    (js, _, _), (ts, _, _) = _solve_both(bal16, **kw)
    np.testing.assert_allclose(
        [it.cost for it in ts.iterations], [it.cost for it in js.iterations], rtol=1e-8
    )
    assert ts.num_unsuccessful_steps > 0 and ts.num_successful_steps > 0
    _replay_radius(ts, SolverOptions(**kw))


def test_converging_solve_stops_like_jax():
    bal = jbal.synthetic_bal(6, 60, 4)
    (js, jc, _), (ts, tc, _) = _solve_both(bal, max_num_iterations=30)
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    assert len(ts.iterations) == len(js.iterations)
    assert ts.message.split(":")[0] == js.message.split(":")[0]
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-8)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)


def test_lm_diagonal_clamping():
    """D = clamp(diag(J^T J), min, max) * mu — the exact formula."""
    diag = torch.tensor([0.0, 1e-20, 0.5, 7.0, 1e40], dtype=torch.float64)
    out = lm_diagonal(diag, mu=0.25, min_diagonal=1e-6, max_diagonal=1e32)
    np.testing.assert_array_equal(out.numpy(), np.clip(diag.numpy(), 1e-6, 1e32) * 0.25)


def test_min_lm_diagonal_affects_step():
    """A degenerate clamp bound changes the damped step (the clamp is live
    in the solve path), as tests/test_lm_strategy.py pins for the JAX
    package."""

    def first_step_norm(min_d):
        problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(4, 24, 3))
        s = stt.solve(SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=1, device="cpu",
            min_lm_diagonal=min_d, initial_trust_region_radius=1.0,
            run_full_iteration_budget=True,
        ), problem)
        return s.iterations[1].step_norm

    assert first_step_norm(1e6) < 0.1 * first_step_norm(1e-6)


@pytest.mark.parametrize(
    "option",
    [
        dict(mesh="obs"),
    ],
)
def test_mesh_that_is_not_a_1d_device_mesh_raises(option):
    """``SolverOptions.mesh`` takes a 1-D torch.distributed DeviceMesh
    (``parallel.make_obs_mesh``); anything else is a TypeError before the
    solve starts (tests/test_torch_mesh.py runs real meshes)."""
    bal = tbal.synthetic_bal(4, 24, 3)
    problem, _, _ = tbal.build_bal_problem(bal)
    options = SolverOptions(**{"linear_solver_type": LinearSolverType.DENSE_SCHUR, "device": "cpu",
                               **option})
    with pytest.raises(TypeError, match="1-D torch.distributed DeviceMesh"):
        stt.solve(options, problem)


def _by_name(options_cls, option):
    """``option`` with each enum given by its name turned into
    ``options_cls``'s own enum (the two packages have their own types)."""
    defaults = options_cls()
    return {k: type(getattr(defaults, k))[v] if isinstance(getattr(defaults, k), enum.Enum)
            else v for k, v in option.items()}


@pytest.mark.parametrize(
    "option",
    [
        dict(use_inner_iterations=True),
        dict(linear_solver_type="ITERATIVE_SCHUR", use_inner_iterations=True),
        dict(trust_region_strategy_type="DOGLEG"),
        dict(use_explicit_schur_complement=True, trust_region_strategy_type="DOGLEG",
             dogleg_type="SUBSPACE_DOGLEG"),
        dict(trust_region_minimizer_iterations_to_dump=[1]),
        dict(linear_solver_type="DENSE_QR", check_gradients=True),
        dict(minimizer_type="LINE_SEARCH"),
    ],
    ids=["inner iterations", "ITERATIVE_SCHUR inner iterations", "dogleg", "subspace dogleg",
         "dump", "check_gradients", "line search"],
)
def test_formerly_unported_options_match_jax(option, tmp_path):
    """The options the port raised on before (the seven cases that left
    test_unported_options_raise: five with the trust region's slices, the
    gradient check and the line-search minimizer with theirs): each runs,
    with the same trajectory as the JAX package's, costs to rtol 1e-8, on
    the scene of that test at initial radius 1 (at the default radius
    ITERATIVE_SCHUR's PCG counts part after three steps, with or without
    inner iterations); the dump writes its file."""
    bal = tbal.synthetic_bal(4, 24, 3)
    kw = {**dict(linear_solver_type="DENSE_SCHUR", max_num_iterations=5,
                 initial_trust_region_radius=1.0,
                 trust_region_problem_dump_directory=str(tmp_path)), **option}
    js = st.solve(JOptions(**_by_name(JOptions, kw)), jbal.build_bal_problem(bal)[0])
    ts = stt.solve(SolverOptions(device="cpu", **_by_name(SolverOptions, kw)),
                   tbal.build_bal_problem(bal)[0])
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
    assert ts.termination_type.value == js.termination_type.value
    if "trust_region_minimizer_iterations_to_dump" in option:
        assert (tmp_path / "lm_iteration_001.npz").exists()


# -- every linear solver through solve(), host loop --------------------------------

SOLVER_CASES = [
    ("DENSE_NORMAL_CHOLESKY", "JACOBI", {}, 1e-8),
    ("DENSE_NORMAL_CHOLESKY", "JACOBI", dict(use_mixed_precision_solves=True,
                                             max_num_refinement_iterations=2), 1e-8),
    ("DENSE_QR", "JACOBI", {}, 1e-8),
    # CGNR: PCG on the whole problem's normal equations, whose condition
    # number amplifies the rounding of its tens of steps a solve
    ("CGNR", "JACOBI", {}, 1e-5),
    ("ITERATIVE_SCHUR", "JACOBI", {}, 1e-8),
    ("ITERATIVE_SCHUR", "SCHUR_JACOBI", {}, 1e-8),
    ("ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION", {}, 1e-8),
    ("ITERATIVE_SCHUR", "CLUSTER_JACOBI", dict(cluster_jacobi_size=4), 1e-8),
    ("ITERATIVE_SCHUR", "CLUSTER_TRIDIAGONAL", dict(cluster_jacobi_size=4), 1e-8),
    ("ITERATIVE_SCHUR", "SCHUR_JACOBI", dict(use_explicit_schur_complement=True), 1e-8),
    ("DENSE_SCHUR", "JACOBI", dict(use_mixed_precision_solves=True,
                                   max_num_refinement_iterations=2), 1e-8),
]


def _held_steps(ts, js, knife_edge: bool) -> int:
    """The rows of the two trajectories held to each other: every row, or
    on CGNR's ``knife_edge`` those before the first step whose PCG count
    differs. CGNR iterates on the whole problem's normal equations, and on
    the 16-camera scene its residual test stops at iteration 49 or 50 of
    step 7 on a last-bit change of J: the port's Snavely batch takes the
    closed-form Jacobian (ops/reprojection.py), which parts from the JAX
    package's autodiff in the last bits. There the counts may differ by
    one, and the steps after it are held to the same decisions alone."""
    n = len(ts.iterations)
    if not knife_edge:
        return n
    return next((k for k, (a, b) in enumerate(zip(ts.iterations, js.iterations))
                 if a.linear_solver_iterations != b.linear_solver_iterations), n)


def _assert_trajectory_matches(ts, tc, tp, js, jc, jp, rtol, knife_edge=False):
    """Decisions at every step; the held steps (``_held_steps``) at
    ``rtol``, and where every step is held the final cost and parameters.
    Returns the number of rows held."""
    held = _held_steps(ts, js, knife_edge)
    for a, b in zip(ts.iterations, js.iterations):
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
    for a, b in zip(ts.iterations[:held], js.iterations[:held]):
        assert a.linear_solver_iterations == b.linear_solver_iterations
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=rtol)
    if held < len(ts.iterations):  # the residual test's edge: one PCG step apart
        a, b = ts.iterations[held], js.iterations[held]
        assert abs(a.linear_solver_iterations - b.linear_solver_iterations) == 1
        return held
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=rtol)
    np.testing.assert_allclose(tc, jc, rtol=100 * rtol, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=100 * rtol, atol=1e-9)
    return held


@pytest.mark.parametrize("solver,precond,kw,rtol", SOLVER_CASES)
def test_trajectory_of_each_solver_matches_jax(bal16, solver, precond, kw, rtol):
    """8 steps at initial radius 1, the full budget (every accept/reject
    decision on a cost change far above rounding), on synthetic_bal(16,
    500, 4), the dense solvers on synthetic_bal(6, 60, 4) (they factor the
    whole problem's Jacobian, 234 columns there): the same decisions and
    PCG step counts (the Q test's and CGNR's residual test's own; none had
    to be pinned on this scene), costs and radii at ``rtol``, final
    parameters at 100 ``rtol``, and the Summary's solver, preconditioner
    and S path. CGNR is held so up to the step where its residual test
    stops one PCG step apart (``_held_steps``), at least its first 6;
    ``test_cgnr_on_autodiff_matches_jax_every_step`` holds every step on
    the JAX package's arithmetic."""
    bal = jbal.synthetic_bal(6, 60, 4) if solver.startswith("DENSE_") and "SCHUR" not in solver \
        else bal16
    (js, jc, jp), (ts, tc, tp) = _solve_both(
        bal, solver, precond, max_num_iterations=8, run_full_iteration_budget=True,
        initial_trust_region_radius=1.0, **kw)
    assert len(ts.iterations) == len(js.iterations) == 9
    assert ts.num_successful_steps > 0
    assert _assert_trajectory_matches(ts, tc, tp, js, jc, jp, rtol,
                                      knife_edge=solver == "CGNR") >= 7
    assert ts.linear_solver_type_used.value == js.linear_solver_type_used.value == solver
    assert ts.preconditioner_type_used.value == js.preconditioner_type_used.value == precond
    assert ts.schur_complement_path == js.schur_complement_path
    if solver == "ITERATIVE_SCHUR":
        assert ts.schur_complement_path == ("explicit" if kw.get("use_explicit_schur_complement")
                                            else "implicit")
        assert max(it.linear_solver_iterations for it in ts.iterations) > 1
        assert solver in ts.full_report() and ts.schur_complement_path in ts.full_report()


def test_cgnr_on_autodiff_matches_jax_every_step(bal16, monkeypatch):
    """The CGNR case of the test above with the Snavely batch on the port's
    vmapped autodiff (its batched form taken away), the JAX package's
    arithmetic: every step held, PCG counts, costs and radii at 1e-5, the
    final parameters at 1e-3."""
    monkeypatch.delattr(snavely_reprojection_error, "analytic")
    (js, jc, jp), (ts, tc, tp) = _solve_both(
        bal16, "CGNR", "JACOBI", max_num_iterations=8, run_full_iteration_budget=True,
        initial_trust_region_radius=1.0)
    assert len(ts.iterations) == len(js.iterations) == 9
    assert _assert_trajectory_matches(ts, tc, tp, js, jc, jp, 1e-5) == 9


def test_iterative_schur_past_the_explicit_gate_reports_the_gate(bal16):
    """``use_explicit_schur_complement`` with S past
    ``explicit_schur_limit_bytes``: the implicit product, and the Summary
    says why, as in the JAX package."""
    (js, _, _), (ts, _, _) = _solve_both(
        bal16, "ITERATIVE_SCHUR", "SCHUR_JACOBI", max_num_iterations=3,
        use_explicit_schur_complement=True, explicit_schur_limit_bytes=4096)
    assert ts.schur_complement_path == js.schur_complement_path
    assert ts.schur_complement_path.startswith("implicit (gate: S too large")
    np.testing.assert_allclose([it.cost for it in ts.iterations],
                               [it.cost for it in js.iterations], rtol=1e-8)


def test_device_defaults_to_the_card():
    assert SolverOptions().device == "cuda"


def test_default_solve_raises_without_a_card():
    """Default options ask for the card: with none, solve() raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default solve runs there")
    problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(4, 24, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR), problem)


def test_trace_dir_writes_a_minimizer_trace(tmp_path):
    """trace_dir: a torch.profiler (Chrome) trace of the minimizer."""
    problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(4, 24, 3))
    stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu",
                            max_num_iterations=2, trace_dir=str(tmp_path / "trace")), problem)
    trace = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])


def test_unported_problem_features_raise():
    bal = tbal.synthetic_bal(4, 24, 3)
    problem, cams, pts = tbal.build_bal_problem(bal, use_schur_ordering=False)
    # an undeclared elimination group is found now (core/ordering.py)
    s = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu",
                                max_num_iterations=2), problem)
    assert s.linear_solver_type_used == LinearSolverType.DENSE_SCHUR
    assert problem._groups[pts.group_index].schur_group == 0
    # two point slots in one row: the Schur solvers refuse it by name
    two = stt.Problem()
    a = two.add_parameter_block_array(np.ones((3, 2)))
    b = two.add_parameter_block_array(np.ones((5, 2)))
    two.set_schur_elimination_group(b, 0)
    two.add_residual_blocks(lambda p, d: p[0] + p[1] - p[2], None,
                            [(a, np.arange(3)), (b, np.arange(3)), (b, np.arange(1, 4))])
    with pytest.raises(NotImplementedError, match=">1 eliminated block"):
        stt.solve(SolverOptions(linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
                                device="cpu"), two)


def _bal_with(pkg, bal, feature):
    """synthetic BAL through either package's Problem API, with a feature
    that raised in the port before this slice: numeric differentiation of
    the Snavely residual, or a SubsetManifold holding f, k1 and k2."""
    if pkg == "jax":
        from skeres_tpu.models.manifolds import SubsetManifold
        from skeres_tpu.models.reprojection import snavely_reprojection_error as fn
        problem = st.Problem()
    else:
        from skeres_tpu_torch.models.manifolds import SubsetManifold
        from skeres_tpu_torch.models.reprojection import snavely_reprojection_error as fn
        problem = stt.Problem()
    cams = problem.add_parameter_block_array(bal.cameras, name="cameras")
    pts = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(pts, 0)
    problem.set_schur_elimination_group(cams, 1)
    if feature == "manifold":
        problem.set_manifold(cams, SubsetManifold(9, [6, 7, 8]))
    problem.add_residual_blocks(fn, None, [(cams, bal.camera_index), (pts, bal.point_index)],
                                data=bal.observations, numeric_diff=feature == "numeric_diff")
    return problem


@pytest.mark.parametrize("feature", ["numeric_diff", "manifold"])
def test_formerly_unported_problem_features_match_jax(feature):
    """The two cases that left test_unported_problem_features_raise:
    ``numeric_diff`` (central differences, costs to rtol 1e-7) and a
    non-Euclidean manifold (costs to rtol 1e-8) solve as the JAX package
    does, on synthetic_bal(4, 24, 3), 5 steps."""
    bal = jbal.synthetic_bal(4, 24, 3)
    kw = dict(max_num_iterations=5, run_full_iteration_budget=True)
    js = st.solve(JOptions(linear_solver_type=JLinearSolverType.DENSE_SCHUR, **kw),
                  _bal_with("jax", bal, feature))
    ts = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu",
                                 **kw), _bal_with("torch", bal, feature))
    rtol = 1e-7 if feature == "numeric_diff" else 1e-8
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol)
    if feature == "manifold":
        assert ts.num_effective_parameters == js.num_effective_parameters == 4 * 6 + 24 * 3


def test_write_back_and_report():
    bal = tbal.synthetic_bal(4, 24, 3)
    problem, cams, pts = tbal.build_bal_problem(bal)
    before = pts.values.copy()
    s = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=3, device="cpu"), problem)
    assert not np.array_equal(pts.values, before)
    assert s.final_cost < s.initial_cost
    report = s.full_report()
    assert "Termination:" in report and "float64" in report


def test_package_imports_neither_jax_nor_skeres_tpu():
    """In a fresh interpreter, with jax and skeres_tpu made unimportable,
    every module of the port, of examples_torch, every script of
    tools_torch (the measuring scripts among them) and chip_smoke.py still
    imports: the line search, GradientProblem, covariance, the gradient
    checker, the pose graphs, priors, MGH, interpolation, g2o, the NIST
    data, the CLIs and the native loader among them."""
    code = (
        "import sys, pkgutil, importlib, pathlib\n"
        "pre = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['skeres_tpu'] = None\n"
        "import skeres_tpu_torch, examples_torch\n"
        "for pkg in (skeres_tpu_torch, examples_torch):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        if not m.name.endswith('__main__'):\n"
        "            importlib.import_module(m.name)\n"
        "tools = sorted(p.stem for p in pathlib.Path('tools_torch').glob('*.py'))\n"
        "for m in tools:\n"
        "    importlib.import_module('tools_torch.' + m)\n"
        "assert {'bench_sphere', 'bench_two_signature', 'bench_scaling',\n"
        "        'bal_parse_time', 'trace_spans'} <= set(tools), tools\n"
        "assert 'bench' not in sys.modules, 'the JAX package\\'s bench.py was imported'\n"
        "import chip_smoke\n"
        "for m in ('core.line_search', 'core.gradient_problem', 'core.covariance',\n"
        "          'core.gradient_checker', 'models.pose_graph', 'models.priors',\n"
        "          'models.mgh', 'ops.interpolation', 'io.g2o', 'io.nist_strd',\n"
        "          'cli.bundle_adjuster', 'cli.pose_graph_2d', 'cli.pose_graph_3d',\n"
        "          'native', 'native.bal_native'):\n"
        "    assert sys.modules['skeres_tpu_torch.' + m], m\n"
        "for m in ('helloworld', 'curve_fitting', 'powell', 'rosenbrock', 'sampled_function',\n"
        "          'ellipse_approximation', 'robot_pose_mle', 'denoising',\n"
        "          'more_garbow_hillstrom', 'nist', 'bundle_adjuster', 'pose_graph_2d',\n"
        "          'pose_graph_3d'):\n"
        "    assert sys.modules['examples_torch.' + m], m\n"
        "new = set(sys.modules) - pre\n"
        "bad = [m for m in new if m.startswith(('jax', 'skeres_tpu.')) and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(pathlib.Path(__file__).resolve().parents[1]),
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_every_public_name_of_the_jax_package_resolves():
    """Each public name of ``skeres_tpu/__init__.py``, its eager imports
    (the losses and manifolds) and its lazy table (the callbacks among
    them), resolves in ``skeres_tpu_torch`` to the port's own object."""
    import skeres_tpu.__init__ as jinit

    table = [line.split('"')[1] for line in pathlib.Path(jinit.__file__).read_text().splitlines()
             if line.strip().startswith('"') and '": "skeres_tpu.' in line]
    eager = [n for n in dir(st) if not n.startswith("_") and n[0].isupper()]
    assert {"EvaluationCallback", "StateUpdatingCallback", "LoggingCallback"} <= set(table)
    assert {"HuberLoss", "QuaternionManifold"} <= set(eager)
    for name in table + eager:
        obj = getattr(stt, name)
        assert obj.__module__.startswith("skeres_tpu_torch."), name
        assert obj.__name__ == name


# -- the explicit-S path (K3) with K2's blocked factor ---------------------------


def test_explicit_path_solve_matches_jax(monkeypatch):
    """synthetic_bal(120, 2000, 4), 5 steps at initial radius 1: the port,
    with its dense-W gate at 0, takes the explicit S and factors its 1080
    rows with K2's panel loop; the JAX package takes dense W and its library
    Cholesky. Same accept/reject decisions, costs and radii to rtol 1e-8."""
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    (js, jc, jp), (ts, tc, tp) = _solve_both(
        jbal.synthetic_bal(120, 2000, 4), max_num_iterations=5,
        run_full_iteration_budget=True, initial_trust_region_radius=1.0,
    )
    assert ts.schur_complement_path == "explicit"
    assert js.schur_complement_path == "dense-W"
    assert len(ts.iterations) == len(js.iterations) == 6
    assert ts.num_successful_steps > 0
    for a, b in zip(ts.iterations, js.iterations):
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-8)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-9)
    assert "explicit" in ts.full_report()


def test_schur_path_is_dense_w_at_bal49_size():
    problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(49, 7776, 4))
    s = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=1, device="cpu"), problem)
    assert s.schur_complement_path == "dense-W"


@pytest.mark.parametrize(
    "limit,reason", [(0, "S too large"), (2 << 30, "point-degree skew too high")]
)
def test_rejected_explicit_plan_takes_column_probe_naming_the_reason(monkeypatch, limit, reason):
    """With dense W past its gate and the explicit plan rejected, the port
    takes the column probe, as the JAX package does there, and its path
    names the gate's reason (it raised here before the probe was ported).
    The trajectory equals the JAX package's (dense W, whose gate is not
    lowered there), 5 steps, costs to rtol 1e-8."""
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    bal = tbal.synthetic_bal(4, 24, 3)
    if "skew" in reason:  # one point seen 12 times, the others once
        keep = np.concatenate([np.arange(12), np.arange(12, 72, 3)])
        bal.camera_index = np.concatenate([np.arange(12) % 4, bal.camera_index[keep[12:]]])
        bal.point_index = np.concatenate([np.zeros(12, np.int32), bal.point_index[keep[12:]]])
        bal.observations = bal.observations[keep]
    (js, _, _), (ts, _, _) = _solve_both(bal, max_num_iterations=5, run_full_iteration_budget=True,
                                         explicit_schur_limit_bytes=limit)
    assert ts.schur_complement_path.startswith("column-probe (gate: ")
    assert reason in ts.schur_complement_path
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
