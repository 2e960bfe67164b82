"""The port's Schur-ordering discovery (``core/ordering.py``) and solver
choice (``core/solver.py:_select_linear_solver``) against the JAX
package's on the cases of ``tests/test_ordering.py`` and
``tests/test_schur.py:480``: the same groups found, and the same
``linear_solver_type_used`` and ``preconditioner_type_used`` in the
Summary. float64 on the CPU."""

import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core import ordering as jordering
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JL
from skeres_tpu.core.types import PreconditionerType as JP
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import ordering
from skeres_tpu_torch.core.solver import _select_linear_solver
from skeres_tpu_torch.core.types import LinearSolverType as L
from skeres_tpu_torch.core.types import PreconditionerType as P
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers run side by side on a few cores: one thread each for
    the small problems here, or the workers' thread pools fight over the
    cores (a DENSE_QR case took minutes that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _solve_both(build, solver, precond="JACOBI", **kw):
    js = st.solve(JOptions(linear_solver_type=JL[solver], preconditioner_type=JP[precond], **kw),
                  build(st, jbal))
    ts = stt.solve(stt.SolverOptions(linear_solver_type=L[solver], preconditioner_type=P[precond],
                                     device="cpu", **kw), build(stt, tbal))
    assert ts.linear_solver_type_given.value == js.linear_solver_type_given.value == solver
    assert ts.linear_solver_type_used.value == js.linear_solver_type_used.value
    assert ts.preconditioner_type_used.value == js.preconditioner_type_used.value
    return js, ts


def _undeclared_bal(pkg, bal_mod):
    bal = bal_mod.synthetic_bal(num_cameras=5, num_points=40, observations_per_point=3)
    return bal_mod.build_bal_problem(bal, use_schur_ordering=False)[0]


def _coupled(pkg, bal_mod):
    """A residual on two blocks of one group: no independent set."""
    problem = pkg.Problem()
    xs = problem.add_parameter_block_array(np.zeros((6, 2)))

    def pair(params, data):
        a, b = params
        return a - b + 1.0

    problem.add_residual_blocks(pair, None, [(xs, np.arange(5)), (xs, np.arange(1, 6))])
    return problem


def _single_block(pkg, bal_mod):
    problem = pkg.Problem()
    x = problem.add_parameter_block([2.0, -1.0])
    if pkg is st:
        import jax.numpy as xp
    else:
        import torch as xp

    def resid(params, data):
        (p,) = params
        return xp.stack([p[0] - 1.0, p[1] + 3.0, p[0] + p[1]])

    problem.add_residual_block(resid, None, [x])
    return problem


def test_bal_points_discovered_as_independent():
    jprogram = _undeclared_bal(st, jbal).compile()
    tprogram = _undeclared_bal(stt, tbal).compile()
    assert ordering.independent_groups(tprogram) == jordering.independent_groups(jprogram) == [0, 1]
    # both groups are independent: the larger one (the points) is eliminated
    assert ordering.compute_schur_ordering(tprogram) == jordering.compute_schur_ordering(jprogram)
    assert tprogram.groups[ordering.compute_schur_ordering(tprogram)].num_blocks == 40
    gi = ordering.apply_schur_ordering(tprogram)
    assert [g.schur_group for g in tprogram.groups] == [1 if i != gi else 0 for i in range(2)]


def test_coupled_group_not_independent():
    jprogram, tprogram = _coupled(st, None).compile(), _coupled(stt, None).compile()
    assert ordering.independent_groups(tprogram) == jordering.independent_groups(jprogram) == []
    assert ordering.compute_schur_ordering(tprogram) is None
    assert ordering.apply_schur_ordering(tprogram) is None
    assert tprogram.groups[0].schur_group is None


@pytest.mark.parametrize("solver", ["ITERATIVE_SCHUR", "DENSE_SCHUR"])
def test_schur_solver_works_without_declared_ordering(solver):
    """A Schur solver with no declared group finds the points and does not
    downgrade (tests/test_ordering.py:27)."""
    js, ts = _solve_both(_undeclared_bal, solver, max_num_iterations=40)
    assert ts.linear_solver_type_used.value == solver
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-6, atol=1e-14)


def test_sparse_schur_routes_to_dense_schur_and_finds_its_group():
    """SPARSE_SCHUR becomes DENSE_SCHUR, declared group or not (the JAX
    package routes it before it looks for a group and raises on an
    undeclared one; with a declared group both solve alike)."""
    ts = stt.solve(stt.SolverOptions(linear_solver_type=L.SPARSE_SCHUR, device="cpu",
                                     max_num_iterations=40), _undeclared_bal(stt, tbal))
    assert ts.linear_solver_type_used == L.DENSE_SCHUR
    assert ts.termination_type.value == "CONVERGENCE" and ts.schur_complement_path == "dense-W"

    def declared(pkg, bal_mod):
        bal = bal_mod.synthetic_bal(num_cameras=5, num_points=40, observations_per_point=3)
        return bal_mod.build_bal_problem(bal)[0]

    js, ts2 = _solve_both(declared, "SPARSE_SCHUR", max_num_iterations=40)
    assert ts2.linear_solver_type_used == L.DENSE_SCHUR
    np.testing.assert_allclose(ts2.final_cost, js.final_cost, rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(ts.final_cost, ts2.final_cost, rtol=1e-6, atol=1e-14)


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_schur_request_without_structure_downgrades_to_dense_normal_cholesky(solver):
    js, ts = _solve_both(_coupled, solver, max_num_iterations=20)
    assert ts.linear_solver_type_used == L.DENSE_NORMAL_CHOLESKY
    assert ts.schur_complement_path == ""
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-8, atol=1e-20)


def test_cluster_jacobi_downgrades_without_structure():
    """tests/test_schur.py:480: CLUSTER_JACOBI asked on a single block with
    no Schur structure still solves, by DENSE_NORMAL_CHOLESKY."""
    js, ts = _solve_both(_single_block, "ITERATIVE_SCHUR", "CLUSTER_JACOBI", max_num_iterations=30)
    assert ts.linear_solver_type_used == L.DENSE_NORMAL_CHOLESKY
    assert ts.preconditioner_type_used == P.CLUSTER_JACOBI  # no Schur solver to downgrade it
    assert ts.final_cost < 1e-6 or ts.termination_type is not None
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-8, atol=1e-20)


def test_sparse_normal_cholesky_routes_to_cgnr():
    js, ts = _solve_both(_undeclared_bal, "SPARSE_NORMAL_CHOLESKY", max_num_iterations=5)
    assert ts.linear_solver_type_used == L.CGNR
    program = _undeclared_bal(stt, tbal).compile()
    options = stt.SolverOptions(linear_solver_type=L.SPARSE_NORMAL_CHOLESKY)
    assert _select_linear_solver(options, program) == L.CGNR
    assert all(g.schur_group is None for g in program.groups)  # no ordering was applied


@pytest.mark.parametrize("solver", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY", "CGNR"])
def test_plain_solvers_are_taken_as_given(solver):
    _, ts = _solve_both(_undeclared_bal, solver, max_num_iterations=3)
    assert ts.linear_solver_type_used == L[solver] and ts.schur_complement_path == ""


def test_subset_on_a_schur_solver_downgrades_to_jacobi():
    """SUBSET serves CGNR only (skeres_tpu/core/solver.py:150)."""

    def build(pkg, bal_mod):
        bal = bal_mod.synthetic_bal(num_cameras=5, num_points=40, observations_per_point=3)
        return bal_mod.build_bal_problem(bal)[0]

    for solver in ("ITERATIVE_SCHUR", "DENSE_SCHUR"):
        _, ts = _solve_both(build, solver, "SUBSET", max_num_iterations=3,
                            residual_blocks_for_subset_preconditioner=[0])
        assert ts.preconditioner_type_used == P.JACOBI
