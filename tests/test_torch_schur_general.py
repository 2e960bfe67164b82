"""The general Schur structure in the port against the JAX package (the
cases of ``tests/test_schur_general.py``): several observation batches
(three batch signatures), several retained groups (on either side of the
eliminated one), rows with more than one retained slot, and the column-probe
S that DENSE_SCHUR takes there. float64 on the CPU: a damped step to atol
1e-8, every step's cost to rtol 1e-8, S and covariance blocks as each test
states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.covariance import Covariance as JCovariance
from skeres_tpu.core.covariance import CovarianceOptions as JCovarianceOptions
from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.minimizer import TrustRegionMinimizer as JMinimizer
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.schur import SchurSolver as JSchur
from skeres_tpu.core.summary import Summary as JSummary
from skeres_tpu.core.types import CovarianceAlgorithmType as JAlgorithm
from skeres_tpu.core.types import LinearSolverType as JL
from skeres_tpu.core.types import PreconditionerType as JP
from skeres_tpu_torch.core.covariance import Covariance, CovarianceOptions
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.summary import Summary
from skeres_tpu_torch.core.types import CovarianceAlgorithmType, LinearSolverType as L
from skeres_tpu_torch.core.types import PreconditionerType as P
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _general(pkg, between=False, seed=11, stereo=True, priors=False):
    """``tests/test_schur_general.py:_general_ba_problem`` in either package
    from the same numpy inputs: 3 poses (4), 3 intrinsics (2), 12 points
    (3, eliminated); batches mono (pose, intrinsics, point), stereo (pose,
    point) and a pose prior. With ``between`` the points are declared
    between the poses and the intrinsics; ``stereo=False`` leaves the stereo
    batch out, ``priors`` adds a prior on every point (a batch on the
    eliminated blocks alone) and on every intrinsics block. Returns (problem, poses, intrs, points)."""
    xp = jnp if pkg == "jax" else torch
    rng = np.random.default_rng(seed)
    n_pose, n_intr, n_pts = 3, 3, 12
    problem = (st if pkg == "jax" else stt).Problem()
    pose_v = rng.standard_normal((n_pose, 4)) * 0.5
    intr_v = 1.0 + 0.1 * rng.standard_normal((n_intr, 2))
    pt_v = rng.standard_normal((n_pts, 3))
    poses = problem.add_parameter_block_array(pose_v, name="poses")
    if between:
        pts = problem.add_parameter_block_array(pt_v, name="points")
        intrs = problem.add_parameter_block_array(intr_v, name="intrs")
    else:
        intrs = problem.add_parameter_block_array(intr_v, name="intrs")
        pts = problem.add_parameter_block_array(pt_v, name="points")
    problem.set_schur_elimination_group(pts, 0)
    problem.set_schur_elimination_group(poses, 1)
    problem.set_schur_elimination_group(intrs, 1)

    pose_idx = np.repeat(np.arange(n_pose), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_pose).astype(np.int32)
    mono_data = rng.standard_normal((len(pose_idx), 2))

    def mono(params, data):
        pose, intr, pt = params
        u = xp.tanh(pose[0] + 0.3 * pt[0]) * intr[0]
        v = (pose[2] + pose[3] * pt[2]) * intr[1]
        return xp.stack([u - data[0], v * 0.5 - data[1]])

    problem.add_residual_blocks(
        mono, None, [(poses, pose_idx), (intrs, pose_idx.copy()), (pts, pt_idx)],
        data=mono_data, name="mono")
    sel = rng.choice(len(pose_idx), size=14, replace=False)
    st_data = rng.standard_normal((len(sel), 3))

    def stereo_fn(params, data):
        pose, pt = params
        a = pose[0] * pt[0] + pose[1]
        b = pose[2] * pt[1] - pose[3] * pt[2]
        c = xp.sum(pose[:3] * pt)
        return xp.stack([a, b, c]) - data

    if stereo:
        problem.add_residual_blocks(stereo_fn, None, [(poses, pose_idx[sel]), (pts, pt_idx[sel])],
                                    data=st_data, name="stereo")
    prior_mu = rng.standard_normal((n_pose, 4)) * 0.1
    problem.add_residual_blocks(lambda params, data: 0.7 * (params[0] - data), None,
                                [(poses, np.arange(n_pose, dtype=np.int32))], data=prior_mu,
                                name="prior")
    if priors:
        problem.add_residual_blocks(lambda params, data: 0.5 * (params[0] - data), None,
                                    [(pts, np.arange(n_pts, dtype=np.int32))],
                                    data=np.zeros((n_pts, 3)), name="point_prior")
        problem.add_residual_blocks(lambda params, data: 0.5 * (params[0] - data), None,
                                    [(intrs, np.arange(n_intr, dtype=np.int32))],
                                    data=np.ones((n_intr, 2)), name="intrinsics_prior")
    return problem, poses, intrs, pts


def _three_slot(pkg):
    """A row with two retained slots of one group and one eliminated slot:
    r = a_i + a_j - b_k (the case the port refused before the column probe,
    beside test_torch_solve.py's two-eliminated-slot case, which both
    packages refuse)."""
    problem = (st if pkg == "jax" else stt).Problem()
    rng = np.random.default_rng(4)
    a = problem.add_parameter_block_array(rng.standard_normal((3, 2)))
    b = problem.add_parameter_block_array(rng.standard_normal((5, 2)))
    problem.set_schur_elimination_group(b, 0)
    problem.set_schur_elimination_group(a, 1)
    problem.add_residual_blocks(lambda p, d: p[0] * p[0] + p[1] - p[2] - d, None,
                                [(a, np.array([0, 1, 2, 0, 1])), (a, np.array([1, 2, 0, 2, 0])),
                                 (b, np.arange(5))], data=rng.standard_normal((5, 2)))
    problem.add_residual_blocks(lambda p, d: p[0] - d, None, [(b, np.arange(5))],
                                data=rng.standard_normal((5, 2)))
    return problem


@pytest.mark.parametrize("between", [False, True])
@pytest.mark.parametrize("iterative", [False, True])
def test_damped_step_matches_jax_and_dense(iterative, between):
    """One damped Schur solve at radius 3 (eta 1e-14): the port's step
    equals the float64 dense normal-equations solve and the JAX package's
    ``_solve_scaled`` to atol 1e-8, with the points declared after both
    retained groups or between them."""
    radius = 3.0
    tprob = _general("torch", between)[0]
    program = tprob.compile()
    ev = Evaluator(program, device="cpu", dtype=torch.float64)
    schur = SchurSolver(ev, iterative=iterative, eta=1e-14, max_cg_iterations=1000)
    assert len(schur.e_batches) == 2 and len(schur.ret_blocks) == 2 and schur.e_batch is None
    solver = L.ITERATIVE_SCHUR if iterative else L.DENSE_SCHUR
    tm = TrustRegionMinimizer(ev, SolverOptions(device="cpu"), Summary(), solver,
                              schur_solver=schur)
    state = program.initial_state("cpu", torch.float64)
    cost, g, diag, data, scale, _, _ = tm.linearize(state)
    _, blocks = ev.blocks(state)
    J = ev.jacobian_dense(blocks)[0].numpy() * scale.numpy()[None, :]
    diag_s = diag.numpy() * scale.numpy() ** 2
    lhs = J.T @ J + np.diag(np.clip(diag_s, 1e-6, 1e32) / radius)
    y_star = np.linalg.solve(lhs, -(g * scale).numpy())
    y, _, _ = tm._solve_damped(data, g * scale, torch.as_tensor(diag_s),
                               torch.tensor(radius, dtype=torch.float64),
                               torch.zeros((), dtype=torch.float64))
    np.testing.assert_allclose(y.numpy(), y_star, rtol=0, atol=1e-8)

    jprog = _general("jax", between)[0].compile()
    jev = JEvaluator(jprog)
    jschur = JSchur(jev, iterative=iterative, eta=1e-14, max_cg_iterations=1000)
    jm = JMinimizer(jev, JOptions(), JSummary(), JL[solver.name], schur_solver=jschur)
    _, jg, jdiag, jdata, jscale, _, _ = jm.linearize(jprog.initial_state(jev.dtype))
    jy, _, _ = jm._solve_scaled(jdata, jg * jscale, jnp.asarray(diag_s), jnp.asarray(radius),
                                jscale)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-8)


GENERAL_SOLVES = [
    ("DENSE_SCHUR", "JACOBI"),
    ("ITERATIVE_SCHUR", "JACOBI"),
    ("ITERATIVE_SCHUR", "SCHUR_JACOBI"),
    ("ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION"),
    ("ITERATIVE_SCHUR", "CLUSTER_JACOBI"),
    ("ITERATIVE_SCHUR", "CLUSTER_TRIDIAGONAL"),
    ("DENSE_NORMAL_CHOLESKY", "JACOBI"),
]


@pytest.mark.parametrize("solver,precond", GENERAL_SOLVES)
def test_full_solve_matches_jax(solver, precond):
    """30 steps (eta 1e-10) of every Schur solver and preconditioner on the
    three-signature problem: the same accept/reject decisions and every
    step's cost to rtol 1e-8, the same ``schur_complement_path``
    (DENSE_SCHUR: the column probe, gated by the structure). The cluster
    preconditioners have no plan on this structure and run SCHUR_JACOBI, in
    both packages."""
    kw = dict(max_num_iterations=30, eta=1e-10)
    js = st.solve(JOptions(linear_solver_type=JL[solver], preconditioner_type=JP[precond], **kw),
                  _general("jax")[0])
    ts = stt.solve(SolverOptions(linear_solver_type=L[solver], preconditioner_type=P[precond],
                                 device="cpu", **kw), _general("torch")[0])
    assert ts.schur_complement_path == js.schur_complement_path
    if solver == "DENSE_SCHUR":
        assert ts.schur_complement_path.startswith("column-probe (gate: structure:")
    assert len(ts.iterations) == len(js.iterations)
    assert ts.termination_type.name == js.termination_type.name
    assert ts.final_cost < ts.initial_cost
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)


@pytest.mark.parametrize("chunk", [5, 18, 128])
def test_column_probe_is_the_schur_complement(chunk, monkeypatch):
    """S by the column probe, k = 5 (which does not divide N_f = 18), 18
    and the default 128, equals the Schur complement of the damped dense
    J^T J taken in numpy, ``H_ff - H_fe H_ee^-1 H_ef``, to rtol 1e-10, on
    the layout with the points between the retained groups."""
    tprob = _general("torch", between=True)[0]
    program = tprob.compile()
    ev = Evaluator(program, device="cpu", dtype=torch.float64)
    monkeypatch.setattr(schur_mod, "PROBE_CHUNK", chunk)
    schur = SchurSolver(ev)
    assert schur.num_f == 18 and schur.schur_path.startswith("column-probe")
    _, blocks = ev.blocks(program.initial_state("cpu", torch.float64))
    d = torch.as_tensor(np.random.default_rng(2).uniform(0.1, 1.0, program.num_tangent))
    asm = schur._assemble(schur.prepare(schur.solver_data(blocks)),
                          torch.zeros_like(d), d)
    s = schur._dense_s(asm).numpy()
    J = ev.jacobian_dense(blocks)[0].numpy()
    H = J.T @ J + np.diag(d.numpy())
    f = schur.ret_index
    e = np.setdiff1d(np.arange(program.num_tangent), f)
    want = H[np.ix_(f, f)] - H[np.ix_(f, e)] @ np.linalg.solve(H[np.ix_(e, e)], H[np.ix_(e, f)])
    np.testing.assert_allclose(s, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(s, s.T)


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_eliminated_group_between_retained_groups(solver):
    """The retained coordinates are two spans around the eliminated one: a
    solve with the points declared between the poses and the intrinsics
    equals the solve with them last (costs to rtol 1e-10, the solution to
    rtol 1e-8)."""
    kw = dict(linear_solver_type=L[solver], preconditioner_type=P.SCHUR_JACOBI, device="cpu",
              max_num_iterations=30, eta=1e-10)
    (pa, *blocks_a), (pb, *blocks_b) = _general("torch"), _general("torch", between=True)
    sa, sb = stt.solve(SolverOptions(**kw), pa), stt.solve(SolverOptions(**kw), pb)
    np.testing.assert_allclose([i.cost for i in sb.iterations], [i.cost for i in sa.iterations],
                               rtol=1e-10)
    for x, y in zip(blocks_a, blocks_b):
        np.testing.assert_allclose(y.values, x.values, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_three_slot_row_solves_as_jax(solver):
    """Two retained slots of one group and one eliminated slot in a row:
    the Schur solvers take it (the column probe for DENSE_SCHUR) and match
    the JAX package step by step (rtol 1e-8), and DENSE_NORMAL_CHOLESKY's
    final cost (rtol 1e-8)."""
    kw = dict(max_num_iterations=20, eta=1e-12)
    js = st.solve(JOptions(linear_solver_type=JL[solver], **kw), _three_slot("jax"))
    ts = stt.solve(SolverOptions(linear_solver_type=L[solver], device="cpu", **kw),
                   _three_slot("torch"))
    tn = stt.solve(SolverOptions(linear_solver_type=L.DENSE_NORMAL_CHOLESKY, device="cpu", **kw),
                   _three_slot("torch"))
    assert ts.linear_solver_type_used == L[solver]
    assert ts.schur_complement_path == js.schur_complement_path
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
    np.testing.assert_allclose(ts.final_cost, tn.final_cost, rtol=1e-8)


def test_split_bal_equals_unsplit():
    """synthetic_bal(16, 500, 4) with each camera split into a pose (6) and
    intrinsics (3): the same least-squares problem with S's columns
    permuted, S by the column probe (144 rows) where the unsplit problem
    takes dense W. 10 DENSE_SCHUR steps at initial radius 1 (every decision
    far above rounding): the same decisions, costs to rtol 1e-8, and the
    solution to rtol 1e-6."""
    bal = tbal.synthetic_bal(16, 500, 4)
    kw = dict(linear_solver_type=L.DENSE_SCHUR, device="cpu", max_num_iterations=10,
              run_full_iteration_budget=True, initial_trust_region_radius=1.0)
    pu, cams, pts_u = tbal.build_bal_problem(bal)
    ps, poses, intrs, pts_s = tbal.build_split_bal_problem(bal)
    su, ss = stt.solve(SolverOptions(**kw), pu), stt.solve(SolverOptions(**kw), ps)
    assert su.schur_complement_path == "dense-W"
    assert ss.schur_complement_path.startswith("column-probe (gate: structure:")
    assert [i.step_is_successful for i in ss.iterations] == \
        [i.step_is_successful for i in su.iterations]
    np.testing.assert_allclose([i.cost for i in ss.iterations], [i.cost for i in su.iterations],
                               rtol=1e-8)
    np.testing.assert_allclose(np.concatenate([poses.values, intrs.values], 1), cams.values,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pts_s.values, pts_u.values, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("solver,precond", [("DENSE_SCHUR", "JACOBI"),
                                            ("ITERATIVE_SCHUR", "SCHUR_JACOBI"),
                                            ("ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION")])
def test_device_loop_matches_host_loop_and_jax(solver, precond):
    """``use_device_loop`` on the three-signature problem, 9 steps in
    chunks of 3 at initial radius 1, the full budget (the options of
    test_torch_device_loop.py, under which both packages' device loops
    take the host loop's decisions): the port's device loop against its
    host loop and the JAX package's device loop, the same decisions and
    costs to rtol 1e-8 (on the CPU the captured step runs eagerly)."""
    kw = dict(max_num_iterations=9, eta=1e-10, device_loop_chunk_iterations=3,
              initial_trust_region_radius=1.0, run_full_iteration_budget=True)
    topts = dict(linear_solver_type=L[solver], preconditioner_type=P[precond], device="cpu", **kw)
    sh = stt.solve(SolverOptions(**topts), _general("torch")[0])
    sd = stt.solve(SolverOptions(use_device_loop=True, **topts), _general("torch")[0])
    jd = st.solve(JOptions(linear_solver_type=JL[solver], preconditioner_type=JP[precond],
                           use_device_loop=True, **kw), _general("jax")[0])
    assert len(sd.iterations) == len(sh.iterations) == len(jd.iterations) == 10
    for a, h, j in zip(sd.iterations, sh.iterations, jd.iterations):
        assert a.step_is_successful == h.step_is_successful == j.step_is_successful
        np.testing.assert_allclose(a.cost, h.cost, rtol=1e-8)
        np.testing.assert_allclose(a.cost, j.cost, rtol=1e-8)


def test_covariance_matches_jax_and_dense_svd():
    """SCHUR_COMPLEMENT covariance on the three-signature problem with a
    prior on every point (without it a point seen only by mono rows has a
    singular C_p: its second coordinate enters no residual) and on the
    intrinsics (the scale shared by the intrinsics and the poses), at the JAX
    package's DENSE_SCHUR solution: S by the column probe; every block type
    (pose-pose, pose-intrinsics, intrinsics-point, point-point, same and
    distinct points) against the JAX package's SCHUR_COMPLEMENT and the
    port's DENSE_SVD to rtol 1e-8."""
    jp, jposes, jintrs, jpts = _general("jax", priors=True)
    st.solve(JOptions(linear_solver_type=JL.DENSE_SCHUR, max_num_iterations=50), jp)
    tp, tposes, tintrs, tpts = _general("torch", priors=True)
    for t, j in ((tposes, jposes), (tintrs, jintrs), (tpts, jpts)):
        t.values = np.asarray(j.values)
    js = JCovariance(JCovarianceOptions(algorithm_type=JAlgorithm.SCHUR_COMPLEMENT))
    ts = Covariance(CovarianceOptions(algorithm_type=CovarianceAlgorithmType.SCHUR_COMPLEMENT,
                                      device="cpu"))
    td = Covariance(CovarianceOptions(device="cpu"))
    assert js.compute(jp) and ts.compute(tp) and td.compute(tp)
    assert ts._schur.schur_path.startswith("column-probe")
    pairs = [((tposes, jposes), 0, (tposes, jposes), 2), ((tposes, jposes), 1, (tintrs, jintrs), 1),
             ((tintrs, jintrs), 2, (tpts, jpts), 5), ((tpts, jpts), 3, (tpts, jpts), 3),
             ((tpts, jpts), 0, (tpts, jpts), 11), ((tpts, jpts), 7, (tposes, jposes), 2)]
    for (ta, ja), i, (tb, jb), k in pairs:
        got = ts.get_covariance_block_in_tangent_space(ta[i], tb[k])
        want = js.get_covariance_block_in_tangent_space(ja[i], jb[k])
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12 * scale)
        np.testing.assert_allclose(got, td.get_covariance_block_in_tangent_space(ta[i], tb[k]),
                                   rtol=1e-8, atol=1e-12 * scale)


def test_schur_jacobi_blocks_are_the_diagonal_of_probe_s():
    """The general SCHUR_JACOBI blocks, one list entry per retained group:
    without the stereo batch no (retained block, point) pair has two rows,
    so they equal the diagonal blocks of S from the column probe (rtol
    1e-10); with it they sum the rows' products apart, as in the reference,
    and equal the JAX package's blocks on the same assembly (rtol 1e-10)."""
    tprob = _general("torch", stereo=False)[0]
    program = tprob.compile()
    ev = Evaluator(program, device="cpu", dtype=torch.float64)
    schur = SchurSolver(ev, iterative=True)
    _, blocks = ev.blocks(program.initial_state("cpu", torch.float64))
    d = lm_diagonal(torch.ones(program.num_tangent, dtype=torch.float64), 0.5, 1e-6, 1e32)
    asm = schur._assemble(schur.prepare(schur.solver_data(blocks)), torch.zeros_like(d), d)
    got = schur._schur_jacobi_blocks(asm)
    s = SchurSolver(ev)._dense_s(asm).numpy()
    assert [b.shape for b in got] == [(3, 4, 4), (3, 2, 2)]
    for (start, nb, t), blk in zip(schur.ret_blocks, got):
        for i in range(nb):
            r = slice(start + i * t, start + (i + 1) * t)
            np.testing.assert_allclose(blk[i].numpy(), s[r, r], rtol=1e-10,
                                       atol=1e-12 * np.abs(s).max())
    program = _general("torch")[0].compile()
    ev = Evaluator(program, device="cpu", dtype=torch.float64)
    schur = SchurSolver(ev, iterative=True)
    _, blocks = ev.blocks(program.initial_state("cpu", torch.float64))
    asm = schur._assemble(schur.prepare(schur.solver_data(blocks)), torch.zeros_like(d), d)
    got = schur._schur_jacobi_blocks(asm)
    jprog = _general("jax")[0].compile()
    jev = JEvaluator(jprog)
    jschur = JSchur(jev, iterative=True)
    _, jblocks = jev.blocks(jprog.initial_state(jev.dtype))
    jasm = jschur._assemble(jschur.prepare(jschur.solver_data(jblocks)),
                            jnp.zeros(jprog.num_tangent), jnp.asarray(d.numpy()))
    for a, b in zip(got, jschur._schur_jacobi_blocks(jasm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-14)
