"""The port's Problem API against the JAX package's, float64 on the CPU:
constant blocks (with the Summary's reduced counts), manifolds in a solve
(a SubsetManifold on the BAL cameras on both S paths, quaternions),
bounds on both loops, numeric differentiation by all three methods,
block removal, ``Problem.evaluate`` and the trust-region dumps. Both
packages get the same declarations from the same numpy arrays
(:func:`_declare` calls one API, the same way, on either package's
problem)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import DumpFormatType as JDumpFormatType
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.io import bal as jbal
from skeres_tpu.models import manifolds as JM
from skeres_tpu.ops import rotation as jrot
from skeres_tpu.ops.loss import CauchyLoss as JCauchy
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import DumpFormatType, LinearSolverType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.models import manifolds as TM
from skeres_tpu_torch.ops import rotation as trot
from skeres_tpu_torch.ops.loss import CauchyLoss

PKG = {
    "jax": dict(st=st, M=JM, rot=jrot, xp=jnp, bal=jbal, Options=JOptions,
                Solver=JLinearSolverType, Dump=JDumpFormatType, Cauchy=JCauchy, kw={}),
    "torch": dict(st=stt, M=TM, rot=trot, xp=torch, bal=tbal, Options=SolverOptions,
                  Solver=LinearSolverType, Dump=DumpFormatType, Cauchy=CauchyLoss,
                  kw=dict(device="cpu")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bal16():
    return jbal.synthetic_bal(16, 500, 4)


def _options(pkg, solver="DENSE_SCHUR", **kw):
    p = PKG[pkg]
    if "trust_region_problem_dump_format_type" in kw:
        kw["trust_region_problem_dump_format_type"] = p["Dump"][
            kw["trust_region_problem_dump_format_type"]]
    return p["Options"](linear_solver_type=p["Solver"][solver], **kw, **p["kw"])


def _declare(pkg, problem, cams, pts, subset=False, constant=(), focal_bounds=None):
    """The same declarations on either package's BAL problem: a
    SubsetManifold on the cameras holding f, k1 and k2 (calibrated
    cameras); the cameras in ``constant`` held constant; each focal length
    bounded to ``focal_bounds`` = (lower, upper) factors of its value."""
    if subset:
        problem.set_manifold(cams, PKG[pkg]["M"].SubsetManifold(9, [6, 7, 8]))
    for i in constant:
        problem.set_parameter_block_constant(cams[i])
    if focal_bounds is not None:
        for i in range(len(cams)):
            f = float(cams.values[i, 6])
            problem.set_parameter_lower_bound(cams[i], 6, focal_bounds[0] * f)
            problem.set_parameter_upper_bound(cams[i], 6, focal_bounds[1] * f)


def _bal_both(bal, solver="DENSE_SCHUR", declare=None, **kw):
    out = {}
    for pkg in ("jax", "torch"):
        problem, cams, pts = PKG[pkg]["bal"].build_bal_problem(bal)
        _declare(pkg, problem, cams, pts, **(declare or {}))
        s = PKG[pkg]["st"].solve(_options(pkg, solver, **kw), problem)
        out[pkg] = (s, cams.values.copy(), pts.values.copy())
    return out["jax"], out["torch"]


def _same_trajectory(js, ts, rtol=1e-8):
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=rtol)
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=rtol)


STEPS = dict(max_num_iterations=6, run_full_iteration_budget=True, initial_trust_region_radius=1.0)


# -- constant blocks and manifolds in a solve ----------------------------------------


@pytest.mark.parametrize("path", ["dense-W", "explicit"])
@pytest.mark.parametrize("declare", [dict(constant=(0, 5)), dict(subset=True),
                                     dict(subset=True, constant=(0,))],
                         ids=["constant", "subset", "subset+gauge"])
def test_bal_declarations_match_jax(bal16, monkeypatch, path, declare):
    """synthetic_bal(16, 500, 4), DENSE_SCHUR, 6 steps: constant cameras
    (masked, not removed: S keeps their rows), a SubsetManifold on every
    camera (S of 16 x 6 rows), and both with camera 0 as the gauge, on the
    dense-W path and the explicit one (the port's gate at 0; the JAX
    package takes dense W). Costs and radii to rtol 1e-8, the final
    parameters to 1e-6, the constant cameras and the held intrinsics
    unchanged, the Summary's reduced counts equal."""
    if path == "explicit":
        monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    (js, jc, jp), (ts, tc, tp) = _bal_both(bal16, declare=declare, **STEPS)
    assert ts.schur_complement_path == path
    assert ts.num_successful_steps > 0
    _same_trajectory(js, ts)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-9)
    for i in declare.get("constant", ()):
        np.testing.assert_array_equal(tc[i], bal16.cameras[i])
    if declare.get("subset"):
        np.testing.assert_array_equal(tc[:, 6:], bal16.cameras[:, 6:])
    for name in ("num_parameter_blocks", "num_parameters", "num_effective_parameters",
                 "num_parameter_blocks_reduced", "num_parameters_reduced",
                 "num_effective_parameters_reduced", "num_residual_blocks_reduced"):
        assert getattr(ts, name) == getattr(js, name), name
    n_const = len(declare.get("constant", ()))
    assert ts.num_parameter_blocks_reduced == 16 + 500 - n_const


def test_all_blocks_constant_ends_like_jax(bal16):
    """Every block constant: the gradient is zero, and both packages stop
    at iteration 0 on the gradient tolerance."""
    out = {}
    for pkg in ("jax", "torch"):
        problem, cams, pts = PKG[pkg]["bal"].build_bal_problem(bal16)
        problem.set_parameter_block_array_constant(cams)
        problem.set_parameter_block_array_constant(pts)
        out[pkg] = PKG[pkg]["st"].solve(_options(pkg, max_num_iterations=5), problem)
    js, ts = out["jax"], out["torch"]
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    assert ts.message.split(":")[0] == js.message.split(":")[0]
    assert len(ts.iterations) == len(js.iterations) == 1
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-10)
    assert ts.num_parameter_blocks_reduced == js.num_parameter_blocks_reduced == 0


def _rotation_problem(pkg, manifold):
    """Fit one rotation to 20 point pairs: the quaternion (Ceres or Eigen
    order) or a planar angle, behind its manifold."""
    p = PKG[pkg]
    rng = np.random.default_rng(4)
    problem = p["st"].Problem()
    if manifold == "angle":
        pts = rng.normal(size=(20, 2))
        th = 0.7
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        obs = pts @ rot.T + 0.01 * rng.normal(size=(20, 2))
        x = problem.add_parameter_block_array(np.array([[-2.5]]), manifold=p["M"].AngleManifold())

        def res(params, data):
            a = params[0][0]
            c, s = p["xp"].cos(a), p["xp"].sin(a)
            return p["xp"].stack([c * data[0] - s * data[1] - data[2],
                                  s * data[0] + c * data[1] - data[3]])
    else:
        pts = rng.normal(size=(20, 3))
        aa = np.array([0.3, -0.5, 0.9])
        q_true = np.asarray(jrot.angle_axis_to_quaternion(jnp.asarray(aa)))
        obs = np.asarray(jrot.unit_quaternion_rotate_point(jnp.asarray(q_true)[None],
                                                           jnp.asarray(pts)))
        obs = obs + 0.01 * rng.normal(size=obs.shape)
        q0 = np.array([0.8, 0.2, -0.1, 0.4])
        q0 /= np.linalg.norm(q0)
        eigen = manifold == "eigen_quaternion"
        m = p["M"].EigenQuaternionManifold() if eigen else p["M"].QuaternionManifold()
        x = problem.add_parameter_block_array((np.roll(q0, -1) if eigen else q0)[None])
        problem.set_manifold(x, m)

        def res(params, data):
            q = params[0]
            if eigen:
                q = p["rot"].eigen_quaternion_to_ceres(q)
            return p["rot"].quaternion_rotate_point(q, data[:3]) - data[3:]

    problem.add_residual_blocks(res, None, [(x, np.zeros(20, dtype=np.int64))],
                                data=np.concatenate([pts, obs], axis=1))
    return problem, x


@pytest.mark.parametrize("manifold", ["quaternion", "eigen_quaternion", "angle"])
def test_rotation_fit_through_a_manifold_matches_jax(manifold):
    out = {}
    for pkg in ("jax", "torch"):
        problem, x = _rotation_problem(pkg, manifold)
        s = PKG[pkg]["st"].solve(_options(pkg, "DENSE_QR", max_num_iterations=20), problem)
        out[pkg] = (s, x.values.copy())
    (js, jx), (ts, tx) = out["jax"], out["torch"]
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    _same_trajectory(js, ts, rtol=1e-10)
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)
    if manifold != "angle":
        np.testing.assert_allclose(np.linalg.norm(tx), 1.0, rtol=1e-12)


# -- bounds ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_loop", [False, True], ids=["host loop", "device loop"])
def test_bal_bounds_match_jax(bal16, device_loop):
    """Every focal length bounded to [0.999, 1.001] of its value, 6 steps:
    the projected steps (and on the host loop the projected line search
    of the clipped ones), the projected gradient, costs to rtol 1e-8 on
    both loops; every focal length inside its bounds."""
    kw = dict(STEPS)
    if device_loop:  # whole chunks, as the JAX device loop runs them
        kw.update(use_device_loop=True, device_loop_chunk_iterations=3)
    (js, jc, jp), (ts, tc, tp) = _bal_both(bal16, declare=dict(focal_bounds=(0.999, 1.001)),
                                           **kw)
    _same_trajectory(js, ts)
    for a, b in zip(ts.iterations, js.iterations):
        np.testing.assert_allclose(a.gradient_max_norm, b.gradient_max_norm, rtol=1e-6)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    f0 = bal16.cameras[:, 6]
    assert np.all(tc[:, 6] >= 0.999 * f0 - 1e-12) and np.all(tc[:, 6] <= 1.001 * f0 + 1e-12)
    assert np.any(np.isclose(tc[:, 6], 0.999 * f0) | np.isclose(tc[:, 6], 1.001 * f0))


def test_active_bound_line_search_matches_jax():
    """One scalar pulled to 0 past a lower bound of 2 (the e2e bounds case)
    and a second, free one: the projected line search and the projected
    gradient converge at the bound in both packages alike."""
    out = {}
    for pkg in ("jax", "torch"):
        p = PKG[pkg]
        problem = p["st"].Problem()
        x = problem.add_parameter_block([5.0, -3.0])
        problem.set_parameter_lower_bound(x, 0, 2.0)
        problem.add_residual_block(lambda q, d: q[0] * p["xp"].stack([1.0 + 0 * q[0][0], 3.0
                                                                          + 0 * q[0][0]]),
                                   None, [x])
        s = p["st"].solve(_options(pkg, "DENSE_QR", max_num_iterations=60), problem)
        out[pkg] = (s, x.value.copy())
    (js, jx), (ts, tx) = out["jax"], out["torch"]
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    _same_trajectory(js, ts, rtol=1e-10)
    np.testing.assert_allclose(tx, jx, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tx[0], 2.0, atol=1e-6)


# -- numeric differentiation ----------------------------------------------------------


def _curve(pkg, method, per_block):
    p = PKG[pkg]
    rng = np.random.default_rng(1234)
    xs = np.linspace(0.0, 5.0, 67)
    ys = np.exp(0.3 * xs + 0.1) + rng.normal(0.0, 0.2, size=xs.shape)
    problem = p["st"].Problem()
    mc = problem.add_parameter_block([0.0, 0.0])

    def res(params, data):
        return data[1:2] - p["xp"].exp(params[0][0] * data[0] + params[0][1])

    data = np.stack([xs, ys], axis=1)
    kw = dict(numeric_diff=True, numeric_diff_method=method)
    if per_block:
        for row in data:
            problem.add_residual_block(res, p["Cauchy"](2.0), [mc], data=row, **kw)
    else:
        problem.add_residual_blocks(res, p["Cauchy"](2.0), [(mc.array, np.zeros(67, np.int64))],
                                    data=data, **kw)
    return problem, mc


@pytest.mark.parametrize("per_block", [False, True], ids=["bulk", "per block"])
@pytest.mark.parametrize("method", ["forward", "central", "ridders"])
def test_numeric_diff_matches_jax(method, per_block):
    """Robust curve fitting differentiated numerically, DENSE_QR: costs to
    rtol 1e-7 in every iteration, and the fit."""
    out = {}
    for pkg in ("jax", "torch"):
        problem, mc = _curve(pkg, method, per_block)
        s = PKG[pkg]["st"].solve(_options(pkg, "DENSE_QR", max_num_iterations=50), problem)
        out[pkg] = (s, mc.value.copy())
    (js, jx), (ts, tx) = out["jax"], out["torch"]
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-7)
    np.testing.assert_allclose(tx, jx, rtol=1e-6)


def test_numeric_diff_bad_method_raises():
    problem = stt.Problem()
    x = problem.add_parameter_block([1.0])
    problem.add_residual_block(lambda p, d: p[0] ** 2 - 4.0, None, [x], numeric_diff=True,
                               numeric_diff_method="sideways")
    with pytest.raises(ValueError, match="numeric_diff_method"):
        stt.solve(_options("torch", "DENSE_QR", max_num_iterations=2), problem)


# -- removal, subsets and evaluate ---------------------------------------------------


def _blocks_problem(pkg):
    """Five scalar blocks, a residual per block and one per neighbour pair,
    the pairs under a Cauchy loss."""
    p = PKG[pkg]
    problem = p["st"].Problem()
    xs = [problem.add_parameter_block([float(i + 5)]) for i in range(5)]

    def one(q, d):
        return q[0] - d

    def two(q, d):
        return 2.0 * (q[1] - q[0]) - d

    loss = p["Cauchy"](1.0)
    own = [problem.add_residual_block(one, None, [x], data=np.array([float(i)]))
           for i, x in enumerate(xs)]
    pair = [problem.add_residual_block(two, loss, [xs[i], xs[i + 1]], data=np.array([0.5]))
            for i in range(4)]
    return problem, xs, own, pair


def test_remove_and_evaluate_match_jax():
    """Remove a residual block and a parameter block (with its residuals),
    then evaluate the cost, residuals, gradient and dense Jacobian, a
    subset of blocks, and without the loss: the same values; then a solve
    of what is left, to rtol 1e-10."""
    ev = {}
    for pkg in ("jax", "torch"):
        problem, xs, own, pair = _blocks_problem(pkg)
        problem.remove_residual_block(own[1])
        with pytest.raises(KeyError):
            problem.remove_residual_block(own[1])
        problem.remove_parameter_block(xs[3])
        assert problem.is_parameter_block_constant(xs[3])
        assert not problem.is_parameter_block_constant(xs[2])
        assert problem._num_residual_blocks == 9 - 1 - 3
        kw = {} if pkg == "jax" else dict(device="cpu")
        with pytest.raises(KeyError):
            problem.evaluate(residual_blocks=[own[3]], **kw)
        ev[pkg] = dict(
            full=problem.evaluate(residuals=True, gradient=True, jacobian=True, **kw),
            cost=problem.evaluate(**kw),
            subset=problem.evaluate(residuals=True, gradient=True,
                                    residual_blocks=[own[0], pair[0], own[4]], **kw),
            raw=problem.evaluate(residual_blocks=[pair[0], pair[1]], apply_loss_function=False,
                                 **kw),
            raw_full=problem.evaluate(jacobian=True, apply_loss_function=False, **kw),
        )
        s = PKG[pkg]["st"].solve(_options(pkg, "DENSE_QR", max_num_iterations=20), problem)
        ev[pkg]["solve"] = (s, [x.value.copy() for x in xs])
    j, t = ev["jax"], ev["torch"]
    for key in ("full", "subset", "raw_full"):
        for field, val in j[key].items():
            np.testing.assert_allclose(t[key][field], val, rtol=1e-12, atol=1e-14,
                                       err_msg=f"{key} {field}")
    for key in ("cost", "raw"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-12)
    (js, jx), (ts, tx) = j["solve"], t["solve"]
    _same_trajectory(js, ts, rtol=1e-10)
    np.testing.assert_allclose(tx, jx, rtol=1e-9)
    assert tx[3][0] == 8.0  # removed: held where it was


def test_evaluate_on_the_card_by_default():
    problem, _, _, _ = _blocks_problem("torch")
    if torch.cuda.is_available():
        assert problem.evaluate() == problem.evaluate(device="cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            problem.evaluate()


def test_remove_all_blocks_of_a_batch_drops_it():
    problem, xs, own, pair = _blocks_problem("torch")
    for rid in pair:
        problem.remove_residual_block(rid)
    assert len(problem._batches) == 1
    assert problem.compile().num_residual_blocks == 5


def test_remove_parameter_block_of_a_bulk_batch_raises(bal16):
    problem, cams, _ = tbal.build_bal_problem(bal16)
    with pytest.raises(NotImplementedError, match="bulk batch"):
        problem.remove_parameter_block(cams[0])


# -- trust-region dumps -------------------------------------------------------------


@pytest.mark.parametrize("solver", ["DENSE_NORMAL_CHOLESKY", "DENSE_SCHUR"])
def test_textfile_dumps_match_jax(tmp_path, solver):
    """The dumps of ``tests/test_schur.py``: iterations 1 and 2 of 3, one
    npz each. ``gradient``, ``lm_diagonal``, ``trust_region_radius``,
    ``step`` and every ``state_i`` hold the same values as the JAX
    package's dump (rtol 1e-8, atol 1e-10: the step of a gauge-free BA
    problem comes from a near-singular system); the ``solver_data_k``
    leaves follow each package's own data."""
    bal = jbal.synthetic_bal(4, 24, 3)
    for pkg in ("jax", "torch"):
        problem, _, _ = PKG[pkg]["bal"].build_bal_problem(bal)
        PKG[pkg]["st"].solve(_options(
            pkg, solver, max_num_iterations=3, trust_region_problem_dump_directory=str(
                tmp_path / pkg), trust_region_minimizer_iterations_to_dump=(1, 2)), problem)
    for it in (1, 2):
        j = np.load(tmp_path / "jax" / f"lm_iteration_{it:03d}.npz")
        t = np.load(tmp_path / "torch" / f"lm_iteration_{it:03d}.npz")
        common = [k for k in j.files if not k.startswith("solver_data")]
        assert sorted(common) == sorted(k for k in t.files if not k.startswith("solver_data"))
        assert {"gradient", "lm_diagonal", "trust_region_radius", "step", "state_0",
                "state_1"} <= set(common)
        for k in common:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-8, atol=1e-10, err_msg=k)
        assert any(k.startswith("solver_data") for k in t.files)
    assert not (tmp_path / "torch" / "lm_iteration_003.npz").exists()


def test_console_dump(capsys):
    problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(4, 24, 3))
    stt.solve(_options("torch", "DENSE_NORMAL_CHOLESKY", max_num_iterations=2,
                       trust_region_minimizer_iterations_to_dump=(1,),
                       trust_region_problem_dump_format_type="CONSOLE"), problem)
    out = capsys.readouterr().out
    assert "LM iteration 1" in out and "solver_data[0]" in out
    assert "LM iteration 2" not in out
