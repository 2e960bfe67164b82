"""The port's Covariance against the JAX package's, float64 on the CPU, on
the cases of ``tests/test_covariance_gradient.py``: the linear-system
oracle, rank deficiency, SCHUR_COMPLEMENT against DENSE_SVD on every block
pair of a small BA scene (on the dense-W and the explicit S, K3's plain
version), the singular point block returning False, and
``apply_loss_function=False``; each block against the JAX package's to
rtol 1e-8 (1e-7 on the BA scene, whose J^T J is 8.4e7-conditioned)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.covariance import Covariance as JCovariance
from skeres_tpu.core.covariance import CovarianceOptions as JCovarianceOptions
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import CovarianceAlgorithmType as JAlgorithm
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.io import bal as jbal
from skeres_tpu.ops.loss import CauchyLoss as JCauchy
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.covariance import Covariance, CovarianceOptions
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import CovarianceAlgorithmType, LinearSolverType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.ops.loss import CauchyLoss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(jopts=None, topts=None):
    return (JCovariance(JCovarianceOptions(**(jopts or {}))),
            Covariance(CovarianceOptions(device="cpu", **(topts or {}))))


def _linear(pkg, a_mat, b_vec, x0, loss=None):
    xp = jnp if pkg == "jax" else torch
    problem = (st if pkg == "jax" else stt).Problem()
    x = problem.add_parameter_block(x0)
    problem.add_residual_block(
        lambda params, data: xp.asarray(a_mat) @ params[0] - xp.asarray(b_vec), loss, [x])
    return problem, x


def test_linear_system_oracle_matches_jax():
    """r = A x - b: the covariance is (A^T A)^-1, in both packages."""
    rng = np.random.default_rng(5)
    a_mat, b_vec = rng.normal(size=(6, 3)), rng.normal(size=(6,))
    jp, jx = _linear("jax", a_mat, b_vec, np.zeros(3))
    tp, tx = _linear("torch", a_mat, b_vec, np.zeros(3))
    st.solve(JOptions(max_num_iterations=50), jp)
    stt.solve(SolverOptions(max_num_iterations=50, device="cpu"), tp)
    jc, tc = _both()
    assert jc.compute(jp) and tc.compute(tp)
    got = tc.get_covariance_block(tx, tx)
    np.testing.assert_allclose(got, jc.get_covariance_block(jx, jx), rtol=1e-8)
    np.testing.assert_allclose(got, np.linalg.inv(a_mat.T @ a_mat), rtol=1e-6, atol=1e-10)
    assert tc.rank == jc.rank == 3
    assert set(tc.seconds) == {"evaluate", "assemble", "eigh", "pinv"}


def _sum_only(pkg):
    problem = (st if pkg == "jax" else stt).Problem()
    x = problem.add_parameter_block([1.0, 1.0])
    problem.add_residual_block(lambda params, data: (params[0][0] + params[0][1] - 2.0)[None],
                               None, [x])
    return problem, x


@pytest.mark.parametrize("null_space_rank", [0, 1, -1])
def test_rank_deficiency_matches_jax(null_space_rank):
    """Only x0 + x1 is observed: compute() fails unless the null space is
    allowed (null_space_rank 1, or -1: found by the condition number);
    then the pseudo-inverse and the rank equal the JAX package's."""
    (jp, jx), (tp, tx) = _sum_only("jax"), _sum_only("torch")
    kw = dict(null_space_rank=null_space_rank)
    jc, tc = _both(kw, kw)
    jok, tok = jc.compute(jp), tc.compute(tp)
    assert tok == jok == (null_space_rank != 0)
    assert tc.rank == jc.rank == 1
    if tok:
        np.testing.assert_allclose(tc.get_covariance_block(tx, tx),
                                   jc.get_covariance_block(jx, jx), rtol=1e-8)
        np.testing.assert_allclose(tc.smallest_kept, 2.0, rtol=1e-12)


def _bal_solved(pkg, bal):
    """tests/test_covariance_gradient.py's scene: cameras 0 and 1 constant,
    25 DENSE_SCHUR steps."""
    if pkg == "jax":
        problem, cams, pts = jbal.build_bal_problem(bal)
    else:
        problem, cams, pts = tbal.build_bal_problem(bal)
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(cams[1])
    if pkg == "jax":
        st.solve(JOptions(linear_solver_type=JLinearSolverType.DENSE_SCHUR,
                          max_num_iterations=25), problem)
    else:
        stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=25, device="cpu"), problem)
    return problem, cams, pts


@pytest.fixture(scope="module")
def bal_scenes():
    """Both packages' solves; the port's problem then takes the JAX
    solution's values, so that the covariances compare at one point."""
    bal = jbal.synthetic_bal(num_cameras=5, num_points=30, observations_per_point=4)
    jax_scene, torch_scene = _bal_solved("jax", bal), _bal_solved("torch", bal)
    for j, t in zip(jax_scene[1:], torch_scene[1:]):
        np.testing.assert_allclose(t.values, np.asarray(j.values), rtol=1e-8, atol=1e-10)
        t.values = np.asarray(j.values)
    return jax_scene, torch_scene


@pytest.mark.parametrize("path", ["dense-W", "explicit"])
def test_schur_complement_matches_dense_svd_and_jax(bal_scenes, monkeypatch, path):
    """Every block-pair type (camera-camera, camera-point, point-point,
    same and distinct points, and a constant camera, whose covariance is
    zero) in both algorithms of both packages, at the same parameter
    values: each of the port's against the JAX package's DENSE_SVD, its
    SCHUR_COMPLEMENT against the JAX package's too, and the ambient lift.
    The free J^T J's condition number is 8.4e7, and the JAX package's own
    two algorithms differ by up to 6e-8 here (an entry relative to
    itself); the port's stay within 5e-8 of the JAX package's, held at
    rtol 1e-7. The explicit path builds S by K3's plain version (the
    dense-W gate at 0)."""
    if path == "explicit":
        monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    (jp, jcams, jpts), (tp, tcams, tpts) = bal_scenes
    schur = dict(algorithm_type=JAlgorithm.SCHUR_COMPLEMENT)
    jd, td = _both()
    js, ts = _both(schur, dict(algorithm_type=CovarianceAlgorithmType.SCHUR_COMPLEMENT))
    assert jd.compute(jp) and td.compute(tp) and js.compute(jp) and ts.compute(tp)
    assert ts._schur.schur_path == path
    pairs = [(2, 2, "c", "c"), (2, 4, "c", "c"), (3, 7, "c", "p"), (11, 2, "p", "c"),
             (3, 3, "p", "p"), (3, 19, "p", "p"), (0, 2, "c", "c")]
    for i, j, a, b in pairs:
        tb = [(tcams if k == "c" else tpts)[n] for k, n in ((a, i), (b, j))]
        jb = [(jcams if k == "c" else jpts)[n] for k, n in ((a, i), (b, j))]
        want = jd.get_covariance_block_in_tangent_space(*jb)
        for got in (td.get_covariance_block_in_tangent_space(*tb),
                    ts.get_covariance_block_in_tangent_space(*tb)):
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12,
                                       err_msg=f"{a}{i} x {b}{j}")
        np.testing.assert_allclose(ts.get_covariance_block_in_tangent_space(*tb),
                                   js.get_covariance_block_in_tangent_space(*jb),
                                   rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(ts.get_covariance_block(tcams[2], tpts[7]),
                               js.get_covariance_block(jcams[2], jpts[7]), rtol=1e-7, atol=1e-12)
    assert ts.rank == js.rank and td.rank == jd.rank


def test_schur_singular_point_block_returns_false():
    """One 2-D observation a point makes C_p rank-2: compute() returns
    False in both packages."""
    bal = jbal.synthetic_bal(num_cameras=4, num_points=12, observations_per_point=1)
    out = []
    for pkg, mod, algo in (("jax", jbal, JAlgorithm), ("torch", tbal, CovarianceAlgorithmType)):
        problem, cams, _ = mod.build_bal_problem(bal)
        problem.set_parameter_block_constant(cams[0])
        problem.set_parameter_block_constant(cams[1])
        cov = (JCovariance(JCovarianceOptions(algorithm_type=algo.SCHUR_COMPLEMENT)) if pkg == "jax"
               else Covariance(CovarianceOptions(algorithm_type=algo.SCHUR_COMPLEMENT,
                                                 device="cpu")))
        out.append(cov.compute(problem))
    assert out == [False, False]


def test_apply_loss_function_false_matches_jax():
    """Without the robustifier the covariance of a robust problem equals
    the loss-free problem's; with it, it differs; each as in the JAX
    package."""
    rng = np.random.default_rng(7)
    a_mat, b_vec = rng.normal(size=(8, 3)), rng.normal(size=(8,))
    x0 = np.full(3, 0.5)
    jr, jxr = _linear("jax", a_mat, b_vec, x0, JCauchy(0.3))
    tr, txr = _linear("torch", a_mat, b_vec, x0, CauchyLoss(0.3))
    tpl, txp = _linear("torch", a_mat, b_vec, x0)
    jc, tc = _both(dict(apply_loss_function=False), dict(apply_loss_function=False))
    assert jc.compute(jr) and tc.compute(tr)
    no_loss = tc.get_covariance_block(txr, txr)
    np.testing.assert_allclose(no_loss, jc.get_covariance_block(jxr, jxr), rtol=1e-8)
    plain = Covariance(CovarianceOptions(device="cpu"))
    assert plain.compute(tpl)
    np.testing.assert_allclose(no_loss, plain.get_covariance_block(txp, txp), rtol=1e-10)
    jw, tw = _both()
    assert jw.compute(jr) and tw.compute(tr)
    with_loss = tw.get_covariance_block(txr, txr)
    np.testing.assert_allclose(with_loss, jw.get_covariance_block(jxr, jxr), rtol=1e-8)
    assert not np.allclose(with_loss, no_loss, rtol=1e-3)


def test_compute_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    problem, _ = _sum_only("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Covariance().compute(problem)


@pytest.mark.parametrize("kind", ["spd", "rank 2", "rank 1", "badly scaled", "diagonal"])
def test_batched_eigvalsh_matches_lapack(kind):
    """The C_p guard's eigenvalues (cyclic Jacobi in torch ops) against
    LAPACK's eigvalsh, to 1e-14 of each matrix's largest: well inside the
    guard's threshold (100 float64 epsilons of the largest)."""
    from skeres_tpu_torch.core.covariance import _batched_eigvalsh

    rng = np.random.default_rng(2)
    cols = {"spd": 3, "rank 2": 2, "rank 1": 1, "badly scaled": 3, "diagonal": 3}[kind]
    m = rng.normal(size=(2000, 3, cols))
    a = m @ np.swapaxes(m, 1, 2)
    if kind == "badly scaled":
        scale = np.array([1e6, 1.0, 1e-6])
        a = a * scale[None, :, None] * scale[None, None, :]
    if kind == "diagonal":
        a = np.eye(3)[None] * rng.uniform(0.5, 2.0, size=(2000, 1, 3))
    want = np.linalg.eigvalsh(a)
    got = _batched_eigvalsh(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())
    err = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert err.max() < 1e-14
