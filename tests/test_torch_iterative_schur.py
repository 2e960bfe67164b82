"""The port's ITERATIVE_SCHUR against the JAX package's
``SchurSolver(ev, iterative=True, ...)`` on the same scene, scale and mu:
the implicit S product, the camera blocks, one damped solve for every
preconditioner and for the explicit S, and DENSE_SCHUR's mixed-precision
refinement. float64 on the CPU (where K3 takes its plain version).

Tolerances: products and blocks rtol 1e-10 (sums of a few hundred float64
terms in another order); dx rtol 1e-9 with an atol of 1e-9 of its largest
entry (PCG iterates after equal step counts; each step's rounding is
carried along). PCG step counts must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.linear_solvers import lm_diagonal as jlm_diagonal
from skeres_tpu.core.schur import SchurSolver as JSchur
from skeres_tpu.core.types import PreconditionerType as JP
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.schur import SchurSolver
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

MU = 1e-4
SCENE = (16, 500, 4)
PRECONDITIONERS = ["JACOBI", "IDENTITY", "SCHUR_JACOBI", "POWER_SERIES_EXPANSION",
                   "CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"]


def _prior(params, data):
    (c,) = params
    return 0.1 * (c - data)


class _Scene:
    """One linearization of a scene in both packages, Jacobi-scaled as the
    minimizer scales it; solvers of either package on the same inputs."""

    def __init__(self, scene=SCENE, prior=False):
        bal = jbal.synthetic_bal(*scene)
        jprob, jcams, _ = jbal.build_bal_problem(bal)
        tprob, tcams, _ = tbal.build_bal_problem(bal)
        if prior:  # a second batch on the retained group only
            target = bal.cameras + 0.01
            jprob.add_residual_blocks(_prior, None, [jcams], data=target)
            tprob.add_residual_blocks(_prior, None, [tcams], data=target)
        jprogram = jprob.compile()
        self.jev = JEvaluator(jprogram)
        _, self.jblocks = jax.jit(self.jev.blocks)(jprogram.initial_state(self.jev.dtype))
        jg, jdiag = jax.jit(self.jev.gradient_and_diag)(self.jblocks)
        self.jscale = 1.0 / (1.0 + jnp.sqrt(jdiag))
        self.jg, self.jdiag = jg * self.jscale, jdiag * self.jscale**2

        self.tev = Evaluator(tprob.compile(), device="cpu")
        _, self.tblocks = self.tev.blocks(self.tev.program.initial_state("cpu", torch.float64))
        tg, tdiag = self.tev.gradient_and_diag(self.tblocks)
        self.tscale = 1.0 / (1.0 + torch.sqrt(tdiag))
        self.tg, self.tdiag = tg * self.tscale, tdiag * self.tscale**2
        # the two linearizations are the same inputs
        np.testing.assert_allclose(self.tg.numpy(), np.asarray(self.jg), rtol=1e-10, atol=1e-12)

    def jax(self, **kw):
        schur = JSchur(self.jev, **kw)
        data = schur.prepare(schur.scale_data(schur.solver_data(self.jblocks), self.jscale))
        return schur, data

    def port(self, **kw):
        schur = SchurSolver(self.tev, **kw)
        data = schur.prepare(schur.scale_data(schur.solver_data(self.tblocks), self.tscale))
        return schur, data

    def asm(self, jschur, jdata, tschur, tdata, mu=MU):
        return (jschur._assemble(jdata, self.jg, jlm_diagonal(self.jdiag, mu, 1e-6, 1e32)),
                tschur._assemble(tdata, self.tg, lm_diagonal(self.tdiag, mu, 1e-6, 1e32)))

    def solve_both(self, jschur, jdata, tschur, tdata, mu=MU):
        jdx, jit_, _ = jax.jit(
            lambda: jschur.solve_damped(jdata, self.jg, self.jdiag, mu, 1e-6, 1e32))()
        tdx, tit, tj = tschur.solve_damped(tdata, self.tg, self.tdiag, mu, 1e-6, 1e32)
        return (np.asarray(jdx), int(jit_)), (tdx.numpy(), int(tit), float(tj))


@pytest.fixture(scope="module")
def scene():
    return _Scene()


@pytest.fixture(scope="module")
def scene_prior():
    return _Scene((6, 60, 4), prior=True)


def _assert_dx(tdx, jdx, rtol=1e-9):
    np.testing.assert_allclose(tdx, jdx, rtol=rtol, atol=rtol * np.abs(jdx).max())


@pytest.mark.parametrize("which", ["scene", "scene_prior"])
def test_s_matvec_equals_dense_s_times_v(which, request):
    """The implicit product against ``S @ v`` with the dense S of the same
    assembly (the port's own dense-W S), and against the JAX product."""
    sc = request.getfixturevalue(which)
    jschur, jdata = sc.jax(iterative=True)
    tschur, tdata = sc.port(iterative=True)
    dense, ddata = sc.port()
    assert tschur.schur_path == jschur.schur_path == "implicit"
    jasm, tasm = sc.asm(jschur, jdata, tschur, tdata)
    s = dense._dense_s(dense._assemble(ddata, sc.tg, lm_diagonal(sc.tdiag, MU, 1e-6, 1e32)))
    v = np.random.default_rng(3).standard_normal(tschur.num_f)
    sv = tschur._s_matvec(tasm, torch.tensor(v)).numpy()
    scale = np.abs(sv).max()
    np.testing.assert_allclose(sv, (s @ torch.tensor(v)).numpy(), rtol=1e-10, atol=1e-12 * scale)
    np.testing.assert_allclose(sv, np.asarray(jax.jit(jschur._s_matvec)(jasm, jnp.asarray(v))),
                               rtol=1e-10, atol=1e-12 * scale)


@pytest.mark.parametrize("which", ["scene", "scene_prior"])
def test_blocks_diagonal_and_jtj_matvec_match_jax(which, request):
    sc = request.getfixturevalue(which)
    jschur, jdata = sc.jax(iterative=True, preconditioner=JP.SCHUR_JACOBI)
    tschur, tdata = sc.port(iterative=True, preconditioner=P.SCHUR_JACOBI)
    jasm, tasm = sc.asm(jschur, jdata, tschur, tdata)
    for corr in (True, False):
        jb = jax.jit(lambda a: jschur._schur_jacobi_blocks(a, include_e_correction=corr)[0])(jasm)
        tb = tschur._schur_jacobi_blocks(tasm, include_e_correction=corr)[0]
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10,
                                   atol=1e-12 * float(tb.abs().max()))
    np.testing.assert_allclose(tschur._ftf_diag(tasm).numpy(),
                               np.asarray(jax.jit(jschur._ftf_diag)(jasm)), rtol=1e-10)
    v = np.random.default_rng(5).standard_normal(sc.tev.num_tangent)
    tv = tschur.jtj_matvec(tdata, torch.tensor(v)).numpy()
    np.testing.assert_allclose(tv, np.asarray(jax.jit(jschur.jtj_matvec)(jdata, jnp.asarray(v))),
                               rtol=1e-10, atol=1e-12 * np.abs(tv).max())
    # the block diagonal is the diagonal of dense S
    dense, ddata = sc.port()
    s = dense._dense_s(dense._assemble(ddata, sc.tg, lm_diagonal(sc.tdiag, MU, 1e-6, 1e32)))
    np.testing.assert_allclose(tschur._schur_jacobi_blocks(tasm)[0].numpy(),
                               tschur._diag_blocks_of(s).numpy(), rtol=1e-10,
                               atol=1e-12 * float(s.abs().max()))


@pytest.mark.parametrize("name", PRECONDITIONERS)
def test_one_damped_solve_matches_jax(scene, name):
    """dx and the PCG step count of one damped solve, cluster size 4, with
    the Q test at its default eta = 0.1: on this scene no stopping decision
    sits within the two packages' rounding of eta, so the counts are equal
    without pinning (the pinned test below holds the iterates where the
    step limit binds instead)."""
    kw = dict(iterative=True, cluster_size=4)
    jschur, jdata = scene.jax(preconditioner=JP[name], **kw)
    tschur, tdata = scene.port(preconditioner=P[name], **kw)
    (jdx, jit_), (tdx, tit, tj) = scene.solve_both(jschur, jdata, tschur, tdata)
    assert tit == jit_ and 1 < tit < 500
    assert tj == 0.0  # the ratchet passes through
    _assert_dx(tdx, jdx)
    assert tschur.preconditioner_used == P[name]


@pytest.mark.parametrize("name", ["SCHUR_JACOBI", "POWER_SERIES_EXPANSION", "CLUSTER_TRIDIAGONAL"])
def test_pinned_count_solve_matches_jax(scene, name):
    """``max_cg_iterations = 6`` with eta = 1e-12, small enough that the
    step limit binds and not the Q test: the count is pinned at 6 in both
    packages whatever the summation order, and the iterates agree."""
    kw = dict(iterative=True, cluster_size=4, max_cg_iterations=6, eta=1e-12)
    jschur, jdata = scene.jax(preconditioner=JP[name], **kw)
    tschur, tdata = scene.port(preconditioner=P[name], **kw)
    (jdx, jit_), (tdx, tit, _) = scene.solve_both(jschur, jdata, tschur, tdata)
    assert tit == jit_ == 6
    _assert_dx(tdx, jdx)


@pytest.mark.parametrize("name", ["SCHUR_JACOBI", "JACOBI", "CLUSTER_JACOBI"])
def test_explicit_s_solve_matches_jax(scene, name):
    """ITERATIVE_SCHUR with ``use_explicit``: S by the pair-product plan
    (K3's plain version here), each PCG step one dense product;
    SCHUR_JACOBI reads its blocks off S."""
    kw = dict(iterative=True, use_explicit=True, cluster_size=4)
    jschur, jdata = scene.jax(preconditioner=JP[name], **kw)
    tschur, tdata = scene.port(preconditioner=P[name], **kw)
    assert tschur.schur_path == jschur.schur_path == "explicit"
    assert tschur.explicit_plan is not None and tschur.w_plan is None
    (jdx, jit_), (tdx, tit, _) = scene.solve_both(jschur, jdata, tschur, tdata)
    assert tit == jit_ and tit > 1
    _assert_dx(tdx, jdx)
    # the same step as the implicit product gives
    ischur, idata = scene.port(iterative=True, preconditioner=P[name], cluster_size=4)
    idx, iit, _ = ischur.solve_damped(idata, scene.tg, scene.tdiag, MU, 1e-6, 1e32)
    assert int(iit) == tit
    _assert_dx(idx.numpy(), tdx, rtol=1e-8)


def test_solve_with_a_prior_batch_matches_jax(scene_prior):
    kw = dict(iterative=True)
    jschur, jdata = scene_prior.jax(preconditioner=JP.SCHUR_JACOBI, **kw)
    tschur, tdata = scene_prior.port(preconditioner=P.SCHUR_JACOBI, **kw)
    (jdx, jit_), (tdx, tit, _) = scene_prior.solve_both(jschur, jdata, tschur, tdata)
    assert tit == jit_ and tit > 1
    _assert_dx(tdx, jdx)


def test_explicit_gate_gives_the_implicit_path_and_its_reason(scene):
    """Past ``explicit_s_limit_bytes`` the iterative solver takes the
    implicit product and says why, as the JAX package does."""
    kw = dict(iterative=True, use_explicit=True, explicit_s_limit_bytes=1024)
    jschur, _ = scene.jax(**kw)
    tschur, tdata = scene.port(**kw)
    assert tschur.schur_path == jschur.schur_path
    assert tschur.schur_path.startswith("implicit (gate: S too large")
    assert not tschur.use_explicit and "explicit_grid" not in tdata


def test_iterative_solver_builds_no_dense_w_plan(scene):
    tschur, tdata = scene.port(iterative=True, preconditioner=P.JACOBI)
    assert tschur.w_plan is None and tschur.explicit_plan is None and tschur.cluster_plan is None
    assert "explicit_grid" not in tdata  # JACOBI reads no point grid


@pytest.mark.parametrize("refine", [0, 2])
def test_dense_schur_refinement_in_float32_matches_jax(refine):
    """DENSE_SCHUR with mixed-precision refinement, float32 working dtype:
    the factor in float32 (its plain version here), residuals in float64,
    corrections through the same factor. The JAX package's float32
    linearization (corrected r and jac, g, diag, scale) goes into the
    port's solver as numpy arrays. mu = 1: S is then well conditioned, so
    that two float32 assemblies of it (relative difference ~1e-7) give dx
    within 1e-5 of its largest entry; and with 2 refinements the port's dx
    is closer to the float64 solve of the same inputs than without."""
    mu = 1.0
    bal = jbal.synthetic_bal(*SCENE)
    jev = JEvaluator(jbal.build_bal_problem(bal)[0].compile(), dtype=jnp.float32)
    _, jblocks = jax.jit(jev.blocks)(jev.program.initial_state(jev.dtype))
    jg, jdiag = jax.jit(jev.gradient_and_diag)(jblocks)
    jscale = 1.0 / (1.0 + jnp.sqrt(jdiag))
    jschur = JSchur(jev, iterative=False, refinement_iterations=refine)
    jdata = jschur.prepare(jschur.scale_data(jschur.solver_data(jblocks), jscale))
    jdx, _, _ = jax.jit(lambda: jschur.solve_damped(jdata, jg * jscale, jdiag * jscale**2, mu,
                                                    1e-6, 1e32))()
    assert np.asarray(jdx).dtype == np.float32

    def port(dtype, refine):
        tev = Evaluator(tbal.build_bal_problem(bal)[0].compile(), device="cpu", dtype=dtype)
        as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
        tschur = SchurSolver(tev, refinement_iterations=refine)
        raw = tuple((as_t(b.r)[: tb.num_blocks], as_t(b.jac)[: tb.num_blocks])
                    for b, tb in zip(jblocks, tev.program.batches))
        tdata = tschur.prepare(tschur.scale_data(raw, as_t(jscale)))
        dx, it, _ = tschur.solve_damped(tdata, as_t(jg * jscale), as_t(jdiag * jscale**2), mu,
                                        1e-6, 1e32)
        assert int(it) == 1 and dx.dtype == dtype
        return dx.double().numpy()

    tdx = port(torch.float32, refine)
    np.testing.assert_allclose(tdx, np.asarray(jdx, dtype=np.float64), rtol=0,
                               atol=1e-5 * np.abs(tdx).max())
    if refine:
        exact = port(torch.float64, 0)
        assert np.abs(tdx - exact).max() < np.abs(port(torch.float32, 0) - exact).max()


def test_refinement_reuses_the_factor(scene):
    """The refinement calls the solve that ``_factor_solve`` hands back and
    factors once."""
    tschur, tdata = scene.port(refinement_iterations=2)
    calls = []
    orig = tschur._factor_solve

    def counting(s, rhs, delta):
        x, solve = orig(s, rhs, delta)
        calls.append("factor")
        return x, lambda b: (calls.append("solve"), solve(b))[1]

    tschur._factor_solve = counting
    tschur.solve_damped(tdata, scene.tg, scene.tdiag, MU, 1e-6, 1e32)
    assert calls == ["factor", "solve", "solve"]
