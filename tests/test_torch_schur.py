"""The port's DENSE_SCHUR solver against the JAX package's
``SchurSolver(ev, iterative=False)`` on the same scene, state, scale and
mu: S (dense-W and explicit), the reduced rhs, and dx of ``solve_damped``
(with K1, and with K2's panel loop on the explicit path); and a forced factor
failure, patched into both packages alike, walking the same jitter rungs.
float64 on the CPU, where both factor with a library Cholesky; rtol 1e-8
(S and dx pass through a factorization of a matrix with condition number
~1e4-1e6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.linear_solvers import lm_diagonal as jlm_diagonal
from skeres_tpu.core.schur import SchurSolver as JSchur
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.io import bal as tbal

TOL = dict(rtol=1e-8, atol=1e-10)
MU = 1e-4


def _prior(params, data):
    (c,) = params
    return 0.1 * (c - data)


def _setup(prior=False, scaled=False):
    bal = jbal.synthetic_bal(6, 60, 4)
    jprob, jcams, _ = jbal.build_bal_problem(bal)
    tprob, tcams, _ = tbal.build_bal_problem(bal)
    if prior:  # a second batch on the retained group only (camera priors)
        target = bal.cameras + 0.01
        jprob.add_residual_blocks(_prior, None, [jcams], data=target)
        tprob.add_residual_blocks(_prior, None, [tcams], data=target)
    jprogram = jprob.compile()
    jev = JEvaluator(jprogram)
    jstate = jprogram.initial_state(jev.dtype)
    _, jblocks = jax.jit(jev.blocks)(jstate)
    jg, jdiag = jax.jit(jev.gradient_and_diag)(jblocks)
    jschur = JSchur(jev, iterative=False)
    jdata = jschur.solver_data(jblocks)

    tev = Evaluator(tprob.compile(), device="cpu")
    _, tblocks = tev.blocks(tev.program.initial_state("cpu", torch.float64))
    tg, tdiag = tev.gradient_and_diag(tblocks)
    tschur = SchurSolver(tev)
    tdata = tschur.solver_data(tblocks)
    if scaled:  # the minimizer's path: Jacobi scaling, then prepare()
        jscale = 1.0 / (1.0 + jnp.sqrt(jdiag))
        jdata = jschur.prepare(jschur.scale_data(jdata, jscale))
        jg, jdiag = jg * jscale, jdiag * jscale * jscale
        tscale = 1.0 / (1.0 + torch.sqrt(tdiag))
        tdata = tschur.prepare(tschur.scale_data(tdata, tscale))
        tg, tdiag = tg * tscale, tdiag * tscale * tscale
    return (jschur, jdata, jg, jdiag), (tschur, tdata, tg, tdiag)


@pytest.mark.parametrize("prior,scaled", [(False, False), (False, True), (True, False)])
def test_s_rhs_and_dx_match(prior, scaled):
    (jschur, jdata, jg, jdiag), (tschur, tdata, tg, tdiag) = _setup(prior, scaled)
    jasm = jschur._assemble(jdata, jg, jlm_diagonal(jdiag, MU, 1e-6, 1e32))
    tasm = tschur._assemble(tdata, tg, lm_diagonal(tdiag, MU, 1e-6, 1e32))
    np.testing.assert_allclose(
        tschur._dense_s(tasm).numpy(), np.asarray(jax.jit(jschur._dense_s)(jasm)), **TOL
    )
    np.testing.assert_allclose(
        tschur._schur_rhs(tasm).numpy(), np.asarray(jax.jit(jschur._schur_rhs)(jasm)), **TOL
    )
    jdx, jit_, jj = jax.jit(
        lambda: jschur.solve_damped(jdata, jg, jdiag, MU, 1e-6, 1e32)
    )()
    tdx, tit, tj = tschur.solve_damped(tdata, tg, tdiag, MU, 1e-6, 1e32)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    assert (tit, tj) == (int(jit_), float(jj)) == (1, 0.0)
    np.testing.assert_allclose(
        float(tschur.jtj_quadratic(tdata, tdx)),
        float(jax.jit(jschur.jtj_quadratic)(jdata, jdx)),
        rtol=1e-8,
    )


def _jax_failing_below(orig, threshold):
    """Factor stand-in: NaN unless the jitter added to the (equilibrated,
    unit-diagonal) matrix is at least ``threshold``."""

    def factor(s, rhs):
        x, solve = orig(s, rhs)
        return jnp.where(jnp.min(jnp.diag(s)) - 1.0 < threshold, jnp.nan, x), solve

    return factor


def _torch_failing_below(orig, threshold):
    """The same stand-in for the port, whose factor takes S and the jitter
    apart."""

    def factor(s, rhs, delta):
        x, solve = orig(s, rhs, delta)
        bad = torch.min(torch.diagonal(s) + delta) - 1.0 < threshold
        return torch.where(bad, torch.nan, x), solve

    return factor


@pytest.mark.parametrize(
    "threshold,jitter0,want_iters,want_jitter",
    [
        (5e-4, 0.0, 2, 1e-3),  # rung 0 fails, 1e-3 holds
        (5e-2, 0.0, 3, 0.1),  # 0 and 1e-3 fail, 0.1 holds
        (0.5, 0.0, 32, 0.1),  # every rung fails: capped PCG fallback
        (5e-4, 1e-3, 1, 1e-3),  # the ratchet starts at the rung that held
    ],
)
def test_forced_factor_failure_walks_the_same_ladder(threshold, jitter0, want_iters, want_jitter):
    (jschur, jdata, jg, jdiag), (tschur, tdata, tg, tdiag) = _setup(scaled=True)
    jschur._factor_solve = _jax_failing_below(jschur._factor_solve, threshold)
    tschur._factor_solve = _torch_failing_below(tschur._factor_solve, threshold)
    jdx, jit_, jj = jax.jit(
        lambda: jschur.solve_damped(
            jdata, jg, jdiag, MU, 1e-6, 1e32, jitter0=jnp.asarray(jitter0, jnp.float64)
        )
    )()
    tdx, tit, tj = tschur.solve_damped(tdata, tg, tdiag, MU, 1e-6, 1e32, jitter0=jitter0)
    assert int(jit_) == tit == want_iters
    np.testing.assert_allclose(tj, float(jj), rtol=1e-12)
    np.testing.assert_allclose(tj, want_jitter, rtol=1e-12)
    assert torch.isfinite(tdx).all()
    if want_iters == 32:
        # the capped PCG stops short of convergence, and its iterate carries
        # each of its 32 steps' rounding: compare at 1e-8 of the largest entry
        np.testing.assert_allclose(
            tdx.numpy(), np.asarray(jdx), rtol=0, atol=1e-8 * float(tdx.abs().max())
        )
    else:
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)


# -- the explicit pair-product S (core/explicit_schur.py, K3) and K2 ------------


def _explicit_twin(tschur, tdata, monkeypatch):
    """A second port solver on the same evaluator with the dense-W gate at
    0, so that it takes the explicit S, and its ``prepare()`` of the same
    solver data."""
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    xschur = SchurSolver(tschur.ev)
    raw = [(r, jac) for r, jac, _ in tdata["per_batch"]] if isinstance(tdata, dict) else tdata
    return xschur, xschur.prepare(raw)


@pytest.mark.parametrize(
    "prior,scaled", [(False, False), (False, True), (True, False), (True, True)]
)
def test_explicit_s_matches_jax_and_dense_w(prior, scaled, monkeypatch):
    """The port's explicit S against the JAX package's ``_dense_s_explicit``
    and against the port's own dense-W S, from the same solver data."""
    (jschur, jdata, jg, jdiag), (tschur, tdata, tg, tdiag) = _setup(prior, scaled)
    assert tschur.schur_path == "dense-W" and tschur.explicit_plan is None
    xschur, xdata = _explicit_twin(tschur, tdata, monkeypatch)
    assert xschur.schur_path == "explicit"
    d = lm_diagonal(tdiag, MU, 1e-6, 1e32)
    jasm = jschur._assemble(jdata, jg, jlm_diagonal(jdiag, MU, 1e-6, 1e32))
    s_exp = xschur._dense_s_explicit(xschur._assemble(xdata, tg, d)).numpy()
    np.testing.assert_allclose(s_exp, np.asarray(jax.jit(jschur._dense_s_explicit)(jasm)), **TOL)
    s_dw = tschur._dense_s_dense_w(tschur._assemble(tdata, tg, d)).numpy()
    np.testing.assert_allclose(s_exp, s_dw, **TOL)
    np.testing.assert_array_equal(s_exp, s_exp.T)  # symmetric by construction


def _big_setup(monkeypatch):
    """synthetic_bal(120, 2000, 4): S has 1080 rows, past K1's 1024, so the
    port factors with K2's panel loop. The port's dense-W gate is set to 0,
    so it takes the explicit S; the JAX package takes dense W and its
    library Cholesky."""
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    bal = jbal.synthetic_bal(120, 2000, 4)
    jprogram = jbal.build_bal_problem(bal)[0].compile()
    jev = JEvaluator(jprogram)
    _, jblocks = jax.jit(jev.blocks)(jprogram.initial_state(jev.dtype))
    jg, jdiag = jax.jit(jev.gradient_and_diag)(jblocks)
    jschur = JSchur(jev, iterative=False)
    jscale = 1.0 / (1.0 + jnp.sqrt(jdiag))
    jdata = jschur.prepare(jschur.scale_data(jschur.solver_data(jblocks), jscale))

    tev = Evaluator(tbal.build_bal_problem(bal)[0].compile(), device="cpu")
    _, tblocks = tev.blocks(tev.program.initial_state("cpu", torch.float64))
    tg, tdiag = tev.gradient_and_diag(tblocks)
    tschur = SchurSolver(tev)
    tscale = 1.0 / (1.0 + torch.sqrt(tdiag))
    tdata = tschur.prepare(tschur.scale_data(tschur.solver_data(tblocks), tscale))
    return (
        (jschur, jdata, jg * jscale, jdiag * jscale * jscale),
        (tschur, tdata, tg * tscale, tdiag * tscale * tscale),
    )


def test_explicit_path_with_k2_dx_matches_jax(monkeypatch):
    (jschur, jdata, jg, jdiag), (tschur, tdata, tg, tdiag) = _big_setup(monkeypatch)
    assert jschur.schur_path == "dense-W"
    assert tschur.schur_path == "explicit" and tschur.num_f == 1080
    assert "explicit_grid" in tdata
    jdx, jit_, jj = jax.jit(lambda: jschur.solve_damped(jdata, jg, jdiag, MU, 1e-6, 1e32))()
    tdx, tit, tj = tschur.solve_damped(tdata, tg, tdiag, MU, 1e-6, 1e32)
    assert (tit, tj) == (int(jit_), float(jj)) == (1, 0.0)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)


def test_gradient_and_diag_off_the_layout_is_the_evaluators():
    """Where no batch takes the camera-padded layout (a scene under the
    row threshold), ``SchurSolver.gradient_and_diag`` is
    ``Evaluator.gradient_and_diag`` bit for bit, with no placed rows."""
    _, (tschur, _, _, _) = _setup(prior=True)
    assert not tschur.sorted_info
    tev = tschur.ev
    _, blocks = tev.blocks(tev.program.initial_state("cpu", torch.float64))
    g, diag, cam_raw = tschur.gradient_and_diag(blocks)
    ref_g, ref_diag = tev.gradient_and_diag(blocks)
    assert cam_raw is None
    assert torch.equal(g, ref_g) and torch.equal(diag, ref_diag)
