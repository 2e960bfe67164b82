"""The port's Evaluator against the JAX package's on the same scene and
state: cost, g = J^T r, diag(J^T J), and the rows of r and J. The JAX
evaluator pads batches with weight-0 rows; only the valid rows are
compared. float64, rtol 1e-10 (the same per-row arithmetic; the sums run
in another order)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.io import bal as jbal
from skeres_tpu.ops import loss as jloss
from skeres_tpu.ops.loss import CauchyLoss as JCauchy
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.problem import state_from_numpy
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.ops import loss as tloss
from skeres_tpu_torch.ops.loss import CauchyLoss
from skeres_tpu_torch.ops.segment_reduce import apply_reduce_plan, build_reduce_plan

TOL = dict(rtol=1e-10, atol=1e-12)


def _compare(jev, jstate, tev, chunk_size):
    jcost, jblocks = jax.jit(jev.blocks)(jstate)
    jg, jdiag = jax.jit(jev.gradient_and_diag)(jblocks)
    tstate = state_from_numpy(tev.program, [np.asarray(v) for v in jstate], "cpu", torch.float64)
    tcost, tblocks = tev.blocks(tstate)
    tg, tdiag = tev.gradient_and_diag(tblocks)
    np.testing.assert_allclose(float(tcost), float(jcost), **TOL)
    np.testing.assert_allclose(float(tev.cost(tstate)), float(jcost), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), **TOL)
    for b, jb, tb in zip(tev.program.batches, jblocks, tblocks):
        n = b.num_blocks
        np.testing.assert_allclose(tb.r.numpy(), np.asarray(jb.r)[:n], **TOL)
        np.testing.assert_allclose(tb.jac.numpy(), np.asarray(jb.jac)[:n], **TOL)
        np.testing.assert_array_equal(tb.idx.numpy(), np.asarray(jb.idx)[:n])
    if chunk_size:
        assert len(tev._row_slices(0)) > 1


def test_graft_entry_scene_matches():
    """The scene of ``__graft_entry__.entry()``: cost, g and diag."""
    jev, jstate = __graft_entry__._small_bal_setup()
    bal = jbal.synthetic_bal(num_cameras=4, num_points=24, observations_per_point=3)
    problem, _, _ = tbal.build_bal_problem(bal)
    _compare(jev, jstate, Evaluator(problem.compile(), device="cpu"), None)


@pytest.mark.parametrize(
    "loss,chunk,mode",
    [
        (False, None, "auto"),
        (False, 300, "auto"),  # 2000 rows: 7 chunks, the last one short
        (True, None, "auto"),
        (True, 512, "forward"),
    ],
)
def test_synthetic_bal_matches(loss, chunk, mode):
    bal = jbal.synthetic_bal(16, 500, 4)
    jprob, _, _ = jbal.build_bal_problem(bal, loss=JCauchy(2.0) if loss else None)
    tprob, _, _ = tbal.build_bal_problem(bal, loss=CauchyLoss(2.0) if loss else None)
    jprogram = jprob.compile()
    jev = JEvaluator(jprogram, chunk_size=chunk, diff_mode=mode)
    jstate = jprogram.initial_state(jev.dtype)
    tev = Evaluator(tprob.compile(), device="cpu", chunk_size=chunk, diff_mode=mode)
    _compare(jev, jstate, tev, chunk)


@pytest.mark.parametrize("loss,chunk", [(False, None), (False, 300), (True, 300)])
def test_batched_form_matches_the_vmapped_program(loss, chunk):
    """The Snavely batch, which takes its batched form (closed-form J),
    against the same function of the same 12 parameters through
    ``snavely_reprojection_error_split`` (pose, intrinsics, point), which
    takes the vmapped autodiff: cost, g, diag, r and J. The camera's g and
    diag are the split's pose and intrinsics entries side by side. rtol
    1e-12: the same rows by other formulas (the closed form keeps digits
    that autodiff loses at small angles; the scene's are large)."""
    bal = tbal.synthetic_bal(16, 500, 4)
    kw = dict(loss=CauchyLoss(2.0) if loss else None)
    fused = Evaluator(tbal.build_bal_problem(bal, **kw)[0].compile(), device="cpu",
                      chunk_size=chunk)
    generic = Evaluator(tbal.build_split_bal_problem(bal, **kw)[0].compile(), device="cpu",
                        chunk_size=chunk)
    assert fused.takes_batched_form(0) and not generic.takes_batched_form(0)
    fs = fused.program.initial_state("cpu", torch.float64)
    gs = generic.program.initial_state("cpu", torch.float64)
    (fcost, (fb,)), (gcost, (gb,)) = fused.blocks(fs), generic.blocks(gs)
    close = dict(rtol=1e-12, atol=0)
    torch.testing.assert_close(fcost, gcost, **close)
    torch.testing.assert_close(fused.cost(fs), generic.cost(gs), **close)
    torch.testing.assert_close(fb.r, gb.r, **close)
    torch.testing.assert_close(fb.jac, gb.jac, rtol=1e-12, atol=1e-12 * float(gb.jac.abs().max()))
    nc = len(bal.cameras)
    for f_vec, g_vec in zip(fused.gradient_and_diag([fb]), generic.gradient_and_diag([gb])):
        cams = torch.cat([g_vec[: 6 * nc].view(nc, 6), g_vec[6 * nc: 9 * nc].view(nc, 3)], 1)
        want = torch.cat([cams.reshape(-1), g_vec[9 * nc:]])
        torch.testing.assert_close(f_vec, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


def test_plus_and_x_norm_match():
    bal = jbal.synthetic_bal(4, 24, 3)
    jprob, _, _ = jbal.build_bal_problem(bal)
    tprob, _, _ = tbal.build_bal_problem(bal)
    jprogram = jprob.compile()
    jev = JEvaluator(jprogram)
    jstate = jprogram.initial_state(jev.dtype)
    tev = Evaluator(tprob.compile(), device="cpu")
    step = np.random.default_rng(3).normal(size=jprogram.num_tangent)
    jnew = jev.plus(jstate, jax.numpy.asarray(step))
    tnew = tev.plus(tev.program.initial_state("cpu", torch.float64), torch.from_numpy(step))
    for a, b in zip(tnew, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)
    np.testing.assert_allclose(float(tev.x_norm(tnew)), float(jev.x_norm(jnew)), rtol=1e-14)


@pytest.mark.parametrize("kind", ["contig", "scatter"])
def test_reduce_plans_match_numpy(kind):
    rng = np.random.default_rng(0)
    n_dest, d = 50, 6
    idx = np.repeat(np.arange(n_dest), 3) if kind == "contig" else rng.integers(0, n_dest, 400)
    vals = rng.standard_normal((len(idx), d))
    plan = build_reduce_plan(idx, n_dest, "cpu")
    assert plan.kind == kind
    want = np.zeros((n_dest, d))
    np.add.at(want, idx, vals)
    got = apply_reduce_plan(plan, torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.TrivialLoss(),
        lambda m: m.HuberLoss(1.5),
        lambda m: m.SoftLOneLoss(0.7),
        lambda m: m.CauchyLoss(2.0),
        lambda m: m.ArctanLoss(1.2),
        lambda m: m.TolerantLoss(1.0, 0.5),
        lambda m: m.TukeyLoss(1.3),
        lambda m: m.ScaledLoss(m.CauchyLoss(1.0), 3.0),
        lambda m: m.ComposedLoss(m.HuberLoss(1.0), m.SoftLOneLoss(2.0)),
        lambda m: m.LossFunctionWrapper(m.ArctanLoss(0.5)),
    ],
)
def test_losses_match_jax(make):
    """rho, rho' and rho'' of every loss on both sides of its breakpoints,
    s = 0 included: the same formulas, rtol 1e-12. atol 1e-14: rho of the
    tolerant loss is b softplus(x) - c, a difference of two O(1) terms
    that cancel for small s, so libm's last bits show there."""
    s = np.concatenate([[0.0], np.geomspace(1e-8, 1e4, 61)])
    want = make(jloss).evaluate(jax.numpy.asarray(s))
    got = make(tloss).evaluate(torch.from_numpy(s))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)
