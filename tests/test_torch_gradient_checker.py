"""The port's gradient checker against the JAX package's, float64 on the
CPU: correct problems pass, a residual whose derivative is wrong (a
stopped gradient hides one of its terms) fails with the same batch,
block, residual and tangent coordinate and the same message, evaluation
chunks find the same block, a ``numeric_diff`` batch is skipped, and
``check_gradients`` through ``solve`` stops with the JAX package's
message."""

import jax
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.gradient_checker import check_program_gradients as jcheck
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.gradient_checker import check_program_gradients
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stop(pkg):
    return jax.lax.stop_gradient if pkg == "jax" else torch.Tensor.detach


def _problem(pkg, bad_row=None, numeric_diff=False):
    """30 blocks of 3 parameters with residuals r = (x0 x1 - d0, x1 x2^2 -
    d1, sin(x0) + x2 - d2), and a second batch on pairs of blocks; with
    ``bad_row``, block ``bad_row``'s data flags its second residual, whose
    derivative in x2 is then wrong (the gradient through one factor is
    stopped)."""
    mod = st if pkg == "jax" else stt
    xp = jax.numpy if pkg == "jax" else torch
    stop = _stop(pkg)
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(30, 3)) + 1.5
    data = np.concatenate([rng.normal(size=(30, 3)), np.zeros((30, 1))], axis=1)
    if bad_row is not None:
        data[bad_row, 3] = 1.0
    problem = mod.Problem()
    arr = problem.add_parameter_block_array(x0)

    def pair(params, d):
        a, b = params
        return a[:2] * b[1:] - d

    def triple(params, d):
        (x,) = params
        wrong = d[3] * x[1] * stop(x[2]) * x[2] + (1.0 - d[3]) * x[1] * x[2] ** 2
        return xp.stack([x[0] * x[1] - d[0], wrong - d[1], xp.sin(x[0]) + x[2] - d[2]])

    problem.add_residual_blocks(pair, None, [(arr, np.arange(29)), (arr, np.arange(1, 30))],
                                data=rng.normal(size=(29, 2)), name="pair")
    problem.add_residual_blocks(triple, None, [arr], data=data, name="triple",
                                numeric_diff=numeric_diff)
    return problem


def _checks(bad_row=None, chunk=None, numeric_diff=False):
    jp = _problem("jax", bad_row, numeric_diff).compile()
    tp = _problem("torch", bad_row, numeric_diff).compile()
    return (jcheck(jp, JEvaluator(jp)),
            check_program_gradients(tp, Evaluator(tp, device="cpu", chunk_size=chunk)))


def test_correct_problems_pass():
    (jok, jmsg), (tok, tmsg) = _checks()
    assert jok and tok, (jmsg, tmsg)
    for bal in (tbal.synthetic_bal(4, 24, 3),):
        program = tbal.build_bal_problem(bal)[0].compile()
        ok, msg = check_program_gradients(program, Evaluator(program, device="cpu"))
        assert ok, msg


@pytest.mark.parametrize("bad_row", [0, 17, 29])
@pytest.mark.parametrize("chunk", [None, 7])
def test_wrong_derivative_is_found_where_jax_finds_it(bad_row, chunk):
    """The worst entry is block ``bad_row``'s residual 1 in tangent
    coordinate 2 of batch 1, with the same analytic and numeric values and
    the same message as the JAX package's; the port's row chunks of 7 find
    the same block."""
    (jok, jmsg), (tok, tmsg) = _checks(bad_row, chunk)
    assert not jok and not tok
    assert f"at block {bad_row}, residual 1, tangent coord 2" in tmsg
    assert tmsg.startswith("batch 'triple' (index 1): max relative error")
    # the printed values are the same to the digits the messages carry
    # (the numeric derivative's last digits differ between the packages)
    assert tmsg.split("(analytic=")[0] == jmsg.split("(analytic=")[0]
    ja, jn = (float(v) for v in jmsg.split("analytic=")[1].rstrip(")").split(", numeric="))
    ta, tn = (float(v) for v in tmsg.split("analytic=")[1].rstrip(")").split(", numeric="))
    np.testing.assert_allclose([ta, tn], [ja, jn], rtol=1e-6)


def test_numeric_diff_batch_is_skipped():
    """A batch differentiated numerically solves with its own numeric
    derivatives: comparing them with themselves tells nothing, so both
    packages skip it, wrong derivative and all."""
    (jok, _), (tok, tmsg) = _checks(bad_row=5, numeric_diff=True)
    assert jok and tok, tmsg


def test_check_gradients_through_solve_gives_jax_message():
    js = st.solve(JOptions(check_gradients=True), _problem("jax", bad_row=4))
    ts = stt.solve(SolverOptions(check_gradients=True, device="cpu"), _problem("torch", bad_row=4))
    assert ts.termination_type.value == js.termination_type.value == "FAILURE"
    assert ts.message.startswith("Gradient check failed: batch 'triple' (index 1)")
    assert ts.message.split("(analytic=")[0] == js.message.split("(analytic=")[0]
    assert not ts.iterations  # stopped before the first evaluation of the solve


def test_check_gradients_through_solve_passes_a_correct_problem():
    bal = jbal.synthetic_bal(4, 24, 3)
    kw = dict(check_gradients=True, max_num_iterations=3)
    js = st.solve(JOptions(**kw), jbal.build_bal_problem(bal)[0])
    ts = stt.solve(SolverOptions(device="cpu", **kw), tbal.build_bal_problem(bal)[0])
    assert len(ts.iterations) == len(js.iterations) == 4
    for a, b in zip(ts.iterations, js.iterations):
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
