"""The port's NIST StRD registry against the JAX package's, float64 on the
CPU: the data, the starts and the certified values are the same; every
model at every start equals the JAX package's; and every (problem, start)
fitted by both packages with the options of ``tests/test_nist.py``
(DENSE_QR, nonmonotonic steps, tolerances 1e-16, 1500 steps): the port
certifies exactly where the JAX package does (the hard starts of
``tests/test_nist.py`` fail to certify in both), with the same residual
sum of squares. The problems whose ``.dat`` files are absent skip, as in
the JAX package's test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.io import nist_strd as jnist
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io import nist_strd as tnist

# tests/test_nist.py's starts that do not reach the certified minimum
HARD_STARTS = {("MGH09", 0), ("MGH10", 0), ("MGH17", 0), ("BoxBOD", 0), ("BoxBOD", 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_registry_matches_jax():
    assert list(tnist.PROBLEMS) == list(jnist.PROBLEMS)
    assert tnist.EMBEDDED == jnist.EMBEDDED and tnist.FILE_GATED == jnist.FILE_GATED
    assert len(tnist.EMBEDDED) == 17
    for name, t in tnist.PROBLEMS.items():
        j = jnist.PROBLEMS[name]
        assert (t.starts, t.certified_params, t.certified_ssr, t.difficulty, t.data_file,
                t.log_response) == (j.starts, j.certified_params, j.certified_ssr, j.difficulty,
                                    j.data_file, j.log_response)
        if t.y is not None:
            np.testing.assert_array_equal(t.y, j.y)
            np.testing.assert_array_equal(t.X, j.X)


def test_load_dat_reads_as_jax(tmp_path):
    text = ("NIST/ITL StRD\nDataset Name:  Example\n\nData:   y   x1   x2\n"
            "  1.5   2.0  3.0\n\n  -4.25e-1  5  6.5\n")
    (tmp_path / "ex.dat").write_text(text)
    ty, tx = tnist.load_dat(str(tmp_path / "ex.dat"))
    jy, jx = jnist.load_dat(str(tmp_path / "ex.dat"))
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, [1.5, -0.425])


CASES = [(name, si) for name in tnist.EMBEDDED for si in range(len(tnist.PROBLEMS[name].starts))]
GATED = [(name, si) for name in tnist.FILE_GATED
         for si in range(len(tnist.PROBLEMS[name].starts))]


@pytest.mark.parametrize("name,start", CASES)
def test_model_at_start_matches_jax(name, start):
    y, X = tnist.PROBLEMS[name].data()
    b0 = np.asarray(tnist.PROBLEMS[name].starts[start], dtype=np.float64)
    t = tnist.PROBLEMS[name].model(torch.as_tensor(b0), torch.as_tensor(X))
    j = jnist.PROBLEMS[name].model(jnp.asarray(b0), jnp.asarray(X))
    assert t.shape == y.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-300)


def _fit(pkg, prob, b0):
    y, X = prob.data()
    if prob.log_response:
        y = np.log(y)
    problem = (st if pkg == "jax" else stt).Problem()
    b = problem.add_parameter_block(np.asarray(b0, dtype=np.float64))
    problem.add_residual_blocks(
        lambda params, data: data[0:1] - prob.model(params[0], data[None, 1:]), None,
        [(b.array, np.zeros(len(y), dtype=np.int32))],
        data=np.concatenate([y.reshape(-1, 1), X], axis=1))
    kw = dict(max_num_iterations=1500, use_nonmonotonic_steps=True, function_tolerance=1e-16,
              gradient_tolerance=1e-16, parameter_tolerance=1e-16)
    if pkg == "jax":
        s = st.solve(JOptions(linear_solver_type=JLinearSolverType.DENSE_QR, **kw), problem)
    else:
        s = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_QR, device="cpu",
                                    **kw), problem)
    return 2.0 * s.final_cost


def _certified(prob, ssr):
    """tests/test_nist.py's test: the certified SSR to rtol 1e-6, or, for
    Lanczos1 (certified 1.4e-25, at float64's noise floor), below 1e-20."""
    if prob.certified_ssr < 1e-20:
        return ssr < 1e-20
    return abs(ssr - prob.certified_ssr) <= 1e-6 * prob.certified_ssr


def _check(name, start):
    t, j = tnist.PROBLEMS[name], jnist.PROBLEMS[name]
    jssr, tssr = _fit("jax", j, j.starts[start]), _fit("torch", t, t.starts[start])
    assert _certified(t, tssr) == _certified(j, jssr) == ((name, start) not in HARD_STARTS), \
        (tssr, jssr)
    if t.certified_ssr < 1e-20 and (name, start) not in HARD_STARTS:
        assert tssr < 1e-20  # both at the noise floor: no relative comparison
    else:
        np.testing.assert_allclose(tssr, jssr, rtol=1e-6)


@pytest.mark.parametrize("name,start", CASES)
def test_certifies_as_jax(name, start):
    _check(name, start)


@pytest.mark.parametrize("name,start", GATED)
def test_file_gated_certifies_as_jax(name, start):
    if tnist.PROBLEMS[name].data() is None:
        pytest.skip(f"data/nist/{tnist.PROBLEMS[name].data_file} is absent")
    _check(name, start)
