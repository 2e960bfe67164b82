"""The port's cubic interpolation against the JAX package's, float64 on
the CPU: values and gradients (``torch.func.grad`` against ``jax.grad``)
of the 1-D and 2-D Catmull-Rom interpolators, scalar- and vector-valued,
inside the grid and at and past its clipped edges, and under
``torch.func.vmap``; then an interpolated residual solved by both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.ops.interpolation import BiCubicInterpolator as JBi
from skeres_tpu.ops.interpolation import CubicInterpolator as JCubic
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.ops.interpolation import BiCubicInterpolator, CubicInterpolator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_RNG = np.random.default_rng(11)
_GRID1 = _RNG.normal(size=9)
_GRID1K = _RNG.normal(size=(9, 3))
_GRID2 = _RNG.normal(size=(6, 7))
_GRID2K = _RNG.normal(size=(6, 7, 2))
# inside, on sample points, at both edges, and past them (clipped)
_XS = [0.0, 0.37, 1.0, 3.5, 4.999, 7.25, 7.999, 8.0, 8.6, -0.4, -3.0, 11.0]
_RCS = [(0.0, 0.0), (1.3, 2.7), (2.0, 3.0), (4.99, 5.5), (5.0, 6.0), (5.4, 6.9), (-0.6, 1.2),
        (3.3, -2.0), (7.5, 8.5)]


def _close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-12, atol=1e-12, **kw)


@pytest.mark.parametrize("grid", ["scalar", "vector"])
@pytest.mark.parametrize("x", _XS)
def test_cubic_value_and_gradient_match_jax(grid, x):
    values = _GRID1 if grid == "scalar" else _GRID1K
    ti, ji = CubicInterpolator(values), JCubic(values)
    _close(ti(torch.tensor(x, dtype=torch.float64)), ji(jnp.asarray(x)))
    tg = torch.func.jacfwd(lambda v: ti(v))(torch.tensor(x, dtype=torch.float64))
    jg = jax.jacfwd(lambda v: ji(v))(jnp.asarray(x))
    _close(tg, jg, err_msg=f"gradient at {x}")


@pytest.mark.parametrize("grid", ["scalar", "vector"])
@pytest.mark.parametrize("rc", _RCS)
def test_bicubic_value_and_gradient_match_jax(grid, rc):
    values = _GRID2 if grid == "scalar" else _GRID2K
    ti, ji = BiCubicInterpolator(values), JBi(values)
    t_rc = torch.tensor(rc, dtype=torch.float64)
    j_rc = jnp.asarray(rc)
    _close(ti(t_rc[0], t_rc[1]), ji(j_rc[0], j_rc[1]))
    tg = torch.func.jacfwd(lambda p: ti(p[0], p[1]))(t_rc)
    jg = jax.jacfwd(lambda p: ji(p[0], p[1]))(j_rc)
    _close(tg, jg, err_msg=f"gradient at {rc}")


def test_interpolates_the_samples_and_batches_under_vmap():
    """On a sample point the value is the sample; a batch of queries under
    vmap equals the queries one by one, gradients included."""
    ti, bi = CubicInterpolator(_GRID1), BiCubicInterpolator(_GRID2)
    for i in range(9):
        assert float(ti(torch.tensor(float(i), dtype=torch.float64))) == pytest.approx(
            _GRID1[i], abs=1e-14)
    xs = torch.tensor(_XS, dtype=torch.float64)
    _close(torch.func.vmap(ti)(xs), [float(ti(x)) for x in xs])
    _close(torch.func.vmap(torch.func.grad(ti))(xs), [float(torch.func.grad(ti)(x)) for x in xs])
    rcs = torch.tensor(_RCS, dtype=torch.float64)
    _close(torch.func.vmap(lambda p: bi(p[0], p[1]))(rcs), [float(bi(p[0], p[1])) for p in rcs])


def test_interpolated_residual_solves_as_in_jax():
    """Fit (a, s) so that a * f(s * t) matches samples of the cubic f at
    scale 0.8 (Ceres's interpolated-residual pattern): the same costs in
    both packages to rtol 1e-8."""
    grid = np.sin(np.linspace(0.0, 3.0, 31)) + 0.1 * np.arange(31)
    ts = np.linspace(0.5, 20.0, 25)
    target = np.asarray(JCubic(grid)(jnp.asarray(0.8 * ts))) * 1.3
    out = []
    for mod, interp, Options, xp, kw in ((st, JCubic(grid), JOptions, jnp, {}),
                                         (stt, CubicInterpolator(grid), SolverOptions, torch,
                                          dict(device="cpu"))):
        problem = mod.Problem()
        p = problem.add_parameter_block([1.0, 0.7])
        problem.add_residual_blocks(
            lambda params, data, interp=interp: (params[0][0] * interp(params[0][1] * data[0])
                                                 - data[1])[None],
            None, [(p.array, np.zeros(len(ts), dtype=np.int32))],
            data=np.stack([ts, target], axis=1))
        s = mod.solve(Options(max_num_iterations=30, **kw), problem)
        out.append(([it.cost for it in s.iterations], np.asarray(p.value)))
    (jc, jp), (tc, tp) = out
    assert len(tc) == len(jc)
    np.testing.assert_allclose(tc, jc, rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(tp, jp, rtol=1e-8)
    np.testing.assert_allclose(tp, [1.3, 0.8], rtol=1e-5)
