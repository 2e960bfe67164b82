"""The port's CUDA kernels on a card: each kernel against its plain
PyTorch version, and a small solve on the card against the same solve on
the CPU. Every case carries the ``gpu`` marker and skips without a CUDA
card. The file imports no jax, so that it also runs on a machine with a
card and no jax:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` configures jax).
"""

import numpy as np
import pytest
import torch

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
from skeres_tpu_torch.ops import cholesky as k1
from skeres_tpu_torch.ops import pair_product as k3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _spd(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_k1_matches_plain_version_on_card(cuda, dtype, tol):
    """Max-abs error of L and L^-1 within ``tol`` of max|reference|: float32
    rounding over n-term sums at n <= 1024, and float64's."""
    before = k1.cholesky_both.launches
    for n in (1, 37, 441, 1024):
        a = torch.tensor(_spd(n), dtype=dtype, device=cuda)
        l, linv = k1.cholesky_both(a)
        l_ref, linv_ref = k1.cholesky_both_reference(a)
        torch.cuda.synchronize()
        for x, ref in ((l, l_ref), (linv, linv_ref)):
            assert float((x - ref).abs().max()) <= tol * float(ref.abs().max())
    assert k1.cholesky_both.launches == before + 4
    bad = -torch.eye(8, dtype=dtype, device=cuda)
    l, linv = k1.cholesky_both(bad)
    assert torch.isnan(l).all() and torch.isnan(linv).all()


@pytest.mark.gpu
def test_solve_on_card_matches_cpu(cuda):
    """A float64 DENSE_SCHUR solve on the card (K1) and on the CPU (plain
    versions): the same steps and costs to rtol 1e-8."""
    bal = synthetic_bal(6, 60, 4)
    before = k1.cholesky_both.launches
    runs = []
    for device in (cuda, "cpu"):
        problem, _, _ = build_bal_problem(bal)
        runs.append(stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=5,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            dtype=torch.float64, device=device,
        ), problem))
    card, cpu = runs
    assert k1.cholesky_both.launches >= before + card.num_linear_solves > before
    assert [it.step_is_successful for it in card.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_k2_matches_plain_version_on_card(cuda, dtype, tol):
    """K2 (K1 panels + GEMM updates) against cuSOLVER's factor: L and a
    solve within ``tol`` of max|reference|, a short last panel included;
    a failed panel makes the solve non-finite."""
    n, panel = 1100, 256
    a = torch.tensor(_spd(n), dtype=dtype, device=cuda)
    before = k1.cholesky_both.launches
    fac = k1.blocked_cholesky_factor(a, panel=panel)
    assert k1.cholesky_both.launches == before + 5  # one K1 launch a panel
    l_ref = k1.blocked_cholesky_factor_reference(a)
    b = torch.ones(n, dtype=dtype, device=cuda)
    x = k1.blocked_chol_solve(fac, b)
    x_ref = torch.cholesky_solve(b[:, None], l_ref)[:, 0]
    torch.cuda.synchronize()
    for got, ref in ((fac.l, l_ref), (x, x_ref)):
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    a[700, 700] = -1.0
    assert not torch.isfinite(k1.blocked_chol_solve(k1.blocked_cholesky_factor(a, panel), b)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("f,e,kp", [(9, 3, 5), (5, 3, 6)])
def test_k3_matches_plain_version_on_card(cuda, dtype, tol, f, e, kp):
    """K3 against its plain version on random inputs, every row within
    ``tol`` of max|reference|; an unsupported (f, e) raises."""
    rng = np.random.default_rng(kp)
    p = 1000
    iu, ju = np.triu_indices(kp, k=1)
    args = [
        torch.tensor(rng.standard_normal((p, kp * f * e)), dtype=dtype, device=cuda),
        torch.tensor(rng.standard_normal((p, e * e)), dtype=dtype, device=cuda),
        torch.tensor(rng.random((p, len(iu))) < 0.5, device=cuda),
        torch.tensor(rng.random((p, len(iu))) < 0.8, device=cuda),
        torch.tensor(np.stack([iu, ju]).astype(np.int32), device=cuda),
    ]
    before = k3.pair_products.launches
    got = k3.pair_products(*args, f, e)
    ref = k3.pair_products_reference(*args, f, e)
    torch.cuda.synchronize()
    assert k3.pair_products.launches == before + 1
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    # the same grid read as (f, e) = (e, f): consistent shapes, no instance
    cinv_t = torch.zeros((p, f * f), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="instantiated"):
        k3.pair_products(args[0], cinv_t, *args[2:], e, f)
