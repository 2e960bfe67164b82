"""Pieces of the damped Gauss-Newton solve shared by the linear solvers.

PyTorch counterpart of the parts of ``skeres_tpu/core/linear_solvers.py``
that DENSE_SCHUR uses: the clamped LM diagonal and the preconditioned
conjugate gradients of its fallback. The other linear solvers (DENSE_QR,
DENSE_NORMAL_CHOLESKY, CGNR) are still to port.

Conventions: ``diag`` holds the squared column norms of J (Jacobi-scaled)
and ``mu = 1 / trust_region_radius``.
"""

from __future__ import annotations

from typing import Callable

import torch

from skeres_tpu_torch.core.graph import cond

__all__ = ["lm_diagonal", "preconditioned_conjugate_gradients"]


def lm_diagonal(diag, mu, min_diagonal, max_diagonal):
    """Clamped LM regularizer (reference: LevenbergMarquardtStrategy): clamp
    each squared column norm to [min_diagonal, max_diagonal], scale by mu."""
    return torch.clamp(diag, min_diagonal, max_diagonal) * mu


def preconditioned_conjugate_gradients(
    matvec: Callable,
    b,
    precond_apply: Callable,
    max_iterations: int,
    rtol: float,
    min_iterations: int = 0,
):
    """PCG on a PSD system A x = b (reference:
    ``internal/ceres/conjugate_gradients_solver.cc``) with the residual
    test ||r|| <= rtol ||b||, the counterpart of the JAX package's
    ``lax.while_loop``. Each step runs under :func:`cond` on the test:
    eagerly one host read a step, and the loop stops where the test
    fails; under a CUDA graph capture, ``max_iterations`` IF nodes, whose
    bodies stop running on the device where the test fails, so the graph
    reads nothing on the host and does the early-stopping form's work.
    Returns (x, iterations), the count as a device int64 scalar."""
    tol2 = (rtol * rtol) * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    p = precond_apply(r).clone()  # updated in place: never r itself
    rz = torch.dot(r, p)
    active = torch.ones((), dtype=torch.bool, device=b.device)
    iters = torch.zeros((), dtype=torch.int64, device=b.device)

    def step():
        ap = matvec(p)
        pap = torch.dot(p, ap)
        alpha = torch.where(pap > 0.0, rz / torch.where(pap > 0.0, pap, 1.0), 0.0)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        z = precond_apply(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz > 0.0, rz, 1.0)
        p.copy_(z + beta * p)
        rz.copy_(rz_new)
        iters.add_(1)

    for i in range(max_iterations):
        rnorm2 = torch.dot(r, r)
        # once the test has failed r stays as it is, so it keeps failing
        active = active & ((rnorm2 > tol2) | (i < min_iterations)) & (rnorm2 > 0.0)
        if cond(active, step) is False:  # read on the host: stop here
            break
    return x, iters
