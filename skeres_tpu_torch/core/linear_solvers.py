"""Linear solvers for the damped Gauss-Newton step.

PyTorch counterpart of ``skeres_tpu/core/linear_solvers.py`` (reference
lineage: ``internal/ceres/dense_normal_cholesky_solver.cc``,
``dense_qr_solver.cc``, ``cgnr_solver.cc``,
``conjugate_gradients_solver.cc``). Each solver is a function solving

    (J^T J + diag(d_clamped) / radius) step = -g

in the global tangent space. The dense products and factorizations here
are XLA's in the JAX package, outside any Pallas kernel, so they are
``torch.linalg`` and ``torch.matmul`` calls here.

Conventions: ``g = J^T r``; ``diag`` holds the squared column norms of J
(Jacobi-scaled); ``mu = 1 / trust_region_radius``. Each returns
``(step, iterations)``, the count as a device int64 scalar; a failed
solve gives a non-finite step, which the minimizer treats as an invalid
step.
"""

from __future__ import annotations

from typing import Callable

import torch

from skeres_tpu_torch.core.graph import while_loop

__all__ = [
    "cho_solve",
    "cholesky_nan",
    "lm_diagonal",
    "preconditioned_conjugate_gradients",
    "solve_cgnr",
    "solve_dense_normal_cholesky",
    "solve_dense_qr",
    "solve_dense_qr_seminormal",
]


def lm_diagonal(diag, mu, min_diagonal, max_diagonal):
    """Clamped LM regularizer (reference: LevenbergMarquardtStrategy): clamp
    each squared column norm to [min_diagonal, max_diagonal], scale by mu."""
    return torch.clamp(diag, min_diagonal, max_diagonal) * mu


def cholesky_nan(a):
    """Lower Cholesky factor of ``a`` (..., n, n), all NaN for each matrix
    that is not positive definite: ``torch.linalg.cholesky_ex`` returns
    garbage and an ``info`` there, and no host reads ``info`` here (the
    counterpart of ``jax.lax.linalg.cholesky``'s NaN fill)."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l, torch.nan)


def cho_solve(l, b):
    """x with L L^T x = b for a lower factor ``l`` and a vector ``b``, as two
    triangular solves: ``torch.cholesky_solve`` cannot be captured inside a
    conditional node of a CUDA graph (cudaErrorInvalidValue at the end of
    the capture; torch 2.11, CUDA 12.8), ``solve_triangular`` can."""
    y = torch.linalg.solve_triangular(l, b[:, None], upper=False)
    return torch.linalg.solve_triangular(l.T, y, upper=True)[:, 0]


def _one(device):
    return torch.ones((), dtype=torch.int64, device=device)


def solve_dense_normal_cholesky(jtj, g, diag, mu, min_diagonal, max_diagonal,
                                refinement_iterations: int = 0):
    """Cholesky of the damped normal equations (DENSE_NORMAL_CHOLESKY).

    With ``refinement_iterations > 0``, mixed-precision iterative refinement
    (reference: ``use_mixed_precision_solves`` and
    ``max_num_refinement_iterations``): the factor stays in the working
    dtype, the residuals are recomputed in float64 and each correction
    reuses the factor."""
    d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
    a = jtj + torch.diag(d)
    l = cholesky_nan(a)  # NaN on an indefinite matrix: an invalid step
    b = -g
    step = cho_solve(l, b)
    for _ in range(refinement_iterations):
        r64 = b.double() - a.double() @ step.double()
        step = step + cho_solve(l, r64.to(a.dtype))
    return step, _one(g.device)


def solve_dense_qr(j_dense, r_dense, diag, mu, min_diagonal, max_diagonal):
    """QR of the row-appended system [J; sqrt(damping)] (DENSE_QR): more
    stable than the normal equations; for small dense problems."""
    n = j_dense.shape[1]
    d = torch.sqrt(lm_diagonal(diag, mu, min_diagonal, max_diagonal))
    a = torch.cat([j_dense, torch.diag(d)], dim=0)
    b = torch.cat([-r_dense, r_dense.new_zeros(n)])
    q, rr = torch.linalg.qr(a)
    step = torch.linalg.solve_triangular(rr, (q.T @ b)[:, None], upper=True)[:, 0]
    return step, _one(r_dense.device)


def solve_dense_qr_seminormal(j_dense, r_dense, diag, mu, min_diagonal, max_diagonal):
    """DENSE_QR's step by the corrected seminormal equations, for the
    device loop on the card, where ``torch.linalg.qr`` cannot be captured
    inside a conditional node (cudaErrorInvalidValue when the capture
    ends; torch 2.11, CUDA 12.8). With ``A = [J; sqrt(D)]`` and
    ``b = [-r; 0]``: the triangle of A's QR up to signs, ``R = L^T`` with
    ``L L^T = A^T A = J^T J + D`` (``cholesky_ex``), the seminormal solve
    ``R^T R x = A^T b`` (two ``solve_triangular``), then one refinement on
    the residual of the row-appended system, ``x += (R^T R)^-1 A^T (b - A
    x)``, which brings the step to QR's accuracy while ``cond(A)`` stays
    well below ``eps^-1/2`` (Bjorck 1987). A failed factor gives a NaN
    step, as the Cholesky solvers do."""
    d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
    l = cholesky_nan(j_dense.T @ j_dense + torch.diag(d))
    b = -r_dense
    step = cho_solve(l, j_dense.T @ b)
    # A^T (b - A x) = J^T (b - J x) + sqrt(D) (0 - sqrt(D) x)
    step = step + cho_solve(l, j_dense.T @ (b - j_dense @ step) - d * step)
    return step, _one(r_dense.device)


def preconditioned_conjugate_gradients(
    matvec: Callable,
    b,
    precond_apply: Callable,
    max_iterations: int,
    rtol: float,
    min_iterations: int = 0,
    q_tolerance=None,
):
    """PCG on a PSD system A x = b (reference:
    ``internal/ceres/conjugate_gradients_solver.cc``), the counterpart of
    the JAX package's ``lax.while_loop``: the steps run under
    :func:`while_loop`, eagerly with one host read a step, under a CUDA
    graph capture as one WHILE node that reads nothing on the host.

    Termination, as the reference:

    - residual: ``||r|| <= rtol ||b||`` (CGNR, and DENSE_SCHUR's fallback);
    - with ``q_tolerance`` set, the Nash-Sofer (1990) test the reference
      uses for ITERATIVE_SCHUR: with ``Q(x) = 0.5 x'Ax - b'x``, stop when
      ``zeta = i (Q_i - Q_{i-1}) / Q_i`` drops below ``q_tolerance``. The
      test is enabled only for ``q_tolerance > 0``: near convergence Q is
      not monotonic in floating point, and a negative zeta would stop a
      caller that asked for a fixed number of steps.

    Returns (x, iterations), the count as a device int64 scalar."""
    tol2 = (rtol * rtol) * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    p = precond_apply(r).clone()  # updated in place: never r itself
    rz = torch.dot(r, p)
    iters = torch.zeros((), dtype=torch.int64, device=b.device)
    q_prev = torch.zeros((), dtype=b.dtype, device=b.device)
    q_stop = torch.zeros((), dtype=torch.bool, device=b.device)

    def running():
        rnorm2 = torch.dot(r, r)
        go = ((rnorm2 > tol2) | (iters < min_iterations)) & (iters < max_iterations)
        if q_tolerance is not None:
            go = go & ~q_stop
        return go & (rnorm2 > 0.0)

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
        if q_tolerance is not None:
            # Q(x) = 0.5 x'Ax - b'x = -0.5 (x'b + x'r) with r = b - Ax
            q = -0.5 * (torch.dot(x, b) + torch.dot(x, r))
            zeta = iters.to(q.dtype) * (q - q_prev) / torch.where(q != 0.0, q, 1.0)
            q_stop.copy_((q != 0.0) & (zeta < q_tolerance) & (q_tolerance > 0.0))
            q_prev.copy_(q)

    while_loop(running, step)
    return x, iters


def solve_cgnr(jtj_matvec: Callable, g, diag, mu, min_diagonal, max_diagonal,
               max_iterations: int, rtol, min_iterations: int = 0, make_precond=None):
    """CGNR: CG on (J^T J + damping) x = -g without forming J^T J
    (reference: ``internal/ceres/cgnr_solver.cc``), preconditioned by the
    diagonal of the damped normal equations (JACOBI) unless
    ``make_precond(d)`` builds another preconditioner from the damping
    ``d`` (SUBSET)."""
    d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
    if make_precond is None:
        m_inv = 1.0 / torch.clamp(diag + d, min=torch.finfo(g.dtype).tiny)
        precond = lambda v: m_inv * v  # noqa: E731
    else:
        precond = make_precond(d)
    return preconditioned_conjugate_gradients(
        lambda v: d * v + jtj_matvec(v), -g, precond, max_iterations, rtol, min_iterations
    )
