"""Numeric differentiation in the tangent space.

PyTorch counterpart of ``numeric_jacobian`` and ``ridders_jacobian`` of
``skeres_tpu/core/gradient_checker.py`` (reference lineage:
``internal/ceres/numeric_diff.h``): the evaluator differentiates a batch
added with ``numeric_diff=True`` by these instead of ``torch.func``. Each
takes ``f: (T,) -> (m,)``, one residual block through ``manifold.plus``,
and returns its (m, T) Jacobian at the tangent origin; each runs under
``torch.func.vmap`` over the blocks of a batch. The gradient checker
itself (``check_gradients``) is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["numeric_jacobian", "ridders_jacobian"]


def numeric_jacobian(f, zero, relative_step_size: float = 1e-6, method: str = "central"):
    """Central- or forward-difference Jacobian of ``f`` at ``zero`` (T,).

    The step is ``relative_step_size`` around the zero tangent, which has
    no scale, so the relative step is an absolute one (the reference's at
    x = 0)."""
    h = relative_step_size
    basis = torch.eye(zero.shape[-1], dtype=zero.dtype, device=zero.device)
    if method == "forward":
        f0 = f(zero)

        def col(e):
            return (f(h * e) - f0) / h

    elif method == "central":

        def col(e):
            return (f(h * e) - f(-h * e)) / (2.0 * h)

    else:
        raise ValueError(
            f"unknown numeric_diff_method {method!r} "
            "(expected 'central', 'forward', or 'ridders')"
        )
    return torch.func.vmap(col)(basis).transpose(0, 1)  # (m, T)


def ridders_jacobian(f, zero, relative_step_size: float = 1e-2, max_extrapolations: int = 5,
                     step_shrink: float = 2.0):
    """Ridders-extrapolated numeric Jacobian of ``f`` at ``zero`` (T,)
    (reference: ``numeric_diff.h`` RIDDERS, after Numerical Recipes
    ``dfridr``). Central differences at the steps h, h/s, h/s^2, ... fill
    the first column of a Neville tableau, Richardson extrapolation in h^2
    removes the even error terms, and each output element takes the entry
    whose adjacent-entry difference is least. As in the JAX package the
    tableau is a fixed ``max_extrapolations`` levels (the reference stops
    early per coordinate)."""
    n = max_extrapolations
    s2 = step_shrink * step_shrink
    dtype, device = zero.dtype, zero.device
    basis = torch.eye(zero.shape[-1], dtype=dtype, device=device)
    hs = relative_step_size / (step_shrink ** torch.arange(n, dtype=dtype, device=device))

    def col(e):
        d0 = torch.func.vmap(lambda h: (f(h * e) - f(-h * e)) / (2.0 * h))(hs)
        tableau = [d0[i] for i in range(n)]
        best = tableau[0]
        best_err = torch.full_like(best, float("inf"))
        fac = 1.0
        for j in range(1, n):
            fac = fac * s2
            nxt = []
            for i in range(n - j):
                t_ij = (tableau[i + 1] * fac - tableau[i]) / (fac - 1.0)
                err = torch.maximum(torch.abs(t_ij - tableau[i]), torch.abs(t_ij - tableau[i + 1]))
                if i == 0:
                    take = err <= best_err
                    best = torch.where(take, t_ij, best)
                    best_err = torch.where(take, err, best_err)
                nxt.append(t_ij)
            tableau = nxt
        return best

    return torch.func.vmap(col)(basis).transpose(0, 1)  # (m, T)
