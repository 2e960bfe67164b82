"""Numeric differentiation in the tangent space, and the gradient checker.

PyTorch counterpart of ``skeres_tpu/core/gradient_checker.py`` (reference
lineage: ``internal/ceres/numeric_diff.h``, ``include/ceres/gradient_checker.h``,
``internal/ceres/gradient_checking_cost_function.cc``):

  - ``numeric_jacobian`` and ``ridders_jacobian``: the evaluator
    differentiates a batch added with ``numeric_diff=True`` by these
    instead of ``torch.func``. Each takes ``f: (T,) -> (m,)``, one residual
    block through ``manifold.plus``, and returns its (m, T) Jacobian at the
    tangent origin; each runs under ``torch.func.vmap`` over the blocks of
    a batch.
  - ``check_program_gradients`` (``SolverOptions.check_gradients``): every
    batch's ``torch.func`` Jacobian against central differences at the
    initial state, with the JAX package's thresholds and message. The JAX
    form takes a whole batch in one vmapped call; here the rows go in the
    evaluator's chunks (``evaluation_chunk_size``), so that a large batch
    never holds its 2T trial evaluations of every row at once.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["check_program_gradients", "numeric_jacobian", "ridders_jacobian"]


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


def check_program_gradients(program, evaluator, relative_precision: float = 1e-8,
                            step_size: float = 1e-6) -> Tuple[bool, str]:
    """Every batch's Jacobian as the solver takes it
    (``Evaluator.jacobian_rows``: its ``torch.func`` Jacobian, or the closed
    form of a batch evaluated by its batched form) against central
    differences at the initial state, in the tangent space of each block
    (through ``manifold.plus``, as the solver's Jacobians), without the
    robust loss or the constant blocks' mask, as in the JAX package.
    Batches added with ``numeric_diff`` are skipped: they solve with
    numeric derivatives.

    Returns (ok, message); the message names the first offending batch,
    the worst relative error and where it is (block, residual, tangent
    coordinate), in the JAX package's words. An entry smaller than
    sqrt(relative_precision) is compared absolutely; a batch fails when its
    worst error exceeds both ``relative_precision * 1e4`` and
    ``sqrt(step_size)``."""
    ev = evaluator
    state = program.initial_state(ev.device, ev.dtype)
    floor = math.sqrt(relative_precision)

    for bi, batch in enumerate(program.batches):
        if batch.numeric_diff:
            continue
        manifolds = [program.groups[gi].manifold for gi in batch.slot_groups]
        T = batch.block_tangent_size
        zero = torch.zeros(T, dtype=ev.dtype, device=ev.device)

        def one_block(data_row, *x_row):
            def f(delta):
                ds = torch.split(delta, batch.tangent_sizes)
                xp = tuple(m.plus(x, d) for m, x, d in zip(manifolds, x_row, ds))
                return batch.fn(xp, None if batch.data is None else data_row)

            return numeric_jacobian(f, zero, step_size)

        # the worst entry over the batch, chunk by chunk (the first of equal
        # maxima, as numpy's argmax over the whole batch)
        worst, where = -1.0, None
        for rows in ev._row_slices(bi):
            data, idx = ev._chunk_args(bi, rows)
            ja = ev.jacobian_rows(bi, rows, state)[1]
            jn = torch.func.vmap(one_block)(data, *ev._gather_slots(batch, idx, state))
            denom = torch.clamp(torch.maximum(ja.abs(), jn.abs()), min=floor)
            rel = ((ja - jn).abs() / denom).reshape(-1)
            if rel.numel() == 0:
                continue
            k = torch.argmax(rel)
            w, k, a, n = torch.stack([t.to(torch.float64) for t in (
                rel[k], k, ja.reshape(-1)[k], jn.reshape(-1)[k])]).tolist()
            if w > worst:
                k = int(k)
                block = (rows.start or 0) + k // (ja.shape[1] * T)
                worst, where = w, (block, (k // T) % ja.shape[1], k % T, a, n)
        if where is not None and worst > relative_precision * 1e4 and worst > math.sqrt(step_size):
            block, res, coord, a, n = where
            return False, (
                f"batch '{batch.name}' (index {bi}): max relative error "
                f"{worst:.3e} at block {block}, residual {res}, "
                f"tangent coord {coord} (analytic={a:.6e}, "
                f"numeric={n:.6e})"
            )
    return True, ""
