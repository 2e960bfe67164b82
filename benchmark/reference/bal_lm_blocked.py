"""The plain reference of ``reference/bal_lm.py``, with every sum by camera
and by point computed a block of owners at a time: the same
Levenberg-Marquardt, the same Snavely model and the same formulas, in
plain torch, float64, with nothing of the program under test.

``BalLM`` sums an owner's rows by one gather of every row through the
owner grid, so a per-row quantity of width D costs a (owners, most rows,
D) gather beside its (rows, D) source: at BAL Final's 28,987,644
observations the camera blocks ``F^T F`` and the SCHUR_JACOBI blocks of
S (D = 81) would each take about 19 GB, and ``_prepare`` about 60 GB of
transients. Here each such sum runs over blocks of owners whose rows
number about ``ROWS_PER_BLOCK``: the block's rows are gathered through
the same grid, their values computed from the stored per-row Jacobians,
and summed in the grid's order (each owner's rows in row order, as
``BalLM``'s). Only r, the Jacobian rows and the per-row ``A = F^T E``
blocks are held whole (about 12 GB at Final).

It solves ITERATIVE_SCHUR with SCHUR_JACOBI, the solver of the cells
that need it; anything else raises, as ``BalLM`` does for what it does
not solve.
"""

from __future__ import annotations

import torch

from benchmark.reference.bal_lm import ROWS_PER_CHUNK, BalLM

__all__ = ["BalLMBlocked", "ROWS_PER_BLOCK"]

ROWS_PER_BLOCK = 1 << 21  # rows (padded slots included) summed at once


def _sum_by_blocks(grid: torch.Tensor, num_rows: int, rows_fn) -> torch.Tensor:
    """Per owner of ``grid`` (n, kmax), padded with ``num_rows``: the sum
    of ``rows_fn(rows)`` (len(rows), ...) over its rows, a block of
    owners at a time. A padded slot reads row 0 and counts as zero."""
    n, kmax = grid.shape
    step = max(1, ROWS_PER_BLOCK // max(kmax, 1))
    out = []
    for o0 in range(0, n, step):
        flat = grid[o0 : o0 + step].reshape(-1)
        valid = flat < num_rows
        vals = rows_fn(torch.where(valid, flat, 0))
        vals = torch.where(valid.view(-1, *([1] * (vals.dim() - 1))), vals, vals.new_zeros(()))
        out.append(vals.view(-1, kmax, *vals.shape[1:]).sum(dim=1))
    return torch.cat(out)


class BalLMBlocked(BalLM):
    """``BalLM`` with its sums by owner taken a block of owners at a time."""

    def _by_camera(self, rows_fn):
        return _sum_by_blocks(self.camera_rows, self.num_rows, rows_fn)

    def _by_point(self, rows_fn):
        return _sum_by_blocks(self.point_rows, self.num_rows, rows_fn)

    def _prepare(self, r, jc, jp):
        """What every damped solve of one linearization shares, as
        ``BalLM._prepare`` gives it."""
        ci, pi = self.ci, self.pi
        g_c = self._by_camera(lambda k: torch.einsum("bmi,bm->bi", jc[k], r[k]))
        g_p = self._by_point(lambda k: torch.einsum("bmi,bm->bi", jp[k], r[k]))
        d_c = self._by_camera(lambda k: torch.sum(jc[k] * jc[k], dim=1))
        d_p = self._by_point(lambda k: torch.sum(jp[k] * jp[k], dim=1))
        s_c, s_p = 1.0 / (1.0 + torch.sqrt(d_c)), 1.0 / (1.0 + torch.sqrt(d_p))

        def fs(k):
            return jc[k] * s_c[ci[k]][:, None, :]

        def es(k):
            return jp[k] * s_p[pi[k]][:, None, :]

        a = torch.empty((self.num_rows, 9, 3), dtype=self.dtype, device=self.device)
        for lo in range(0, self.num_rows, ROWS_PER_CHUNK):
            k = torch.arange(lo, min(lo + ROWS_PER_CHUNK, self.num_rows), device=self.device)
            a[k] = torch.einsum("bmi,bmj->bij", fs(k), es(k))
        return dict(
            g_c=g_c, g_p=g_p, s_c=s_c, s_p=s_p,
            gs_c=g_c * s_c, gs_p=g_p * s_p, ds_c=d_c * s_c * s_c, ds_p=d_p * s_p * s_p,
            u=self._by_camera(lambda k: torch.einsum("bmi,bmj->bij", fs(k), fs(k))),
            v=self._by_point(lambda k: torch.einsum("bmi,bmj->bij", es(k), es(k))),
            a=a,
        )

    def damped_step(self, lin, mu: float, opts: dict):
        """``BalLM.damped_step`` for ITERATIVE_SCHUR with SCHUR_JACOBI:
        (y_c (nc, 9), y_p (npt, 3), linear solver iterations)."""
        if not (opts["linear_solver_type"] == "ITERATIVE_SCHUR"
                and opts["preconditioner_type"] == "SCHUR_JACOBI"):
            raise ValueError(f"the blocked reference solves ITERATIVE_SCHUR with SCHUR_JACOBI, "
                             f"not {opts['linear_solver_type']} with "
                             f"{opts.get('preconditioner_type')}")
        nc, ci, pi, a = self.nc, self.ci, self.pi, lin["a"]
        lo, hi = opts["min_lm_diagonal"], opts["max_lm_diagonal"]
        d_c = torch.clamp(lin["ds_c"], lo, hi) * mu
        d_p = torch.clamp(lin["ds_p"], lo, hi) * mu
        cinv = torch.linalg.inv(lin["v"] + torch.diag_embed(d_p))
        b_p = -lin["gs_p"]
        y_p0 = torch.einsum("pij,pj->pi", cinv, b_p)
        rhs = -lin["gs_c"] - self._by_camera(
            lambda k: torch.einsum("bij,bj->bi", a[k], y_p0[pi[k]]))
        u_d = lin["u"] + torch.diag_embed(d_c)
        blocks = u_d - self._by_camera(
            lambda k: torch.bmm(torch.bmm(a[k], cinv[pi[k]]), a[k].transpose(1, 2)))
        binv = torch.linalg.inv(blocks)

        def matvec(v):
            v = v.view(nc, 9)
            w = self._by_point(lambda k: torch.einsum("bji,bj->bi", a[k], v[ci[k]]))
            wc = torch.einsum("pij,pj->pi", cinv, w)
            out = torch.einsum("cij,cj->ci", u_d, v) - self._by_camera(
                lambda k: torch.einsum("bij,bj->bi", a[k], wc[pi[k]]))
            return out.reshape(-1)

        def precond(v):
            return torch.einsum("cij,cj->ci", binv, v.view(nc, 9)).reshape(-1)

        y, iterations = self._pcg(matvec, rhs.reshape(-1), precond,
                                  opts["max_linear_solver_iterations"], opts["eta"])
        y_c = y.view(nc, 9)
        y_p = torch.einsum("pij,pj->pi", cinv, b_p - self._by_point(
            lambda k: torch.einsum("bji,bj->bi", a[k], y_c[ci[k]])))
        return y_c, y_p, iterations
