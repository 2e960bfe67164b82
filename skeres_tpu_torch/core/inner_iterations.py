"""Inner iterations: coordinate descent over an independent parameter group.

PyTorch counterpart of ``skeres_tpu/core/inner_iterations.py`` (reference
lineage: ``internal/ceres/inner_iteration_minimizer.cc``,
``coordinate_descent_minimizer.cc``): after a trust-region candidate is
computed, the blocks of an *independent* group (no residual couples two of
its blocks: the BA points) are re-optimized with everything else fixed,
before the candidate's cost decides the step.

All blocks refine at once: a sweep is one full evaluation, per-block
(t x t) damped normal equations summed over the batches that touch the
group (``index_add_``, whose float32 sum order on the card changes from
run to run), one batched Cholesky (``cholesky_ex``, NaN where a block is
not positive definite) and two triangular solves (``torch.cholesky_solve``
cannot be captured inside a conditional node of a CUDA graph), a zero step
where the solve is not finite or the block is constant, and
``manifold.plus``. The row products are multiply-and-sum, not ``einsum``
(the JAX package's ``vpu_einsum`` works around the TPU's matrix tiles).

With ``tolerance > 0`` the sweeps stop once a sweep's relative cost
decrease falls below it: a :func:`while_loop` on a device-side cost, so a
captured LM step holds it as a WHILE node and the host reads nothing. The
independent group is the one declared with
``set_schur_elimination_group(arr, 0)``. Under a mesh the per-block
normal equations are summed over the rank's rows and reduced over the
ranks (one ``all_reduce`` each), and the solves are replicated.
"""

from __future__ import annotations

import torch

from skeres_tpu_torch.core.graph import while_loop
from skeres_tpu_torch.core.linear_solvers import cholesky_nan

__all__ = ["InnerIterationRefiner"]


class InnerIterationRefiner:
    """``refine(state) -> state`` over the independent group."""

    def __init__(self, evaluator, num_sweeps: int = 1, damping: float = 1e-9,
                 tolerance: float = 0.0):
        self.ev = evaluator
        self.num_sweeps = int(num_sweeps)
        self.damping = float(damping)
        # reference: Solver::Options::inner_iteration_tolerance
        self.tolerance = float(tolerance)
        program = evaluator.program
        elim = [i for i, g in enumerate(program.groups) if g.schur_group == 0]
        if len(elim) != 1:
            raise ValueError(
                "inner iterations need exactly one independent group "
                "(set_schur_elimination_group(arr, 0))"
            )
        self.group = elim[0]
        g = program.groups[self.group]
        self.t, self.n_blocks, self.manifold = g.tangent_size, g.num_blocks, g.manifold
        dev, dtype = evaluator.device, evaluator.dtype
        self._free = torch.tensor([0.0 if c else 1.0 for c in g.constant], dtype=dtype,
                                  device=dev)[:, None]
        self._eye = torch.eye(self.t, dtype=dtype, device=dev)
        # per batch: None, or the group's tangent columns and each row's block
        self.batch_cols = []
        for bi, b in enumerate(program.batches):
            slots = [s for s, gi in enumerate(b.slot_groups) if gi == self.group]
            if not slots:
                self.batch_cols.append(None)
                continue
            if len(slots) > 1:
                raise ValueError(
                    "group is not independent: a residual block touches two of its "
                    "parameter blocks"
                )
            c0 = sum(b.tangent_sizes[: slots[0]])
            lo, hi = evaluator.row_range[bi]  # the rows the evaluator holds
            self.batch_cols.append((slice(c0, c0 + self.t),
                                    torch.as_tensor(b.slot_indices[slots[0]][lo:hi]).to(dev)))

    def _sweep(self, state):
        """One Gauss-Newton sweep over the group: its new (n, size) values."""
        ev, t = self.ev, self.t
        _, blocks = ev.blocks(state)
        h = torch.zeros((self.n_blocks, t, t), dtype=ev.dtype, device=ev.device)
        rhs = torch.zeros((self.n_blocks, t), dtype=ev.dtype, device=ev.device)
        for cols_idx, b in zip(self.batch_cols, blocks):
            if cols_idx is None:
                continue
            cols, pidx = cols_idx
            jac = b.jac[:, :, cols]  # (B, m, t)
            h.index_add_(0, pidx, (jac[:, :, :, None] * jac[:, :, None, :]).sum(1))
            rhs.index_add_(0, pidx, -(jac * b.r[:, :, None]).sum(1))
        ev.all_reduce(h)  # under a mesh, over every rank's rows
        ev.all_reduce(rhs)
        h = h + self.damping * self._eye
        chol = cholesky_nan(h)
        y = torch.linalg.solve_triangular(chol, rhs[:, :, None], upper=False)
        step = torch.linalg.solve_triangular(chol.transpose(1, 2), y, upper=True)[:, :, 0]
        step = torch.where(torch.isfinite(step), step, 0.0) * self._free
        x = state[self.group]
        return self.manifold.plus(x, step.to(x.dtype))

    def _with(self, state, x):
        return tuple(x if gi == self.group else s for gi, s in enumerate(state))

    def refine(self, state):
        """``num_sweeps`` sweeps, or with a tolerance as many as keep the
        relative cost decrease of a sweep above it."""
        if self.num_sweeps == 1 or self.tolerance <= 0.0:
            for _ in range(self.num_sweeps):
                state = self._with(state, self._sweep(state))
            return state
        ev = self.ev
        x = state[self.group].clone()  # the loop's carry, written in place
        cost = ev.cost(state)
        decrease = torch.full((), float("inf"), dtype=ev.dtype, device=ev.device)
        i = torch.zeros((), dtype=torch.int64, device=ev.device)

        def body():
            new_x = self._sweep(self._with(state, x))
            new_cost = ev.cost(self._with(state, new_x))
            decrease.copy_(cost - new_cost)
            cost.copy_(new_cost)
            x.copy_(new_x)
            i.add_(1)

        while_loop(lambda: (i < self.num_sweeps) & (decrease > self.tolerance * torch.abs(cost)),
                   body)
        return self._with(state, x)
