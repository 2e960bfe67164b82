"""The evaluator: batched residual and tangent-Jacobian evaluation.

PyTorch counterpart of ``skeres_tpu/core/evaluator.py`` (reference
lineage: ``internal/ceres/program_evaluator.h``). Each homogeneous batch
evaluates as ONE vmapped program,

    r, J = vmap(one block: fn ∘ manifold.plus at delta = 0, with its
                tangent Jacobian from m vjp rows or T jvp columns)(blocks)

followed by the robust-loss (Triggs) correction, and the normal equations
are assembled by planned segment reductions (``ops/segment_reduce.py``).
The JAX package pads every batch with weight-0 copies of row 0 so that
chunks and shards have static shapes; PyTorch needs no static shapes, so
the port has no pad rows and a short last chunk instead.

Constant blocks keep their tangent columns, zeroed, as in the JAX package
(its free mask, ``Program.free_mask``): the Jacobian columns of a constant
block, and its share of every step (``plus``, ``tangent_diff``). The JAX
package multiplies each batch by a (B, T) copy of the mask; here each slot
whose group holds a constant block multiplies its columns by its rows'
(B,) block flags, which is the same product and no (B, T) array (180 MB at
venice shape). ``project_bounds`` clamps a state into the bounds box.

Under a mesh (``mesh=``, ``parallel/mesh.py``) the evaluator holds this
rank's contiguous range of every batch's rows (``row_range``, the JAX
package's shard convention) and ignores ``chunk_size``, as the JAX package
does (``skeres_tpu/core/evaluator.py:84-87``): a shard is already a chunk.
Every reduction over rows is local, then one ``all_reduce``: ``cost``, the
cost of ``blocks``, every ``slot_reduce`` (and so ``gradient_and_diag`` and
``jtj_matvec``), ``jtj_dense``; ``jacobian_dense`` gathers the ranks' rows
in rank order. ``blocks`` returns the rank's rows only.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from skeres_tpu_torch.core.gradient_checker import numeric_jacobian, ridders_jacobian
from skeres_tpu_torch.core.problem import CompiledBatch, Program
from skeres_tpu_torch.ops.corrector import apply_loss
from skeres_tpu_torch.ops.segment_reduce import (
    apply_reduce_plan,
    apply_sharded_reduce_plan,
    build_reduce_plan,
    build_sharded_reduce_plan,
)
from skeres_tpu_torch.parallel.mesh import all_reduce_sum, check_obs_mesh, shard_rows

__all__ = ["Evaluator", "BatchBlocks"]


class BatchBlocks(NamedTuple):
    """One batch's corrected residuals and Jacobian blocks."""

    r: torch.Tensor  # (B, m)
    jac: torch.Tensor  # (B, m, T)
    idx: torch.Tensor  # (B, T) global tangent indices


def _to_device(a, device, dtype):
    t = torch.as_tensor(a)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


def _row_data(batch: CompiledBatch, data_row):
    """One block's constants as its residual function takes them."""
    return None if batch.data is None else data_row


class Evaluator:
    """Evaluation functions over a compiled Program, on one device, or
    with ``mesh`` over this rank's share of the rows."""

    def __init__(
        self,
        program: Program,
        device,
        dtype=torch.float64,
        chunk_size: Optional[int] = None,
        diff_mode: str = "auto",
        apply_loss_function: bool = True,
        mesh=None,
    ):
        if diff_mode not in ("auto", "forward", "reverse"):
            raise ValueError(f"jacobian_diff_mode {diff_mode!r}")
        self.program = program
        self.device = torch.device(device)
        self.dtype = dtype
        self.mesh = mesh
        self.n_shards, self.rank = 1, 0
        if mesh is not None:
            check_obs_mesh(mesh)
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a solve on {self.device}")
            self.n_shards, self.rank = mesh.size(), mesh.get_local_rank()
            chunk_size = None  # a shard is already a chunk
        self.chunk_size = chunk_size
        self.diff_mode = diff_mode
        # False: evaluate without the robustifier (Problem.evaluate's
        # apply_loss_function)
        self.apply_loss_function = apply_loss_function
        self.num_tangent = program.num_tangent
        # the free mask (N,) and per group the blocks' 0/1 flags (None for a
        # group with no constant block); None when every block is free
        self._free_mask = None
        self._block_free = [None] * len(program.groups)
        if not bool(np.all(program.free_mask)):
            self._free_mask = torch.as_tensor(program.free_mask, dtype=dtype).to(self.device)
            for gi, g in enumerate(program.groups):
                if any(g.constant):
                    self._block_free[gi] = torch.tensor(
                        [0.0 if c else 1.0 for c in g.constant], dtype=dtype, device=self.device)
        self._bounds = program.bounds_arrays(self.device, dtype) if program.has_bounds else None

        # per batch: (data, per-slot block indices, (B, T) tangent indices)
        # of the rows [lo, hi) this rank holds (every row without a mesh)
        self.row_range = []
        self._batch_const = []
        self._slot_plans = []
        self._slot_cols = []
        for b in program.batches:
            lo, hi = shard_rows(b.num_blocks, self.n_shards, self.rank)
            self.row_range.append((lo, hi))
            # a batch without constants carries an empty tuple, which vmap
            # maps over as no input and the residual function receives as None
            data = () if b.data is None else pytree.tree_map(
                lambda a: _to_device(np.asarray(a)[lo:hi], self.device, dtype), b.data)
            idx = tuple(torch.as_tensor(ix[lo:hi]).to(self.device) for ix in b.slot_indices)
            tidx = torch.as_tensor(b.tangent_index[lo:hi]).to(self.device)
            self._batch_const.append((data, idx, tidx))
            build = build_reduce_plan if mesh is None else build_sharded_reduce_plan
            self._slot_plans.append(
                tuple(
                    build(ix[lo:hi], program.groups[gi].num_blocks, self.device)
                    for gi, ix in zip(b.slot_groups, b.slot_indices)
                )
            )
            cols, c = [], 0
            for t in b.tangent_sizes:
                cols.append((c, t))
                c += t
            self._slot_cols.append(tuple(cols))

    # -- helpers ---------------------------------------------------------------

    def slot_reduce(self, bi: int, s: int, values):
        """Sum per-row contributions ``values (B, D)`` into the slot's
        destination blocks -> ``(n_blocks, D)`` (under a mesh, over every
        rank's rows)."""
        if self.mesh is not None:
            return apply_sharded_reduce_plan(self._slot_plans[bi][s], values, self.mesh)
        return apply_reduce_plan(self._slot_plans[bi][s], values)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a rank's partial ``t`` over the mesh, in place (nothing
        without a mesh); returns ``t``."""
        return t if self.mesh is None else all_reduce_sum(t, self.mesh)

    def assemble_tangent(self, per_group):
        """Concatenate per-group ``(n_blocks, t)`` arrays into the global
        tangent vector (groups are laid out contiguously in group order)."""
        return torch.cat([a.reshape(-1) for a in per_group])

    def _row_slices(self, bi: int) -> List[slice]:
        """Row chunks of batch bi: one slice unless chunked evaluation is on
        and the batch is longer than a chunk."""
        lo, hi = self.row_range[bi]
        B = hi - lo
        c = self.chunk_size
        if not c or B <= c:
            return [slice(None)]
        return [slice(i, min(i + c, B)) for i in range(0, B, c)]

    def _chunk_args(self, bi: int, rows: slice):
        data, idx, _ = self._batch_const[bi]
        return pytree.tree_map(lambda a: a[rows], data), tuple(ix[rows] for ix in idx)

    def _gather_slots(self, batch: CompiledBatch, idx, state):
        return tuple(state[gi][ix] for gi, ix in zip(batch.slot_groups, idx))

    # -- batched evaluation ------------------------------------------------------

    def _rows_residuals(self, batch, data, idx, state):
        """Residual-only evaluation over the given rows: cost per block (B,)."""
        xs = self._gather_slots(batch, idx, state)
        r = torch.func.vmap(lambda d, *x: batch.fn(tuple(x), _row_data(batch, d)))(data, *xs)
        s = torch.sum(r * r, dim=-1)
        if batch.loss is None or not self.apply_loss_function:
            return 0.5 * s
        return 0.5 * batch.loss.evaluate(s)[0]

    def _rows_residuals_and_jacobian(self, batch, data, idx, state):
        """Full evaluation over the given rows: (cost (B,), r (B, m),
        J (B, m, T)), loss-corrected."""
        xs = self._gather_slots(batch, idx, state)
        manifolds = [self.program.groups[gi].manifold for gi in batch.slot_groups]
        T, m = batch.block_tangent_size, batch.residual_dim
        zero = torch.zeros(T, dtype=self.dtype, device=self.device)
        reverse = self.diff_mode == "reverse" or (self.diff_mode == "auto" and 2 * m < T)
        # m cotangent pulls beat T tangent pushes when the residual is
        # small against the block's tangent size (BA: 2 vs 12)
        basis = torch.eye(m if reverse else T, dtype=self.dtype, device=self.device)

        def one_block(data_row, *x_row):
            def f(delta):
                ds = torch.split(delta, batch.tangent_sizes)
                xp = tuple(mf.plus(x, d) for mf, x, d in zip(manifolds, x_row, ds))
                return batch.fn(xp, _row_data(batch, data_row))

            if batch.numeric_diff:
                # reference: NumericDiffCostFunction, for residuals whose
                # derivative torch.func cannot give
                if batch.numeric_diff_method == "ridders":
                    return f(zero), ridders_jacobian(f, zero, batch.numeric_diff_step)
                return f(zero), numeric_jacobian(f, zero, batch.numeric_diff_step,
                                                 batch.numeric_diff_method)
            if reverse:
                r, vjp_fn = torch.func.vjp(f, zero)
                (jac_rows,) = torch.func.vmap(vjp_fn)(basis)  # (m, T)
                return r, jac_rows
            jac_cols = torch.func.vmap(lambda v: torch.func.jvp(f, (zero,), (v,))[1])(
                basis
            )  # (T, m)
            return f(zero), jac_cols.transpose(0, 1)

        r, jac = torch.func.vmap(one_block)(data, *xs)
        cost, r_c, (jac_c,) = apply_loss(batch.loss if self.apply_loss_function else None,
                                          r, [jac])
        flags = [self._block_free[gi] for gi in batch.slot_groups]
        if any(f is not None for f in flags):  # zero the constant blocks' columns
            mask = torch.cat([
                torch.ones((r.shape[0], t), dtype=self.dtype, device=self.device) if f is None
                else f[ix][:, None].expand(-1, t)
                for f, ix, t in zip(flags, idx, batch.tangent_sizes)
            ], dim=1)
            jac_c = jac_c * mask[:, None, :]
        return cost, r_c, jac_c

    # -- public functions ----------------------------------------------------------

    def cost(self, state):
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for bi, batch in enumerate(self.program.batches):
            for rows in self._row_slices(bi):
                data, idx = self._chunk_args(bi, rows)
                total = total + torch.sum(self._rows_residuals(batch, data, idx, state))
        return self.all_reduce(total)

    def blocks(self, state) -> Tuple[torch.Tensor, List[BatchBlocks]]:
        """Full evaluation: (cost, per-batch corrected blocks). With
        ``chunk_size`` set, the differentiation and correction transients
        are bounded by one chunk of rows; the outputs stay whole."""
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        out = []
        for bi, batch in enumerate(self.program.batches):
            parts = []
            for rows in self._row_slices(bi):
                data, idx = self._chunk_args(bi, rows)
                parts.append(self._rows_residuals_and_jacobian(batch, data, idx, state))
            cost, r, jac = (torch.cat(p) for p in zip(*parts))
            total = total + torch.sum(cost)
            out.append(BatchBlocks(r, jac, self._batch_const[bi][2]))
        return self.all_reduce(total), out

    def gradient_and_diag(self, blocks: Sequence[BatchBlocks]):
        """g = J^T r and diag(J^T J), by per-(batch, slot) segment
        reductions into per-group accumulators, in tangent layout order."""
        accs = [
            torch.zeros((g.num_blocks, 2 * g.tangent_size), dtype=self.dtype,
                        device=self.device)
            for g in self.program.groups
        ]
        for bi, b in enumerate(blocks):
            batch = self.program.batches[bi]
            gb = torch.einsum("bmi,bm->bi", b.jac, b.r)
            db = torch.sum(b.jac * b.jac, dim=1)  # (B, T)
            for s, gi in enumerate(batch.slot_groups):
                c, t = self._slot_cols[bi][s]
                vals = torch.cat([gb[:, c : c + t], db[:, c : c + t]], dim=1)
                accs[gi] = accs[gi] + self.slot_reduce(bi, s, vals)
        g = self.assemble_tangent([a[:, : a.shape[1] // 2] for a in accs])
        diag = self.assemble_tangent([a[:, a.shape[1] // 2 :] for a in accs])
        return g, diag

    def jtj_dense(self, blocks: Sequence[BatchBlocks]):
        """Dense (N, N) J^T J from the batched block outer products
        (DENSE_NORMAL_CHOLESKY, and CGNR's SUBSET preconditioner; small
        problems only). The blocks are added by ``index_put_`` with
        ``accumulate=True``, whose sum order is not fixed on the card: two
        runs may differ in the last bits."""
        n = self.num_tangent
        h = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for b in blocks:
            hb = torch.einsum("bmi,bmj->bij", b.jac, b.jac)
            h.index_put_(
                (b.idx[:, :, None].expand_as(hb), b.idx[:, None, :].expand_as(hb)),
                hb, accumulate=True,
            )
        return self.all_reduce(h)

    def jacobian_dense(self, blocks: Sequence[BatchBlocks]):
        """The dense Jacobian (M, N) and the residual vector (M,), rows in
        batch order (DENSE_QR; small problems only). Built by
        ``index_put_`` with ``accumulate=True`` (a block that takes one
        parameter block in two slots adds both), whose sum order is not
        fixed on the card."""
        n = self.num_tangent
        batches = self.program.batches
        m_total = sum(b.num_blocks * b.residual_dim for b in batches)
        jd = torch.zeros((m_total, n), dtype=self.dtype, device=self.device)
        rd = torch.zeros((m_total,), dtype=self.dtype, device=self.device)
        row0 = 0
        for batch, b, (lo, hi) in zip(batches, blocks, self.row_range):
            m = batch.residual_dim
            first = row0 + lo * m  # this rank's rows of the batch, in row order
            rows = first + torch.arange((hi - lo) * m, device=self.device).reshape(hi - lo, m)
            jd.index_put_(
                (rows[:, :, None].expand_as(b.jac), b.idx[:, None, :].expand_as(b.jac)),
                b.jac, accumulate=True,
            )
            rd[first : first + (hi - lo) * m] = b.r.reshape(-1)
            row0 += batch.num_blocks * m
        if self.mesh is not None:  # the ranks' rows in rank order
            self.all_reduce(jd)
            self.all_reduce(rd)
        return jd, rd

    def jtj_matvec(self, blocks: Sequence[BatchBlocks], v):
        """v -> J^T (J v) without forming J^T J (CGNR's product): per-slot
        row gathers on the way in, planned segment reductions on the way
        out."""
        accs = [
            torch.zeros((g.num_blocks, g.tangent_size), dtype=v.dtype, device=v.device)
            for g in self.program.groups
        ]
        for bi, b in enumerate(blocks):
            batch = self.program.batches[bi]
            jv = torch.einsum("bmi,bi->bm", b.jac, self.v_rows(bi, v))
            jtv = torch.einsum("bmi,bm->bi", b.jac, jv)  # (B, T)
            for s, gi in enumerate(batch.slot_groups):
                c, t = self._slot_cols[bi][s]
                accs[gi] = accs[gi] + self.slot_reduce(bi, s, jtv[:, c : c + t])
        return self.assemble_tangent(accs)

    def v_rows(self, bi: int, v):
        """Per-row tangent vectors (B, T) for batch ``bi``: per-slot row
        gathers of the (n_blocks, t) group views of ``v``."""
        batch = self.program.batches[bi]
        _, idx, _ = self._batch_const[bi]
        parts = []
        for s, gi in enumerate(batch.slot_groups):
            g = self.program.groups[gi]
            o = self.program.tangent_offset[gi]
            view = v[o : o + g.num_blocks * g.tangent_size].reshape(
                g.num_blocks, g.tangent_size
            )
            parts.append(view[idx[s]])
        return torch.cat(parts, dim=1)

    def plus(self, state, step):
        """x <- x (+) step, step (N,) in the global tangent space (the
        constant blocks' share zeroed)."""
        if self._free_mask is not None:
            step = step * self._free_mask
        new_state = []
        for g, o, x in zip(self.program.groups, self.program.tangent_offset, state):
            nb, t = g.num_blocks, g.tangent_size
            delta = step[o : o + nb * t].reshape(nb, t).to(x.dtype)
            new_state.append(g.manifold.plus(x, delta))
        return tuple(new_state)

    def tangent_diff(self, y_state, x_state):
        """The global tangent step ``y (-) x`` (N,), per group
        ``manifold.minus`` (the constant blocks' share zeroed): the
        effective step of a candidate projected onto the bounds box."""
        out = torch.cat([
            g.manifold.minus(y, x).to(self.dtype).reshape(-1)
            for g, y, x in zip(self.program.groups, y_state, x_state)
        ])
        return out if self._free_mask is None else out * self._free_mask

    def project_bounds(self, state):
        """Clamp ambient coordinates into [lower, upper]."""
        if self._bounds is None:
            return state
        return tuple(torch.clamp(x, lo, hi) for x, lo, hi in zip(state, *self._bounds))

    def x_norm(self, state):
        return torch.sqrt(sum(torch.sum(x.to(self.dtype) ** 2) for x in state))
