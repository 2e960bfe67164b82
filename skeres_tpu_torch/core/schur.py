"""Schur-complement elimination for bundle-adjustment structure: DENSE_SCHUR.

PyTorch counterpart of the DENSE_SCHUR paths of ``skeres_tpu/core/schur.py``
(reference lineage: ``internal/ceres/schur_eliminator_impl.h``,
``schur_complement_solver.cc``):

  - per-point ``C = E^T E + D_e`` by a segment reduction of the batched
    ``e x e`` outer products, inverted in closed form (3x3 cofactors);
  - S over the retained (camera) coordinates,
    ``S = blockdiag(F^T F) - sum_p W_p C_p^-1 W_p^T + D_f``, by one of two
    paths, in the JAX package's priority: from a dense per-point W while
    it stays under its 2 GiB gate (one ``torch.einsum``, a matrix
    product), else by the explicit pair-product plan
    (``core/explicit_schur.py``, K3) while S stays under
    ``explicit_schur_limit_bytes``;
  - S is equilibrated and factored by K1 up to 1024 rows and by K2, the
    blocked factor over K1 panels, above (``ops/cholesky.py``), with the
    jitter ladder and the capped PCG fallback of the JAX package;
  - back-substitution ``dx_e = C^-1 (b_e - W^T dx_f)`` batched per point.

Structure is declared: the parameter group tagged with
``set_schur_elimination_group(arr, 0)`` is eliminated, everything else is
retained. Still to port: ITERATIVE_SCHUR and its preconditioners, the
column-probe S (taken by the JAX package when neither path above is
viable; the port raises there), and the camera-padded layout.
"""

from __future__ import annotations

import numpy as np
import torch

from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan
from skeres_tpu_torch.core.graph import cond
from skeres_tpu_torch.core.linear_solvers import (
    lm_diagonal,
    preconditioned_conjugate_gradients,
)
from skeres_tpu_torch.ops.cholesky import (
    MAX_CHOLESKY_N,
    blocked_chol_solve,
    blocked_cholesky_factor,
    chol_solve,
    cholesky_inverse_factor,
)
from skeres_tpu_torch.ops.segment_reduce import apply_reduce_plan, build_reduce_plan
from skeres_tpu_torch.ops.small_inverse import batched_spd_inverse

__all__ = ["SchurSolver"]

DENSE_W_LIMIT_BYTES = 2 << 30  # the JAX package's gate (as float32 bytes)
FALLBACK_CG_ITERATIONS = 32


class SchurSolver:
    """Damped normal-equation solver eliminating the group-0 parameters."""

    def __init__(
        self,
        evaluator: Evaluator,
        pad_waste: float = 1.5,
        explicit_s_limit_bytes: int = 2 << 30,
        pair_cap: int = 32,
    ):
        self.ev = evaluator
        program = evaluator.program
        device = evaluator.device

        elim = [i for i, g in enumerate(program.groups) if g.schur_group == 0]
        if len(elim) != 1:
            raise NotImplementedError(
                "SchurSolver requires exactly one eliminated parameter group "
                f"(got {len(elim)}); tag points with "
                "set_schur_elimination_group(arr, 0)"
            )
        self.elim_group = elim[0]
        ge = program.groups[self.elim_group]
        self.e_size = ge.tangent_size
        self.num_points = ge.num_blocks
        self.elim_offset = program.tangent_offset[self.elim_group]
        self.elim_span = self.num_points * self.e_size

        # both S paths need ONE retained group (the cameras) and ONE batch
        # coupling a point block to a camera block per row (the BA case);
        # the JAX package's column probe takes the rest
        ret = [gi for gi in range(len(program.groups)) if gi != self.elim_group]
        e_batches = [
            bi for bi, b in enumerate(program.batches)
            if self.elim_group in b.slot_groups and set(b.slot_groups) - {self.elim_group}
        ]
        if len(ret) != 1 or len(e_batches) != 1:
            raise NotImplementedError(
                "DENSE_SCHUR is ported for one eliminated x retained batch "
                "and one retained group (dense-W and explicit S); the "
                "column-probe S (core/schur.py:_dense_s) is not ported yet"
            )
        self.ret_group = ret[0]
        gf = program.groups[self.ret_group]
        self.num_cams, self.f_size = gf.num_blocks, gf.tangent_size
        self.ret_offset = program.tangent_offset[self.ret_group]
        self.num_f = self.num_cams * self.f_size

        # per batch: the eliminated slot's first column (or None), and the
        # retained columns with their retained-space indices (for batches
        # that add to S outside the observation batch, e.g. camera priors)
        self.batch_info = []
        for b in program.batches:
            e_slots = [s for s, gi in enumerate(b.slot_groups) if gi == self.elim_group]
            if len(e_slots) > 1:
                raise NotImplementedError(
                    "residual blocks touching >1 eliminated block are not "
                    "supported (the reference's one-E-block-per-row rule)"
                )
            col_group = np.concatenate(
                [np.full(t, gi) for gi, t in zip(b.slot_groups, b.tangent_sizes)]
            )
            starts = np.cumsum((0,) + b.tangent_sizes)
            f_cols = np.nonzero(col_group != self.elim_group)[0]
            self.batch_info.append(dict(
                e_col=int(starts[e_slots[0]]) if e_slots else None,
                f_cols=torch.as_tensor(f_cols).to(device),
                fidx=torch.as_tensor(b.tangent_index[:, f_cols] - self.ret_offset).to(device),
            ))

        self.e_batch = bi = e_batches[0]
        b = program.batches[bi]
        if len(b.slot_groups) != 2:
            raise NotImplementedError(
                "DENSE_SCHUR is ported for two slots per observation row, "
                "one point and one camera; the column-probe S "
                "(core/schur.py:_dense_s) is not ported yet"
            )
        self.e_slot = b.slot_groups.index(self.elim_group)
        self.f_slot = 1 - self.e_slot
        self.f_col = int(np.cumsum((0,) + b.tangent_sizes)[self.f_slot])
        cam_idx = np.asarray(b.slot_indices[self.f_slot], dtype=np.int64)
        pt_idx = np.asarray(b.slot_indices[self.e_slot], dtype=np.int64)

        # dense-W path (first priority): viable while the dense per-point
        # W = (n_pts, n_cams, f, e) stays under the JAX package's gate
        self.w_plan = None
        w_bytes = self.num_points * self.num_cams * self.f_size * self.e_size * 4
        if w_bytes <= DENSE_W_LIMIT_BYTES:
            # each (point, camera) cell receives at most a few observations
            self.w_plan = build_reduce_plan(
                pt_idx * self.num_cams + cam_idx, self.num_points * self.num_cams, device
            )

        self.explicit_plan = None
        self.explicit_reject_reason = None
        if self.w_plan is not None:
            return
        # explicit-S plan (core/explicit_schur.py): where dense W does not
        # fit, while S fits its own gate
        s_bytes = self.num_f ** 2 * 4
        if s_bytes > explicit_s_limit_bytes:
            self.explicit_reject_reason = (
                f"S too large: {s_bytes >> 20} MiB > explicit_schur_limit_bytes "
                f"({explicit_s_limit_bytes >> 20} MiB)"
            )
        else:
            try:
                self.explicit_plan = ExplicitSchurPlan(
                    cam_idx=cam_idx,
                    pt_idx=pt_idx,
                    num_cameras=self.num_cams,
                    num_points=self.num_points,
                    f_size=self.f_size,
                    e_size=self.e_size,
                    pad_waste=pad_waste,
                    pair_cap=pair_cap,
                    device=device,
                )
            except ValueError as exc:  # point-degree skew, pair fan-in
                self.explicit_reject_reason = str(exc)
        if self.explicit_plan is None:
            raise NotImplementedError(
                f"dense W would take {w_bytes >> 20} MiB (gate "
                f"{DENSE_W_LIMIT_BYTES >> 20} MiB) and the explicit-S plan was "
                f"rejected ({self.explicit_reject_reason}); the column-probe S "
                "(core/schur.py:_dense_s) that takes over there is not ported yet"
            )

    @property
    def schur_path(self) -> str:
        """The S-assembly path the damped solves take
        (``Summary.schur_complement_path``)."""
        return "dense-W" if self.w_plan is not None else "explicit"

    # -- solver data / scaling -------------------------------------------------

    def solver_data(self, blocks):
        """The corrected per-batch (r, jac) the damped solves read."""
        return tuple((b.r, b.jac) for b in blocks)

    def scale_data(self, data, scale):
        """Jacobi column scaling J -> J S, S = diag(scale)."""
        return tuple(
            (r, jac * self.ev.v_rows(bi, scale)[:, None, :])
            for bi, (r, jac) in enumerate(data)
        )

    # -- helpers ---------------------------------------------------------------

    def _split_E(self, bi, jac):
        c = self.batch_info[bi]["e_col"]
        return None if c is None else jac[:, :, c : c + self.e_size]

    def _gather_ge(self, g):
        return g[self.elim_offset : self.elim_offset + self.elim_span].reshape(
            self.num_points, self.e_size
        )

    def _gather_f(self, g):
        return g[self.ret_offset : self.ret_offset + self.num_f]

    # -- per-linearization and per-mu assembly -----------------------------------

    def prepare(self, data):
        """Everything that does not depend on mu, once per linearization:
        the E split, the undamped per-point ``E^T E`` and, on the explicit
        path, the A = F^T E rows, their point grid and the per-camera sums
        of ``F^T F``. Rejected steps re-solve with a new mu from the same
        prepared data."""
        e = self.e_size
        ete0 = None
        per_batch = []
        for bi, (r, jac) in enumerate(data):
            E = self._split_E(bi, jac)
            if E is not None:
                outer = torch.einsum("bme,bmf->bef", E, E).reshape(-1, e * e)
                s_e = self.ev.program.batches[bi].slot_groups.index(self.elim_group)
                red = self.ev.slot_reduce(bi, s_e, outer).reshape(self.num_points, e, e)
                ete0 = red if ete0 is None else ete0 + red
            per_batch.append((r, jac, E))
        prep = dict(per_batch=per_batch, ete0=ete0)
        plan = self.explicit_plan
        if self.schur_path == "explicit":
            nc, f = self.num_cams, self.f_size
            if plan.grid_is_reshape:
                # uniform point-grouped rows: write the grid rows directly
                grid = self._explicit_a_grid(per_batch, plan.kp, plan.np_ * plan.kp)
                a_rows = grid.view(-1, f * self.e_size)
            else:
                a_rows = self._explicit_a_flat(per_batch)
                grid = plan.build_grid(a_rows)["grid"]
            Fs = per_batch[self.e_batch][1][:, :, self.f_col : self.f_col + f]
            ftf = torch.einsum("bmf,bmg->bfg", Fs, Fs).reshape(-1, f * f)
            prep["explicit_grid"] = {"grid": grid}
            prep["explicit_a"] = a_rows
            prep["explicit_ftf"] = self.ev.slot_reduce(self.e_batch, self.f_slot, ftf).reshape(nc, f, f)
        return prep

    def _explicit_a_flat(self, per_batch):
        """The per-row A = F^T E blocks, flat: (B, f*e), f-major."""
        _, jac, E = per_batch[self.e_batch]
        Fs = jac[:, :, self.f_col : self.f_col + self.f_size]
        return torch.einsum("bmf,bme->bfe", Fs, E).reshape(jac.shape[0], -1)

    def _explicit_a_grid(self, per_batch, kp, n_rows):
        """The point grid (n_pts, kp*f*e) of the A rows when it is a pure
        reshape of row order (uniform kp observations per point,
        point-grouped rows): the first ``n_rows`` rows' products, written
        once in the grid's layout. Values identical to
        ``build_grid(_explicit_a_flat(...))``."""
        _, jac, E = per_batch[self.e_batch]
        Fs = jac[:n_rows, :, self.f_col : self.f_col + self.f_size]
        a = torch.einsum("bmf,bme->bfe", Fs, E[:n_rows])
        return a.reshape(n_rows // kp, kp * self.f_size * self.e_size)

    def _assemble(self, data, g, d):
        """Per-mu elimination state: damped C^-1 and the rhs pieces.
        ``data`` is a ``prepare()`` dict or raw ``solver_data``; ``d`` is the
        clamped damping diagonal (N,), mu included."""
        prep = data if isinstance(data, dict) else self.prepare(data)
        d_e = self._gather_ge(d)
        ete = prep["ete0"] + torch.diag_embed(d_e)
        return dict(
            per_batch=prep["per_batch"],
            explicit_grid=prep.get("explicit_grid"),
            explicit_a=prep.get("explicit_a"),
            explicit_ftf=prep.get("explicit_ftf"),
            cinv=batched_spd_inverse(ete),
            g_f=self._gather_f(g),
            d_f=self._gather_f(d),
            g_e=self._gather_ge(g),
        )

    def _f_block(self, asm):
        """The observation batch's camera Jacobian blocks F (B, m, f)."""
        jac = asm["per_batch"][self.e_batch][1]
        return jac[:, :, self.f_col : self.f_col + self.f_size]

    def _w_apply(self, asm, v_e):
        """W v_e (points -> cameras): (n_pt, e) -> (N_f,)."""
        bi = self.e_batch
        E = asm["per_batch"][bi][2]
        pidx = self.ev._batch_const[bi][1][self.e_slot]
        Ev = torch.einsum("bme,be->bm", E, v_e[pidx])
        val = torch.einsum("bmf,bm->bf", self._f_block(asm), Ev)
        return self.ev.slot_reduce(bi, self.f_slot, val).reshape(-1)

    def _wt_apply(self, asm, v_f):
        """W^T v_f (cameras -> points): (N_f,) -> (n_pt, e)."""
        bi = self.e_batch
        E = asm["per_batch"][bi][2]
        cidx = self.ev._batch_const[bi][1][self.f_slot]
        vs = v_f.reshape(self.num_cams, self.f_size)[cidx]
        Fv = torch.einsum("bmf,bf->bm", self._f_block(asm), vs)
        return self.ev.slot_reduce(bi, self.e_slot, torch.einsum("bme,bm->be", E, Fv))

    def _schur_rhs(self, asm):
        """b_f - W C^-1 b_e with b = -g."""
        cinv_be = torch.einsum("pef,pf->pe", asm["cinv"], -asm["g_e"])
        return -asm["g_f"] - self._w_apply(asm, cinv_be)

    def _back_substitute(self, asm, dx_f):
        b_e = -asm["g_e"] - self._wt_apply(asm, dx_f)
        return torch.einsum("pef,pf->pe", asm["cinv"], b_e)

    def _add_other_batches(self, asm, s_mat) -> bool:
        """Add ``F^T F`` of every batch other than the observation batch
        that touches retained coordinates (e.g. camera priors) into S, in
        place. Returns whether there was one."""
        extra = False
        for bj, (rb, jacb, Eb) in enumerate(asm["per_batch"]):
            infob = self.batch_info[bj]
            if bj == self.e_batch or len(infob["f_cols"]) == 0:
                continue
            extra = True
            Fb = jacb[:, :, infob["f_cols"]]
            ftfb = torch.einsum("bmf,bmg->bfg", Fb, Fb)
            fidx = infob["fidx"]
            s_mat.index_put_(
                (fidx[:, :, None].expand_as(ftfb), fidx[:, None, :].expand_as(ftfb)),
                ftfb, accumulate=True,
            )
        return extra

    def _dense_s_dense_w(self, asm):
        """S = blockdiag(F^T F) - sum_p W_p C_p^-1 W_p^T + diag(d_f), with W
        (n_pts, n_cams, f, e) built densely by one segment reduction."""
        nc, f, e = self.num_cams, self.f_size, self.e_size
        bi = self.e_batch
        E = asm["per_batch"][bi][2]
        Fs = self._f_block(asm)

        ftf = torch.einsum("bmf,bmg->bfg", Fs, Fs)
        diag_blocks = self.ev.slot_reduce(bi, self.f_slot, ftf.reshape(-1, f * f)).reshape(nc, f, f)

        a = torch.einsum("bmf,bme->bfe", Fs, E)
        w = apply_reduce_plan(self.w_plan, a.reshape(-1, f * e)).reshape(
            self.num_points, nc, f, e
        )
        y = torch.einsum("pcfe,peg->pcfg", w, asm["cinv"])
        corr = torch.einsum("pcfe,pdge->cfdg", y, w)  # (nc, f, nc, f)

        s_mat = -corr.reshape(nc * f, nc * f)
        cams = torch.arange(nc, device=s_mat.device)
        s4 = s_mat.view(nc, f, nc, f)
        s4[cams, :, cams, :] += diag_blocks
        s_mat = s_mat + torch.diag(asm["d_f"])
        self._add_other_batches(asm, s_mat)
        return s_mat

    def _schur_jacobi_blocks(self, asm):
        """The observation batch's camera blocks of S's block diagonal,
        (nc, f, f), damping included: the per-camera ``F^T F`` sums of
        ``prepare()`` minus the per-row ``Y A^T`` (``A = F^T E``,
        ``Y = A C_p^-1``) summed by camera, the JAX package's generic branch
        for this batch. Only ``Y A^T`` depends on mu."""
        nc, f, e = self.num_cams, self.f_size, self.e_size
        bi = self.e_batch
        a = asm["explicit_a"].view(-1, f, e)
        pidx = self.ev._batch_const[bi][1][self.e_slot]
        y = torch.einsum("bfe,beg->bfg", a, asm["cinv"][pidx])
        yat = torch.einsum("bfe,bge->bfg", y, a).reshape(-1, f * f)
        corr = self.ev.slot_reduce(bi, self.f_slot, yat).reshape(nc, f, f)
        return torch.diag_embed(asm["d_f"].reshape(nc, f)) + asm["explicit_ftf"] - corr

    def _dense_s_explicit(self, asm):
        """S by the explicit pair-product plan (core/explicit_schur.py):

          off-diagonal blocks   sum_p Y_pk A_pl^T (k<l) by K3, hierarchical
                                sums onto unique camera pairs, gather-built
                                into the dense matrix;
          diagonal blocks       the observation batch's
                                F^T F - Y C^-1 Y^T + D_f per camera, riding
                                the gather-build as the table's diagonal
                                region;
          other batches         (priors etc.) added via their retained
                                index maps.
        """
        plan = self.explicit_plan
        uniq = plan.correction_offdiag(
            asm["explicit_grid"], asm["cinv"].reshape(-1, self.e_size ** 2)
        )
        # symmetrize the diagonal blocks' one-ulp asymmetry here (nc*f*f)
        # so the dense matrix needs no full transpose pass
        diag_blocks = self._schur_jacobi_blocks(asm)
        diag_blocks = 0.5 * (diag_blocks + diag_blocks.transpose(1, 2))
        nc, f = plan.nc, plan.f
        s_mat = plan.dense_s_full(uniq, -diag_blocks.reshape(nc, f * f)).neg_()
        if self._add_other_batches(asm, s_mat):
            # the extra batches' contributions are not symmetric by construction
            s_mat = 0.5 * (s_mat + s_mat.T)
        return s_mat

    def _dense_s(self, asm):
        """Materialize S (N_f, N_f): dense W while it fits its gate, else
        the explicit pair-product plan (the JAX package's priority)."""
        if self.w_plan is not None:
            return self._dense_s_dense_w(asm)
        return self._dense_s_explicit(asm)

    def _factor_solve(self, s, rhs, delta):
        """Solve (S + delta I) x = rhs, ``delta`` a device scalar read by no
        host: K1's L^-1 up to 1024 rows (of a copy of S with delta on its
        diagonal), K2's blocked factor above (delta added to the copy it
        factors in). S itself is left as it was."""
        if s.shape[0] <= MAX_CHOLESKY_N:
            jittered = s.clone()
            jittered.diagonal().add_(delta)
            return chol_solve(cholesky_inverse_factor(jittered), rhs)
        return blocked_chol_solve(blocked_cholesky_factor(s, jitter=delta), rhs)

    def _block_jacobi(self, s):
        """v -> blockdiag(S)^-1 v, the camera blocks read off dense S."""
        nc, f = self.num_cams, self.f_size
        cams = torch.arange(nc, device=s.device)
        binv = batched_spd_inverse(s.view(nc, f, nc, f)[cams, :, cams, :])
        return lambda v: torch.einsum("bef,bf->be", binv, v.reshape(nc, f)).reshape(-1)

    # -- public interface used by the minimizer ------------------------------------

    def solve_damped(self, data, g, diag, mu, min_diagonal, max_diagonal, jitter0=0.0):
        """Solve the damped system; returns (dx, linear_solver_iterations,
        jitter_used), the last two as device scalars (int64, g's dtype).

        ``jitter0`` is the caller's ratchet: the jitter that made the last
        factorization succeed, where this solve's ladder starts. ``mu`` and
        ``jitter0`` may be device scalars: nothing here reads a value on the
        host except through :func:`cond`, so a CUDA graph can capture it."""
        jitter0 = torch.as_tensor(jitter0, dtype=g.dtype, device=g.device)
        d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
        asm = self._assemble(data, g, d)
        rhs = self._schur_rhs(asm)

        s = self._dense_s(asm)
        # symmetric equilibration: factor D^-1/2 S D^-1/2 (pivots ~1); in
        # float32 it moves the point where assembly noise makes S
        # numerically indefinite out by orders of magnitude
        d_eq = torch.sqrt(torch.clamp(torch.diagonal(s), min=torch.finfo(s.dtype).tiny))
        s.div_(d_eq[:, None]).div_(d_eq[None, :])  # S is this solve's own
        rhs_eq = rhs / d_eq
        dx_f = self._factor_solve(s, rhs_eq, jitter0)

        # Jitter ladder (see skeres_tpu/core/schur.py:1488-1585): a failed
        # factor (NaN, the only signal K1 gives) is retried on S + delta*I
        # in the equilibrated space, delta escalating from two decades above
        # the ratchet (at least 1e-3) to 0.1, at most two rungs; if even
        # they fail, capped PCG on the equilibrated S with the block-Jacobi
        # preconditioner read off S. Each rung and the PCG run under
        # cond() on the factor's failure, nested, so that a factor that
        # holds costs one host read eagerly and none in a CUDA graph.
        delta = torch.clamp(torch.clamp(jitter0 * 100.0, min=1e-3), max=0.1)
        jitter_used = jitter0.clone()
        iters = torch.ones((), dtype=torch.int64, device=g.device)

        def failed():
            return ~torch.isfinite(dx_f).all()

        def rung():
            dx_f.copy_(self._factor_solve(s, rhs_eq, delta))
            jitter_used.copy_(delta)
            delta.copy_(torch.clamp(delta * 100.0, max=0.1))
            iters.add_(1)

        def first_rung():
            rung()
            cond(failed(), second_rung)

        def second_rung():
            rung()
            cond(failed(), fallback)

        def fallback():
            x, _ = preconditioned_conjugate_gradients(
                lambda v: s @ v, rhs_eq, self._block_jacobi(s), FALLBACK_CG_ITERATIONS, 1e-8
            )
            dx_f.copy_(x)
            iters.fill_(FALLBACK_CG_ITERATIONS)

        cond(failed(), first_rung)
        dx_f = dx_f / d_eq

        dx_e = self._back_substitute(asm, dx_f)
        dx = torch.empty_like(g)
        dx[self.ret_offset : self.ret_offset + self.num_f] = dx_f
        dx[self.elim_offset : self.elim_offset + self.elim_span] = dx_e.reshape(-1)
        return dx, iters, jitter_used

    def jtj_quadratic(self, data, v):
        """v^T (J^T J) v = ||J v||^2 in one forward pass over the rows."""
        pairs = (
            [(r, jac) for (r, jac, _) in data["per_batch"]]
            if isinstance(data, dict)
            else data
        )
        total = torch.zeros((), dtype=v.dtype, device=v.device)
        for bi, (r, jac) in enumerate(pairs):
            jv = torch.einsum("bmi,bi->bm", jac, self.ev.v_rows(bi, v))
            total = total + torch.sum(jv * jv)
        return total
