"""Schur-complement elimination for bundle-adjustment structure:
DENSE_SCHUR and ITERATIVE_SCHUR.

PyTorch counterpart of ``skeres_tpu/core/schur.py`` (reference lineage:
``internal/ceres/schur_eliminator_impl.h``, ``schur_complement_solver.cc``,
``implicit_schur_complement.cc``, ``iterative_schur_complement_solver.cc``,
``schur_jacobi_preconditioner.cc``, ``visibility_based_preconditioner.cc``,
``power_series_expansion_preconditioner.cc``):

  - per-point ``C = E^T E + D_e`` by a segment reduction of the batched
    ``e x e`` outer products, inverted in closed form (3x3 cofactors);
  - DENSE_SCHUR: S over the retained coordinates,
    ``S = blockdiag(F^T F) - sum_p W_p C_p^-1 W_p^T + D_f``, by one of three
    paths, in the JAX package's priority: from a dense per-point W while
    it stays under its 2 GiB gate (one ``torch.einsum``, a matrix
    product), else by the explicit pair-product plan
    (``core/explicit_schur.py``, K3) while S stays under
    ``explicit_schur_limit_bytes``, else by the column probe (S applied to
    blocks of identity columns, ``_dense_s_probe``). The first two take the
    bundle-adjustment structure only. S is equilibrated and factored by K1
    up to 1024 rows and by K2, the blocked factor over K1 panels, above
    (``ops/cholesky.py``), with the jitter ladder and the capped PCG
    fallback of the JAX package, and, with ``refinement_iterations``,
    mixed-precision refinement that reuses the factor;
  - ITERATIVE_SCHUR: PCG on S with the reference's Q-test, S applied
    implicitly (``_s_matvec``: row-level products and reductions over the
    observations) or, with ``use_explicit``, as the explicit
    matrix; preconditioned by JACOBI / IDENTITY (diagonal scaling),
    SCHUR_JACOBI (the diagonal blocks of S), POWER_SERIES_EXPANSION,
    CLUSTER_JACOBI or CLUSTER_TRIDIAGONAL (the cluster-restricted
    pair-product plan, K3 again). It is the only Schur path where S itself
    passes ``explicit_schur_limit_bytes``;
  - back-substitution ``dx_e = C^-1 (b_e - W^T dx_f)`` batched per point.

Structure is declared (or found by ``core/ordering.py``): the parameter
group with ``schur_group == 0`` is eliminated, everything else is
retained, as the JAX package takes it (reference:
``schur_eliminator_impl.h``, any mix of E and F blocks): any number of
retained groups, on either side of the eliminated one, and any number of
observation batches, each with one eliminated slot and any number of
retained slots, besides batches on retained blocks alone (priors). The
dense-W, explicit and cluster paths take the bundle-adjustment structure
(one observation batch, one retained group, one retained slot); the
general structure takes the column probe and the row-by-row products.
Still to port: the camera-padded layout of the observation rows.

Under a mesh (the evaluator's ``mesh``, ``parallel/mesh.py``) every row
term is this rank's rows and every ``slot_reduce`` returns the table
reduced over the ranks, so the point-side and camera-side gathers index
replicated vectors and every product above runs unchanged. DENSE_SCHUR
takes the explicit path whenever a plan exists, as the JAX package does
(``skeres_tpu/core/schur.py:1370-1373``): the plan shards itself
(``core/explicit_schur.py``). Where it is rejected, the dense-W path runs
with W reduced over the ranks before ``W C^-1 W^T`` (W is not linear in
the shards' products), and the column probe with each chunk's reductions
reduced; the rows of other batches (priors) that add to S are summed into
a zero matrix and reduced once.

``prepare()`` keeps the per-row ``A = F^T E`` blocks (540 MB at
venice-1778 shape in float32) and the per-camera ``F^T F`` sums for every
solver that reads the camera blocks of S (DENSE_SCHUR's explicit path,
SCHUR_JACOBI, the cluster preconditioners): they do not depend on mu, so a
rejected step's re-solve pays only the ``C^-1``-dependent half, and with a
plan the rows are the point grid K3 reads anyway.
"""

from __future__ import annotations


import numpy as np
import torch

from skeres_tpu_torch.core.evaluator import BatchBlocks, Evaluator
from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan
from skeres_tpu_torch.core.graph import cond, while_loop
from skeres_tpu_torch.core.linear_solvers import (
    cholesky_nan,
    lm_diagonal,
    preconditioned_conjugate_gradients,
)
from skeres_tpu_torch.core.types import PreconditionerType
from skeres_tpu_torch.ops.cholesky import (
    MAX_CHOLESKY_N,
    blocked_chol_solve,
    blocked_cholesky_factor,
    chol_solve,
    cholesky_inverse_factor,
)
from skeres_tpu_torch.ops.segment_reduce import (
    apply_reduce_plan,
    apply_sharded_reduce_plan,
    build_reduce_plan,
    build_sharded_reduce_plan,
)
from skeres_tpu_torch.ops.small_inverse import batched_spd_inverse

__all__ = ["SchurSolver"]

DENSE_W_LIMIT_BYTES = 2 << 30  # the JAX package's gate (as float32 bytes)
PROBE_CHUNK = 128  # the identity columns the column-probe S applies S to at once
FALLBACK_CG_ITERATIONS = 32


def _rows_apply(mat, v):
    """Per-row product ``mat (B, m, t) @ v (B, t) -> (B, m)`` of the
    observation rows (m = 2), as a multiply and a sum: ``torch.einsum``
    lowers it to a batched product of 2 x t matrices, 5-18x slower on an
    NVIDIA H100 80GB HBM3 (700 W) at 5M rows (``chip_smoke.py`` phase 18
    times both)."""
    return (mat * v[:, None, :]).sum(-1)


def _rows_apply_t(mat, u):
    """Per-row transposed product ``mat (B, m, t)^T @ u (B, m) -> (B, t)``."""
    return (mat * u[:, :, None]).sum(1)


class SchurSolver:
    """Damped normal-equation solver eliminating the group-0 parameters:
    DENSE_SCHUR, or with ``iterative`` ITERATIVE_SCHUR with
    ``preconditioner``."""

    def __init__(
        self,
        evaluator: Evaluator,
        iterative: bool = False,
        preconditioner: PreconditionerType = PreconditionerType.SCHUR_JACOBI,
        max_cg_iterations: int = 500,
        eta: float = 1e-1,
        refinement_iterations: int = 0,
        max_power_series_terms: int = 5,
        spse_tolerance: float = 0.1,
        pad_waste: float = 1.5,
        use_explicit: bool = False,
        explicit_s_limit_bytes: int = 2 << 30,
        pair_cap: int = 32,
        cluster_size: int = 64,
        cluster_boost: float = 1e-3,
    ):
        self.ev = evaluator
        self.iterative = iterative
        self.preconditioner = preconditioner
        self.max_cg_iterations = max_cg_iterations
        self.eta = eta
        self.refinement_iterations = refinement_iterations
        self.max_power_series_terms = max_power_series_terms
        self.spse_tolerance = spse_tolerance
        # the cluster factors' regularization, relative to each cluster's
        # largest diagonal entry: larger is more robust and a weaker
        # preconditioner
        self.cluster_boost = cluster_boost
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

        # the retained coordinates: every tangent coordinate outside the
        # eliminated span, in global order (glob2ret: global -> retained, -1
        # for an eliminated one); each retained group is one contiguous
        # (start, n_blocks, t) span of the retained vector
        n = program.num_tangent
        mask = np.ones(n, dtype=bool)
        mask[self.elim_offset : self.elim_offset + self.elim_span] = False
        self.ret_index = np.nonzero(mask)[0]
        self.num_f = len(self.ret_index)
        self.glob2ret = np.full(n, -1, dtype=np.int64)
        self.glob2ret[self.ret_index] = np.arange(self.num_f)
        self.ret_blocks = []  # (start in the retained vector, n_blocks, t)
        self._ret_start = {}  # group -> its start in the retained vector
        self._ret_group_order = []
        pos = 0
        for gi, g in enumerate(program.groups):
            if gi == self.elim_group:
                continue
            self.ret_blocks.append((pos, g.num_blocks, g.tangent_size))
            self._ret_start[gi] = pos
            self._ret_group_order.append(gi)
            pos += g.num_blocks * g.tangent_size

        # per batch: the retained slots (slot, group, first column, width),
        # the eliminated slot and its first column (or None), its point
        # index per row, and the retained columns with their retained-space
        # indices (the scatter of batches that add to S outside the
        # observation batches, e.g. camera priors)
        self.batch_info = []
        e_batches = []
        for bi, b in enumerate(program.batches):
            e_slots = [s for s, gi in enumerate(b.slot_groups) if gi == self.elim_group]
            if len(e_slots) > 1:
                raise NotImplementedError(
                    "residual blocks touching >1 eliminated block are not "
                    "supported (the reference's one-E-block-per-row rule)"
                )
            ret_slots = [(s, gi, c, t) for s, (gi, (c, t)) in
                         enumerate(zip(b.slot_groups, evaluator._slot_cols[bi]))
                         if gi != self.elim_group]
            col_group = np.concatenate(
                [np.full(t, gi) for gi, t in zip(b.slot_groups, b.tangent_sizes)]
            )
            f_cols = np.nonzero(col_group != self.elim_group)[0]
            e_slot = e_slots[0] if e_slots else None
            self.batch_info.append(dict(
                ret_slots=ret_slots,
                e_slot=e_slot,
                e_col=None if e_slot is None else evaluator._slot_cols[bi][e_slot][0],
                pidx=None if e_slot is None else evaluator._batch_const[bi][1][e_slot],
                f_cols=torch.as_tensor(f_cols).to(device),
                fidx=torch.as_tensor(self.glob2ret[b.tangent_index[slice(
                    *evaluator.row_range[bi])][:, f_cols]]).to(device),
            ))
            if e_slots and ret_slots:
                e_batches.append(bi)
        # any number of eliminated x retained batches; ``e_batch`` names the
        # one observation batch where there is exactly one (the candidate of
        # the dense-W, explicit and cluster paths)
        self.e_batches = e_batches
        self.e_batch = e_batches[0] if len(e_batches) == 1 else None

        # the bundle-adjustment structure the fast paths take: one
        # observation batch, one retained group, one retained slot in it
        # (the gates of skeres_tpu/core/schur.py:338-347, 381-384, 446-456)
        self._ba = (self.e_batch is not None and len(self.ret_blocks) == 1
                    and len(self.batch_info[self.e_batch]["ret_slots"]) == 1)
        self.num_cams = self.f_size = self.e_slot = self.f_slot = self.f_col = None
        self.ret_offset = None
        if self._ba:
            bi = self.e_batch
            b = program.batches[bi]
            self.f_slot, gi, self.f_col, self.f_size = self.batch_info[bi]["ret_slots"][0]
            self.e_slot = self.batch_info[bi]["e_slot"]
            self.num_cams = program.groups[gi].num_blocks
            self.ret_offset = program.tangent_offset[gi]
            cam_idx = np.asarray(b.slot_indices[self.f_slot], dtype=np.int64)
            pt_idx = np.asarray(b.slot_indices[self.e_slot], dtype=np.int64)

        # dense-W path (DENSE_SCHUR's first priority; under a mesh, only where
        # the explicit plan is rejected): viable on the BA structure while the
        # dense per-point W = (n_pts, n_cams, f, e) stays under the JAX
        # package's gate
        mesh = evaluator.mesh
        self.w_plan = None
        w_fits = self._ba and not iterative and (
            self.num_points * self.num_cams * self.f_size * self.e_size * 4
            <= DENSE_W_LIMIT_BYTES)

        def make_w_plan():
            # each (point, camera) cell receives at most a few observations
            lin = pt_idx * self.num_cams + cam_idx
            if mesh is None:
                return build_reduce_plan(lin, self.num_points * self.num_cams, device)
            return build_sharded_reduce_plan(lin[slice(*evaluator.row_range[self.e_batch])],
                                             self.num_points * self.num_cams, device)

        if w_fits and mesh is None:
            self.w_plan = make_w_plan()

        def make_plan(**kw):
            return ExplicitSchurPlan(
                cam_idx=cam_idx, pt_idx=pt_idx, num_cameras=self.num_cams,
                num_points=self.num_points, f_size=self.f_size, e_size=self.e_size,
                pad_waste=pad_waste, pair_cap=pair_cap, device=device, mesh=mesh, **kw,
            )

        # explicit-S plan (core/explicit_schur.py), on the BA structure: for
        # DENSE_SCHUR where dense W does not fit, for ITERATIVE_SCHUR where the
        # caller asks for it; while S fits its own gate. DENSE_SCHUR past both
        # takes the column probe (_dense_s_probe).
        self.explicit_plan = None
        self.explicit_reject_reason = None  # why a wanted plan was rejected
        want_explicit = not iterative or use_explicit
        if self._ba and ((not iterative and self.w_plan is None) or (iterative and use_explicit)):
            s_bytes = self.num_f ** 2 * 4
            if s_bytes > explicit_s_limit_bytes:
                self.explicit_reject_reason = (
                    f"S too large: {s_bytes >> 20} MiB > explicit_schur_limit_bytes "
                    f"({explicit_s_limit_bytes >> 20} MiB)"
                )
            else:
                try:
                    self.explicit_plan = make_plan()
                except ValueError as exc:  # point-degree skew, pair fan-in
                    self.explicit_reject_reason = str(exc)
        elif not self._ba and want_explicit:
            self.explicit_reject_reason = (
                "structure: the explicit plan needs one eliminated batch "
                "coupling one retained block group via a single slot"
            )
        self.use_explicit = use_explicit and self.explicit_plan is not None
        if w_fits and mesh is not None and self.explicit_plan is None:
            self.w_plan = make_w_plan()

        # CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL plan (reference:
        # visibility_based_preconditioner.cc; the clusters here are
        # contiguous ranges of camera indices, since capture order implies
        # view locality in BAL data), on the BA structure. It has no size
        # cap: the cluster-restricted unique-pair table stays small however
        # many cameras, which is the regime past the explicit-S gate.
        self.cluster_plan = None
        cluster_kinds = (PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL)
        if self._ba and iterative and preconditioner in cluster_kinds:
            try:
                self.cluster_plan = make_plan(
                    cluster_of=np.arange(self.num_cams) // max(cluster_size, 1),
                    cluster_band=preconditioner == PreconditionerType.CLUSTER_TRIDIAGONAL,
                )
            except ValueError:
                self.cluster_plan = None
            if self.cluster_plan is not None:
                # camera -> its cluster slot, and slot -> camera (``nc`` for a
                # padded slot, which reads an identity block or a zero row)
                flat = self.cluster_plan.cluster_cam_of.reshape(-1)
                pos_of_cam = np.zeros(self.num_cams, dtype=np.int64)
                pos_of_cam[flat[flat >= 0]] = np.nonzero(flat >= 0)[0]
                self._cluster_pos_of_cam = torch.as_tensor(pos_of_cam).to(device)
                self._cluster_slot_cam = torch.as_tensor(
                    np.where(flat >= 0, flat, self.num_cams)).to(device)

        # the preconditioner the damped solves apply: a cluster
        # preconditioner whose plan was rejected, and CLUSTER_TRIDIAGONAL on
        # one cluster, downgrade to SCHUR_JACOBI as the reference's
        # preprocessor does; SUBSET serves CGNR only and scales by the diagonal
        self.preconditioner_used = preconditioner
        if preconditioner in cluster_kinds and (
            self.cluster_plan is None
            or (preconditioner == PreconditionerType.CLUSTER_TRIDIAGONAL
                and self.cluster_plan.n_clusters <= 1)
        ):
            self.preconditioner_used = PreconditionerType.SCHUR_JACOBI
        elif preconditioner == PreconditionerType.SUBSET:
            self.preconditioner_used = PreconditionerType.JACOBI
        # which solves read the camera blocks of S in the BA fast form, and so
        # the A rows (prepare()); the general structure assembles its blocks
        # row by row (_schur_jacobi_blocks)
        self._keeps_a = self._ba and (self.explicit_plan is not None or (
            iterative and self.preconditioner_used in (PreconditionerType.SCHUR_JACOBI,
                                                       *cluster_kinds)))
        self._keeps_ftf = self._keeps_a or (
            self._ba and iterative
            and self.preconditioner_used == PreconditionerType.POWER_SERIES_EXPANSION)

    @property
    def schur_path(self) -> str:
        """The S path the damped solves take, with the gate's reason where a
        wanted explicit plan was rejected (``Summary.schur_complement_path``)."""
        if self.iterative:
            if self.use_explicit:
                return "explicit"
            if self.explicit_reject_reason is not None:
                return f"implicit (gate: {self.explicit_reject_reason})"
            return "implicit"
        if self.w_plan is not None:
            return "dense-W"
        if self.explicit_plan is not None:
            return "explicit"
        return f"column-probe (gate: {self.explicit_reject_reason})"

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
        """The retained coordinates of a global vector: everything outside
        the eliminated span, in global order (``ret_index``)."""
        lo, hi = self.elim_offset, self.elim_offset + self.elim_span
        if lo == 0 or hi == g.shape[0]:
            return g[hi:] if lo == 0 else g[:lo]
        return torch.cat((g[:lo], g[hi:]))

    def _scatter_f(self, dx, dx_f):
        """Write the retained vector ``dx_f`` into its coordinates of ``dx``."""
        lo, hi = self.elim_offset, self.elim_offset + self.elim_span
        dx[:lo] = dx_f[:lo]
        dx[hi:] = dx_f[lo:]

    def _ret_view(self, v_f, gi):
        """Group ``gi``'s span of a retained vector (or of the rows of a
        retained block (N_f, k)), as (n_blocks, t) (or (n_blocks, t, k))."""
        start = self._ret_start[gi]
        g = self.ev.program.groups[gi]
        return v_f[start : start + g.num_blocks * g.tangent_size].view(
            g.num_blocks, g.tangent_size, *v_f.shape[1:])

    def _ret_assemble(self, per_group, like):
        """Per-group sums (gi -> (n_blocks, t[, k]) or None for a group no
        batch reached) -> the retained vector (N_f[, k]) shaped as ``like``."""
        parts = []
        for (start, nb, t), gi in zip(self.ret_blocks, self._ret_group_order):
            acc = per_group.get(gi)
            parts.append(like.new_zeros((nb * t, *like.shape[1:])) if acc is None
                         else acc.reshape(nb * t, *like.shape[1:]))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    # -- per-linearization and per-mu assembly -----------------------------------

    def prepare(self, data):
        """Everything that does not depend on mu, once per linearization:
        the E split, the undamped per-point ``E^T E`` and, off the dense-W
        path, the per-camera sums of ``F^T F``, the A = F^T E rows where a
        solve reads the camera blocks of S, and their point grid where a
        plan (explicit or cluster: one layout) has K3 read them. Rejected
        steps re-solve with a new mu from the same prepared data."""
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
        if ete0 is None:  # no residual touches the eliminated blocks
            ete0 = data[0][1].new_zeros((self.num_points, e, e))
        prep = dict(per_batch=per_batch, ete0=ete0)
        if self.w_plan is not None or not self._ba:
            return prep
        nc, f = self.num_cams, self.f_size
        plan = self.explicit_plan or self.cluster_plan
        if plan is not None:
            if plan.grid_is_reshape:
                # uniform point-grouped rows: write the grid rows directly
                grid = self._explicit_a_grid(per_batch, plan.kp, plan.np_ * plan.kp)
                a_rows = grid.view(-1, f * self.e_size)
                prep["explicit_grid"] = {"grid": grid}
            else:
                a_rows = self._explicit_a_flat(per_batch)
                prep["explicit_grid"] = plan.build_grid(a_rows)
            prep["explicit_a"] = a_rows
        elif self._keeps_a:
            prep["explicit_a"] = self._explicit_a_flat(per_batch)
        if self._keeps_ftf:
            Fs = per_batch[self.e_batch][1][:, :, self.f_col : self.f_col + f]
            ftf = torch.einsum("bmf,bmg->bfg", Fs, Fs).reshape(-1, f * f)
            prep["explicit_ftf"] = self.ev.slot_reduce(
                self.e_batch, self.f_slot, ftf).reshape(nc, f, f)
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
        """W v_e (points -> retained): (n_pt, e) -> (N_f,), summed over every
        observation batch and each of its retained slots."""
        accs = {}
        for bi in self.e_batches:
            info = self.batch_info[bi]
            _, jac, E = asm["per_batch"][bi]
            Ev = _rows_apply(E, v_e[info["pidx"]])
            for s, gi, c, t in info["ret_slots"]:
                red = self.ev.slot_reduce(bi, s, _rows_apply_t(jac[:, :, c : c + t], Ev))
                accs[gi] = red if gi not in accs else accs[gi] + red
        return self._ret_assemble(accs, asm["d_f"])

    def _f_rows(self, asm, bi, v_f):
        """F v_f per row of batch ``bi`` (B, m), summed over its retained
        slots; with a retained block v_f (N_f, k), F V (B, m, k)."""
        jac = asm["per_batch"][bi][1]
        idx = self.ev._batch_const[bi][1]
        out = None
        for s, gi, c, t in self.batch_info[bi]["ret_slots"]:
            vs = self._ret_view(v_f, gi)[idx[s]]
            part = (_rows_apply(jac[:, :, c : c + t], vs) if v_f.dim() == 1
                    else torch.bmm(jac[:, :, c : c + t], vs))
            out = part if out is None else out + part
        return out

    def _wt_apply(self, asm, v_f):
        """W^T v_f (retained -> points): (N_f,) -> (n_pt, e), summed over
        every observation batch."""
        out = None
        for bi in self.e_batches:
            E = asm["per_batch"][bi][2]
            red = self.ev.slot_reduce(bi, self.batch_info[bi]["e_slot"],
                                      _rows_apply_t(E, self._f_rows(asm, bi, v_f)))
            out = red if out is None else out + red
        return out if out is not None else v_f.new_zeros((self.num_points, self.e_size))

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
        extra = [bj for bj in range(len(asm["per_batch"]))
                 if bj != self.e_batch and len(self.batch_info[bj]["f_cols"])]
        # under a mesh, this rank's rows into a zero matrix, reduced once
        dst = s_mat if self.ev.mesh is None or not extra else torch.zeros_like(s_mat)
        for bj in extra:
            infob = self.batch_info[bj]
            Fb = asm["per_batch"][bj][1][:, :, infob["f_cols"]]
            ftfb = torch.einsum("bmf,bmg->bfg", Fb, Fb)
            fidx = infob["fidx"]
            dst.index_put_(
                (fidx[:, :, None].expand_as(ftfb), fidx[:, None, :].expand_as(ftfb)),
                ftfb, accumulate=True,
            )
        if dst is not s_mat:
            s_mat.add_(self.ev.all_reduce(dst))
        return bool(extra)

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
        if self.ev.mesh is None:
            w = apply_reduce_plan(self.w_plan, a.reshape(-1, f * e))
        else:  # W reduced over the ranks before W C^-1 W^T
            w = apply_sharded_reduce_plan(self.w_plan, a.reshape(-1, f * e), self.ev.mesh)
        w = w.reshape(self.num_points, nc, f, e)
        y = torch.einsum("pcfe,peg->pcfg", w, asm["cinv"])
        corr = torch.einsum("pcfe,pdge->cfdg", y, w)  # (nc, f, nc, f)

        s_mat = -corr.reshape(nc * f, nc * f)
        cams = torch.arange(nc, device=s_mat.device)
        s4 = s_mat.view(nc, f, nc, f)
        s4[cams, :, cams, :] += diag_blocks
        s_mat = s_mat + torch.diag(asm["d_f"])
        self._add_other_batches(asm, s_mat)
        return s_mat

    def _schur_jacobi_blocks(self, asm, include_e_correction=True, only_batch=None):
        """The diagonal blocks of S, one (nb, t, t) tensor per retained group
        (group order), damping included (the SCHUR_JACOBI preconditioner);
        with ``include_e_correction=False`` the blocks of
        ``B = F^T F + D_f`` instead (POWER_SERIES_EXPANSION's base matrix);
        with ``only_batch`` the contributions of that batch alone.
        Contributions across two slots of one row are dropped, as in the
        reference's preconditioner assembly.

        On the BA structure the observation batch gives the per-camera
        ``F^T F`` sums of ``prepare()`` minus the per-row ``Y A^T``
        (``A = F^T E``, ``Y = A C_p^-1``) summed by camera, of which only
        ``Y A^T`` depends on mu; elsewhere every retained slot of every
        batch adds its ``F^T F - Y A^T`` row by row."""
        outs = {}
        if self._ba:
            nc, f, e = self.num_cams, self.f_size, self.e_size
            bi = self.e_batch
            blocks = asm["explicit_ftf"]
            if include_e_correction:
                a = asm["explicit_a"].view(-1, f, e)
                y = torch.einsum("bfe,beg->bfg", a, asm["cinv"][self.batch_info[bi]["pidx"]])
                yat = torch.einsum("bfe,bge->bfg", y, a).reshape(-1, f * f)
                blocks = blocks - self.ev.slot_reduce(bi, self.f_slot, yat).reshape(nc, f, f)
            outs[self.batch_info[bi]["ret_slots"][0][1]] = blocks
        for bj, (rb, jacb, Eb) in enumerate(asm["per_batch"]):
            if (self._ba and bj == self.e_batch) or (only_batch is not None and bj != only_batch):
                continue
            info = self.batch_info[bj]
            for slot, gi, c, t in info["ret_slots"]:
                Fs = jacb[:, :, c : c + t]
                ftf = torch.einsum("bmf,bmg->bfg", Fs, Fs)
                if Eb is not None and include_e_correction:
                    a = torch.einsum("bmf,bme->bfe", Fs, Eb)
                    y = torch.einsum("bfe,beg->bfg", a, asm["cinv"][info["pidx"]])
                    ftf = ftf - torch.einsum("bfe,bge->bfg", y, a)
                red = self.ev.slot_reduce(bj, slot, ftf.reshape(-1, t * t)).view(-1, t, t)
                outs[gi] = red if gi not in outs else outs[gi] + red
        d_f = asm["d_f"]
        blocks = []
        for (start, nb, t), gi in zip(self.ret_blocks, self._ret_group_order):
            dd = torch.diag_embed(d_f[start : start + nb * t].view(nb, t))
            blocks.append(dd if gi not in outs else outs[gi] + dd)
        return blocks

    def _ftf_diag(self, asm):
        """diag(F^T F) over the retained coordinates, every batch."""
        accs = {}
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            for slot, gi, c, t in self.batch_info[bi]["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                red = self.ev.slot_reduce(bi, slot, torch.sum(Fs * Fs, dim=1))
                accs[gi] = red if gi not in accs else accs[gi] + red
        return self._ret_assemble(accs, asm["d_f"])

    def _s_matvec(self, asm, v):
        """The implicit Schur-complement product
        ``S v = (F^T F + D_f) v - W C^-1 W^T v`` over every batch and every
        retained slot: per row ``F^T (F v - E wc)`` with
        ``wc = C^-1 W^T v`` gathered by point, summed by retained block
        (reference: ``implicit_schur_complement.cc``
        RightMultiplyAndAccumulate)."""
        wc = torch.einsum("pef,pf->pe", asm["cinv"], self._wt_apply(asm, v))
        accs = {}
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            if not info["ret_slots"]:
                continue
            Fv = self._f_rows(asm, bi, v)
            if E is not None:
                Fv = Fv - _rows_apply(E, wc[info["pidx"]])
            for slot, gi, c, t in info["ret_slots"]:
                red = self.ev.slot_reduce(bi, slot, _rows_apply_t(jac[:, :, c : c + t], Fv))
                accs[gi] = red if gi not in accs else accs[gi] + red
        return asm["d_f"] * v + self._ret_assemble(accs, v)

    def _s_matmat(self, asm, v):
        """``S V`` for a retained block ``V (N_f, k)``: the product of
        ``_s_matvec`` on k columns in one pass over the rows (per slot one
        gather of (B, t, k), batched row products and one segment sum)."""
        k, e = v.shape[1], self.e_size
        fv_rows, wtv = {}, None
        for bi in self.e_batches:
            E = asm["per_batch"][bi][2]
            fv_rows[bi] = self._f_rows(asm, bi, v)  # (B, m, k)
            red = self.ev.slot_reduce(bi, self.batch_info[bi]["e_slot"],
                                      torch.bmm(E.transpose(1, 2), fv_rows[bi]).view(-1, e * k))
            wtv = red if wtv is None else wtv + red
        wc = None if wtv is None else torch.bmm(asm["cinv"], wtv.view(-1, e, k))
        accs = {}
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            if not info["ret_slots"]:
                continue
            Fv = fv_rows.pop(bi, None)
            if Fv is None:
                Fv = self._f_rows(asm, bi, v)
            if E is not None:
                Fv = Fv - torch.bmm(E, wc[info["pidx"]])
            for slot, gi, c, t in info["ret_slots"]:
                val = torch.bmm(jac[:, :, c : c + t].transpose(1, 2), Fv).view(-1, t * k)
                red = self.ev.slot_reduce(bi, slot, val)
                accs[gi] = red if gi not in accs else accs[gi] + red
            del Fv
        return asm["d_f"][:, None] * v + self._ret_assemble(accs, v)

    def _dense_s_probe(self, asm):
        """S by columns (``skeres_tpu/core/schur.py:1379-1388``): the S
        product applied to blocks of ``k = PROBE_CHUNK`` identity
        columns, then ``0.5 (S + S^T)``. Structure-agnostic: any number of
        observation batches, retained groups and retained slots. A Python
        loop over the ceil(N_f / k) chunks that reads nothing on the host,
        so a CUDA graph captures it."""
        n = self.num_f
        k = min(n, PROBE_CHUNK)
        d_f = asm["d_f"]
        s = d_f.new_empty((n, n))
        for c0 in range(0, n, k):
            w = min(k, n - c0)
            eye = d_f.new_zeros((n, w))
            eye[c0 : c0 + w].diagonal().fill_(1.0)
            s[:, c0 : c0 + w] = self._s_matmat(asm, eye)
        return 0.5 * (s + s.T)

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
        diag_blocks = self._schur_jacobi_blocks(asm, only_batch=self.e_batch)[0]
        diag_blocks = 0.5 * (diag_blocks + diag_blocks.transpose(1, 2))
        nc, f = plan.nc, plan.f
        s_mat = plan.dense_s_full(uniq, -diag_blocks.reshape(nc, f * f)).neg_()
        if self._add_other_batches(asm, s_mat):
            # the extra batches' contributions are not symmetric by construction
            s_mat = 0.5 * (s_mat + s_mat.T)
        return s_mat

    def _dense_s(self, asm):
        """Materialize S (N_f, N_f): dense W while it fits its gate, else
        the explicit pair-product plan, else the column probe (the JAX
        package's priority)."""
        if self.w_plan is not None:
            return self._dense_s_dense_w(asm)
        if self.explicit_plan is not None:
            return self._dense_s_explicit(asm)
        return self._dense_s_probe(asm)

    def _factor_solve(self, s, rhs, delta):
        """Solve (S + delta I) x = rhs, ``delta`` a device scalar read by no
        host: K1's L^-1 up to 1024 rows (of a copy of S with delta on its
        diagonal), K2's blocked factor above (delta added to the copy it
        factors in). S itself is left as it was. Returns ``(x, solve)``,
        ``solve`` applying the same factor to another right-hand side, so
        that the refinement reuses K1's L^-1 or K2's panels."""
        if s.shape[0] <= MAX_CHOLESKY_N:
            jittered = s.clone()
            jittered.diagonal().add_(delta)
            linv = cholesky_inverse_factor(jittered)
            solve = lambda b: chol_solve(linv, b)  # noqa: E731
        else:
            fac = blocked_cholesky_factor(s, jitter=delta)
            solve = lambda b: blocked_chol_solve(fac, b)  # noqa: E731
        return solve(rhs), solve

    def _block_inverse_apply(self, blocks):
        """v -> blockdiag(blocks)^-1 v over the retained coordinates, with
        ``blocks`` one (nb, t, t) tensor per retained group."""
        binvs = [batched_spd_inverse(blk) for blk in blocks]

        def apply(v):
            parts = [torch.einsum("bef,bf->be", binv, v[start : start + nb * t].view(nb, t))
                     .reshape(-1) for (start, nb, t), binv in zip(self.ret_blocks, binvs)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        return apply

    def _diag_blocks_of(self, s):
        """The (nb, t, t) diagonal blocks of dense S with one retained group."""
        _, nb, t = self.ret_blocks[0]
        blocks = torch.arange(nb, device=s.device)
        return s.view(nb, t, nb, t)[blocks, :, blocks, :]

    # -- public interface used by the minimizer ------------------------------------

    def solve_damped(self, data, g, diag, mu, min_diagonal, max_diagonal, jitter0=0.0):
        """Solve the damped system; returns (dx, linear_solver_iterations,
        jitter_used), the last two as device scalars (int64, g's dtype).

        ``jitter0`` is the caller's ratchet: the jitter that made the last
        factorization succeed, where DENSE_SCHUR's ladder starts (the
        iterative solver passes it through). ``mu`` and ``jitter0`` may be
        device scalars: nothing here reads a value on the host except
        through :func:`cond` and :func:`while_loop`, so a CUDA graph can
        capture it."""
        jitter0 = torch.as_tensor(jitter0, dtype=g.dtype, device=g.device)
        d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
        asm = self._assemble(data, g, d)
        rhs = self._schur_rhs(asm)
        if self.iterative:
            dx_f, iters = self._solve_iterative(asm, rhs)
            jitter_used = jitter0.clone()
        else:
            dx_f, iters, jitter_used = self._solve_dense(asm, rhs, jitter0)

        dx_e = self._back_substitute(asm, dx_f)
        dx = torch.empty_like(g)
        self._scatter_f(dx, dx_f)
        dx[self.elim_offset : self.elim_offset + self.elim_span] = dx_e.reshape(-1)
        return dx, iters, jitter_used

    def _solve_dense(self, asm, rhs, jitter0):
        """DENSE_SCHUR: factor the equilibrated S; (dx_f, iterations,
        jitter_used)."""
        s = self._dense_s(asm)
        # symmetric equilibration: factor D^-1/2 S D^-1/2 (pivots ~1); in
        # float32 it moves the point where assembly noise makes S
        # numerically indefinite out by orders of magnitude
        d_eq = torch.sqrt(torch.clamp(torch.diagonal(s), min=torch.finfo(s.dtype).tiny))
        s.div_(d_eq[:, None]).div_(d_eq[None, :])  # S is this solve's own
        rhs_eq = rhs / d_eq
        dx_f, solve = self._factor_solve(s, rhs_eq, jitter0)
        # mixed-precision refinement on the reduced camera system
        # (reference: use_mixed_precision_solves): residuals in float64,
        # corrections through the factor already made
        for _ in range(self.refinement_iterations):
            r64 = rhs_eq.double() - s.double() @ dx_f.double()
            dx_f = dx_f + solve(r64.to(s.dtype))

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
        iters = torch.ones((), dtype=torch.int64, device=rhs.device)

        def failed():
            return ~torch.isfinite(dx_f).all()

        def rung():
            dx_f.copy_(self._factor_solve(s, rhs_eq, delta)[0])
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
            if len(self.ret_blocks) == 1:  # the block-Jacobi preconditioner read off S
                precond = self._block_inverse_apply([self._diag_blocks_of(s)])
            else:  # the diagonal of S
                d_s = torch.clamp(torch.diagonal(s).abs(), min=torch.finfo(s.dtype).tiny)
                precond = lambda v: v / d_s  # noqa: E731
            x, _ = preconditioned_conjugate_gradients(
                lambda v: s @ v, rhs_eq, precond, FALLBACK_CG_ITERATIONS, 1e-8,
            )
            dx_f.copy_(x)
            iters.fill_(FALLBACK_CG_ITERATIONS)

        cond(failed(), first_rung)
        return dx_f / d_eq, iters, jitter_used

    def _solve_iterative(self, asm, rhs):
        """ITERATIVE_SCHUR: PCG on S, implicit or explicit, with the chosen
        preconditioner (``skeres_tpu/core/schur.py:1586-1693``); (dx_f,
        iterations)."""
        P = PreconditionerType
        kind = self.preconditioner_used
        if self.use_explicit:
            # reference: use_explicit_schur_complement: S once a solve, and
            # every PCG step one dense matrix-vector product
            s_explicit = self._dense_s_explicit(asm)
            s_matvec = lambda v: s_explicit @ v  # noqa: E731
        else:
            s_matvec = lambda v: self._s_matvec(asm, v)  # noqa: E731

        if self.use_explicit and kind == P.SCHUR_JACOBI and len(self.ret_blocks) == 1:
            # the block diagonal read off the explicit S
            precond = self._block_inverse_apply([self._diag_blocks_of(s_explicit)])
        elif kind == P.CLUSTER_JACOBI:
            precond = self._cluster_jacobi_precond(asm)
        elif kind == P.CLUSTER_TRIDIAGONAL:
            precond = self._cluster_tridiag_precond(asm)
        elif kind == P.SCHUR_JACOBI:
            precond = self._block_inverse_apply(self._schur_jacobi_blocks(asm))
        elif kind == P.POWER_SERIES_EXPANSION:
            precond = self._power_series_precond(asm, s_matvec)
        else:  # JACOBI and IDENTITY: diagonal scaling
            d_f = torch.clamp(asm["d_f"] + self._ftf_diag(asm), min=torch.finfo(rhs.dtype).tiny)
            precond = lambda v: v / d_f  # noqa: E731

        # reference parity (iterative_schur_complement_solver.cc): the Q
        # test with q_tolerance = eta; the residual test is off
        return preconditioned_conjugate_gradients(
            s_matvec, rhs, precond, self.max_cg_iterations, 0.0, q_tolerance=self.eta
        )

    def _power_series_precond(self, asm, s_matvec):
        """POWER_SERIES_EXPANSION (reference:
        ``power_series_expansion_preconditioner.cc``): with
        ``B = blockdiag(F^T F) + D_f``,
        ``S^-1 ~= sum_k (B^-1 W C^-1 W^T)^k B^-1``, and each term uses
        ``W C^-1 W^T y = B y - S y``: one S product a term. The series
        stops once its latest term is small against the sum
        (``spse_tolerance``), at most ``max_power_series_terms`` terms."""
        binv_apply = self._block_inverse_apply(
            self._schur_jacobi_blocks(asm, include_e_correction=False))
        n_terms = self.max_power_series_terms
        tol2 = self.spse_tolerance ** 2

        def precond(v):
            y = binv_apply(v).clone()
            acc = y.clone()
            k = torch.zeros((), dtype=torch.int64, device=v.device)

            def more():
                return (k < n_terms) & (torch.dot(y, y) > tol2 * torch.dot(acc, acc))

            def term():
                y.sub_(binv_apply(s_matvec(y)))
                acc.add_(y)
                k.add_(1)

            while_loop(more, term)
            return acc

        return precond

    # -- the cluster preconditioners ------------------------------------------------

    def _cluster_mats(self, asm):
        """The (ncl, cs*f, cs*f) block-diagonal-of-S cluster matrices (the
        pair correction by K3 over the cluster plan, the per-camera
        diagonal blocks, the damping), the unique-pair table (the
        TRIDIAGONAL band reads it too) and each cluster's largest diagonal
        entry (ncl, 1), the scale of the factor's boost."""
        plan = self.cluster_plan
        f = plan.f
        ncl, cs = plan.n_clusters, plan.cluster_slot_size
        uniq = plan.correction_offdiag(
            asm["explicit_grid"], asm["cinv"].reshape(-1, self.e_size ** 2))
        mats = -plan.cluster_offdiag(uniq)
        # the per-camera blocks F^T F - sum_r Y_r A_r^T + D_f into the
        # cluster slots; a padded slot takes the identity, so the factor
        # stays positive definite
        db = self._schur_jacobi_blocks(asm)[0]
        db = torch.cat([db, torch.eye(f, dtype=db.dtype, device=db.device)[None]])
        slots = torch.arange(cs, device=db.device)
        m5 = mats.view(ncl, cs, f, cs, f)
        m5[:, slots, :, slots, :] += db[self._cluster_slot_cam].view(ncl, cs, f, f).transpose(0, 1)
        dmax = torch.clamp(
            torch.diagonal(mats, dim1=1, dim2=2).amax(dim=1, keepdim=True),
            min=torch.finfo(mats.dtype).tiny,
        )
        return mats, uniq, dmax

    def _robust_linv(self, mats, dmax):
        """L^-1 of each matrix of the batch (..., n, n) by the adaptive
        boost ladder {0, cluster_boost, 1e-1}, each boost relative to
        ``dmax`` (..., 1), the cluster's largest diagonal entry. Rung 0
        factors the true matrices; a rung is accepted for a matrix by the
        factorization residual ``||L L^T - M|| <= 1e-3 ||M||``: a factor in
        low precision of a nearly singular matrix can come out finite and
        wrong, which a finiteness test misses and the residual cannot.
        Where nothing passed, the most regularized factor stays: a
        preconditioner only has to be roughly right."""
        boost0 = max(self.cluster_boost, 1e-5)
        tol = 1e-3
        eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)

        def factor_ok(chol, m):
            finite = torch.isfinite(chol).all(dim=(-2, -1))
            rn = torch.sqrt(torch.sum((chol @ chol.transpose(-1, -2) - m) ** 2, dim=(-2, -1)))
            mn = torch.sqrt(torch.sum(m * m, dim=(-2, -1)))
            return finite & (rn <= tol * mn + torch.finfo(m.dtype).tiny)

        chol = cholesky_nan(mats)
        ok = factor_ok(chol, mats)
        for eps_rel in (boost0, 1e-1):
            m_b = mats + (eps_rel * dmax)[..., None] * eye
            chol_b = cholesky_nan(m_b)
            ok_b = factor_ok(chol_b, m_b)
            chol = torch.where((~ok & ok_b)[..., None, None], chol_b, chol)
            ok = ok | ok_b
        chol = torch.where(ok[..., None, None], chol, chol_b)
        chol = torch.where(torch.isfinite(chol), chol, 0.0)
        return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)

    def _to_cluster_slots(self, v):
        """Camera blocks of a retained vector -> (ncl, cs*f) cluster rows
        (zero in padded slots)."""
        plan = self.cluster_plan
        vb = torch.cat([v.reshape(-1, plan.f), v.new_zeros((1, plan.f))])
        return vb[self._cluster_slot_cam].reshape(plan.n_clusters, -1)

    def _from_cluster_slots(self, x):
        return x.reshape(-1, self.cluster_plan.f)[self._cluster_pos_of_cam].reshape(-1)

    def _cluster_jacobi_precond(self, asm):
        """CLUSTER_JACOBI: the block diagonal of S by camera cluster,
        factored once a damped solve (a batched Cholesky and one batched
        triangular solve against the identity); each PCG step applies
        ``L^-T L^-1`` as two batched matrix-vector products."""
        mats, _, dmax = self._cluster_mats(asm)
        linv = self._robust_linv(mats, dmax)

        def precond(v):
            y = torch.einsum("bij,bj->bi", linv, self._to_cluster_slots(v))
            return self._from_cluster_slots(torch.einsum("bji,bj->bi", linv, y))

        return precond

    def _cluster_tridiag_precond(self, asm):
        """CLUSTER_TRIDIAGONAL (reference:
        ``visibility_based_preconditioner.cc``): the CLUSTER_JACOBI
        diagonal plus the band coupling adjacent clusters, factored by
        block LDL^T along the cluster chain once a damped solve; each PCG
        step is a forward and a backward sweep of matrix-vector products.
        The clusters are contiguous ranges of camera indices (the
        reference couples clusters along a spanning forest of the
        visibility graph)."""
        plan = self.cluster_plan
        ncl = plan.n_clusters
        mats, uniq, dmax = self._cluster_mats(asm)
        # band[c] couples cluster c (rows) to c + 1 (columns); the correction
        # enters S negated, as in the diagonal's matrices
        band = -plan.cluster_band_offdiag(uniq)

        def safe_inv(m, dmax_c):
            linv = self._robust_linv(m, dmax_c)
            return linv.T @ linv

        # dhat_0 = D_0; L_c = B_{c-1}^T dhat_{c-1}^-1; dhat_c = D_c - L_c B_{c-1}
        dh_inv = safe_inv(mats[0], dmax[0])
        dhatinv, l_blocks = [dh_inv], []
        for c in range(1, ncl):
            l_c = band[c - 1].T @ dh_inv
            dh = mats[c] - l_c @ band[c - 1]
            dh_inv = safe_inv(0.5 * (dh + dh.T), dmax[c])
            dhatinv.append(dh_inv)
            l_blocks.append(l_c)
        dhatinv = torch.stack(dhatinv)

        def precond(v):
            vb = self._to_cluster_slots(v)
            z = [vb[0]]  # forward: L z = r
            for c in range(1, ncl):
                z.append(vb[c] - l_blocks[c - 1] @ z[-1])
            w = torch.einsum("bij,bj->bi", dhatinv, torch.stack(z))
            x = [w[-1]]  # backward: L^T x = w
            for c in range(ncl - 2, -1, -1):
                x.append(w[c] - l_blocks[c].T @ x[-1])
            return self._from_cluster_slots(torch.stack(x[::-1]))

        return precond

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
        return self.ev.all_reduce(total)

    def jtj_matvec(self, data, v):
        """Full-space (J^T J) v from the resident blocks; ``data`` is a
        ``prepare()`` dict or raw solver data."""
        pairs = (
            [(r, jac) for (r, jac, _) in data["per_batch"]]
            if isinstance(data, dict)
            else data
        )
        return self.ev.jtj_matvec(
            [BatchBlocks(r, jac, self.ev._batch_const[bi][2]) for bi, (r, jac) in enumerate(pairs)],
            v,
        )
