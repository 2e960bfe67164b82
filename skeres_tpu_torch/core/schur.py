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
    pair-product plan, K3 again; contiguous index clusters where
    ``visibility_clustering`` is unset, else the visibility clusters and
    chains of ``core/visibility.py``, built and applied by
    :func:`cluster_preconditioner` and :func:`apply_cluster_preconditioner`).
    It is the only Schur path where S itself passes
    ``explicit_schur_limit_bytes``;
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

The camera-padded layout (``sort_threshold``, ``pad_waste``; the JAX
package's, ``skeres_tpu/core/schur.py:237-332``): an observation batch of
at least ``sort_threshold`` rows with one retained slot, whose cameras see
at most K rows each with ``nc K <= pad_waste B``, is placed once a
linearization into a dense (nc, K) grid of rows (one ``index_select`` of
``(jac | r)``, a zero row in every unused slot). Every camera-side sum on
it is then ``reshape(nc, K, D).sum(1)``, whose order is fixed, where the
generic path sums by ``index_add_``, whose float32 order on the card is
not; a camera's vector reaches its rows as a broadcast, not a gather.
``gradient_and_diag`` places the unscaled rows and ``prepare`` reuses
them, so every padded product conjugates with the Jacobi scale
(``_cam_conj``; ones where ``prepare`` placed rows that came scaled); the
S product too, which the JAX package's does not (``_s_matvec``). Under a
mesh each rank places its own rows into a grid of its own, with the K of
the widest shard, and each camera sum is the rank's reshape-and-sum, then
one ``all_reduce``.

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

The camera blocks of S (DENSE_SCHUR's explicit diagonal, SCHUR_JACOBI,
POWER_SERIES_EXPANSION's base matrix, the cluster preconditioners) come
from the placed rows of a padded batch (``ops/s_product.camera_blocks``, a
kernel on the card) and row by row from every other batch
(``_schur_jacobi_blocks``). ``prepare()`` lays the per-row
``A = F^T E`` blocks on a plan's point grid (explicit or cluster) once a
linearization, since they do not depend on mu: a rejected step's re-solve
pays only the ``C^-1``-dependent pair products.
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
from skeres_tpu_torch.core.visibility import ChainLayout, plan_visibility
from skeres_tpu_torch.ops.cholesky import (
    MAX_CHOLESKY_N,
    blocked_chol_solve,
    blocked_cholesky_factor,
    chol_solve,
    cholesky_inverse_factor,
)
from skeres_tpu_torch.ops.s_product import (
    MAX_SIZES,
    camera_blocks,
    camera_sums,
    point_sums,
    rows_apply,
    rows_apply_t,
)
from skeres_tpu_torch.ops.segment_reduce import (
    apply_reduce_plan,
    apply_sharded_reduce_plan,
    build_reduce_plan,
    build_sharded_reduce_plan,
)
from skeres_tpu_torch.ops.small_inverse import batched_spd_inverse
from skeres_tpu_torch.parallel.mesh import shard_rows
from skeres_tpu_torch.utils.trace import span

__all__ = ["SchurSolver", "apply_cluster_preconditioner", "cluster_preconditioner",
           "dense_cluster_solve", "implicit_s_product", "padded_plan"]

DENSE_W_LIMIT_BYTES = 2 << 30  # the JAX package's gate (as float32 bytes)
PROBE_CHUNK = 128  # the identity columns the column-probe S applies S to at once
FALLBACK_CG_ITERATIONS = 32


def _cam_padded_src(idx, nc: int, K: int, n_valid=None, sentinel=None) -> torch.Tensor:
    """The row placement of the camera-padded layout
    (``skeres_tpu/core/schur.py:55``), on the device of ``idx`` (int64
    (B,), a tensor or an array): ``src`` (nc*K,) with ``src[cam*K + j]``
    the row of camera ``cam``'s j-th observation (in row order), and
    ``sentinel`` (a zero row the caller appends; default ``len(idx)``) in
    the unused slots. Only the first ``n_valid`` rows are placed (default
    all)."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    dev = idx.device
    b = len(idx)
    sentinel = b if sentinel is None else sentinel
    n_valid = b if n_valid is None else n_valid
    sorted_cam, order = torch.sort(idx[:n_valid], stable=True)
    starts = torch.searchsorted(sorted_cam, torch.arange(nc, device=dev))
    pos = torch.arange(n_valid, device=dev) - starts[sorted_cam]
    src = torch.full((nc * K,), sentinel, dtype=torch.int64, device=dev)
    src[sorted_cam * K + pos] = order
    return src


def padded_plan(cam_idx, pt_idx, nc: int, n_shards: int, rank: int, sort_threshold: int,
                pad_waste: float):
    """The gates and the placement of the camera-padded layout of one
    observation batch (``skeres_tpu/core/schur.py:251-332``), rows
    ``cam_idx`` / ``pt_idx`` (B,) (int64 tensors or arrays; the plan is
    built on their device) split over ``n_shards`` as the evaluator splits
    them (``shard_rows``). It engages for B >= ``sort_threshold`` and
    ``n_shards nc K <= pad_waste B``, K the most rows of one camera on one
    shard (the JAX package's local form where ``n_shards`` is 1). Returns
    ``(K, (src, pidx_pad))`` for shard ``rank``: its rows' placement
    (sentinel: its row count) and the point of each placed row (point 0
    for the sentinel's zero row); or ``(None, reason)``."""
    cam = torch.as_tensor(cam_idx, dtype=torch.int64)
    n_rows = len(cam)
    if n_rows < sort_threshold:
        return None, f"{n_rows} rows < jacobian_sort_threshold {sort_threshold}"
    bounds = [shard_rows(n_rows, n_shards, k) for k in range(n_shards)]
    K = max(int(torch.bincount(cam[lo:hi], minlength=nc).max()) if hi > lo else 0
            for lo, hi in bounds)
    if K == 0 or n_shards * nc * K > pad_waste * n_rows:
        return None, (f"waste {n_shards * nc * K / max(n_rows, 1):.3f} > "
                      f"jacobian_pad_waste {pad_waste}")
    lo, hi = bounds[rank]
    src = _cam_padded_src(cam[lo:hi], nc, K)
    pt = torch.as_tensor(pt_idx, dtype=torch.int64, device=cam.device)
    pidx_pad = torch.cat([pt[lo:hi], pt.new_zeros(1)])[src]
    return K, (src, pidx_pad)


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
        sort_threshold: int = 100_000,
        pad_waste: float = 1.5,
        use_explicit: bool = False,
        explicit_s_limit_bytes: int = 2 << 30,
        pair_cap: int = 32,
        cluster_size: int = 64,
        cluster_boost: float = 1e-3,
        visibility_clustering=None,
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
        # index per row, and the retained columns (with, below, their
        # retained-space indices: the scatter of batches that add to S
        # outside the observation batches, e.g. camera priors)
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
            ))
            if e_slots and ret_slots:
                e_batches.append(bi)
        # any number of eliminated x retained batches; ``e_batch`` names the
        # one observation batch where there is exactly one (the candidate of
        # the dense-W, explicit and cluster paths)
        self.e_batches = e_batches
        self.e_batch = e_batches[0] if len(e_batches) == 1 else None
        # the retained-space index of each retained column of each row, for
        # the batches that _add_other_batches scatters into S; not for the
        # observation batch, whose (B, n_f) map nothing reads (at 29M rows
        # a 2 GB host gather and copy)
        for bi, (b, info) in enumerate(zip(program.batches, self.batch_info)):
            if bi != self.e_batch and len(info["f_cols"]):
                rows = b.tangent_index[slice(*evaluator.row_range[bi])]
                info["fidx"] = torch.as_tensor(
                    self.glob2ret[rows[:, info["f_cols"].cpu().numpy()]]).to(device)

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
            with span("skeres.plan.w"):
                if mesh is None:
                    return build_reduce_plan(lin, self.num_points * self.num_cams, device)
                return build_sharded_reduce_plan(lin[slice(*evaluator.row_range[self.e_batch])],
                                                 self.num_points * self.num_cams, device)

        if w_fits and mesh is None:
            self.w_plan = make_w_plan()

        def make_plan(**kw):
            with span("skeres.plan.pairs"):
                return ExplicitSchurPlan(
                    cam_idx=self._whole_rows(self.e_batch, self.f_slot),
                    pt_idx=self._whole_rows(self.e_batch, self.e_slot), num_cameras=self.num_cams,
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
        # visibility_based_preconditioner.cc), on the BA structure. With
        # ``visibility_clustering`` the clusters and chains come from the
        # cameras' visibility (core/visibility.py) and ``cluster_layout``
        # lays them out for cluster_preconditioner; unset, they are
        # contiguous ranges of ``cluster_size`` camera indices and one chain
        # in index order (the JAX package's). It has no size cap: the
        # cluster-restricted unique-pair table stays small however many
        # cameras, which is the regime past the explicit-S gate.
        self.cluster_plan = None
        self.visibility = None  # the visibility clusters (VisibilityClusters)
        self.cluster_layout = None
        cluster_kinds = (PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL)
        if self._ba and iterative and preconditioner in cluster_kinds:
            band = preconditioner == PreconditionerType.CLUSTER_TRIDIAGONAL
            with span("skeres.plan.cluster"):
                chain_of = None
                if visibility_clustering is not None:
                    if mesh is not None:
                        raise NotImplementedError(
                            "visibility_clustering_type under a mesh: the visibility clusters "
                            "are planned from every row on one device; unset it, or solve on "
                            "one device")
                    self.visibility = plan_visibility(
                        self._whole_rows(self.e_batch, self.f_slot),
                        self._whole_rows(self.e_batch, self.e_slot), self.num_cams,
                        self.num_points, visibility_clustering, chains=band)
                    cluster_of = self.visibility.cluster_of.cpu().numpy()
                    chain_of = self.visibility.chain_of.cpu().numpy()
                else:
                    cluster_of = np.arange(self.num_cams) // max(cluster_size, 1)
                try:
                    self.cluster_plan = make_plan(cluster_of=cluster_of, cluster_band=band,
                                                  chain_of=chain_of)
                except ValueError:
                    self.cluster_plan = None
                if self.cluster_plan is not None and self.visibility is not None:
                    self.cluster_layout = ChainLayout(self.visibility, self.f_size,
                                                      self.cluster_plan)
                elif self.cluster_plan is not None:
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

        # the camera-padded layout, per observation batch
        self.sorted_info = {}
        self._layout_notes = []
        with span("skeres.plan.layout"):
            for bi in e_batches:
                self._plan_padded(bi, sort_threshold, pad_waste)
        # the S product's point pass (implicit_s_product) applies C^-1 and
        # s_e itself where the one observation batch is padded
        self._one_padded = len(e_batches) == 1 and e_batches[0] in self.sorted_info

    def _whole_rows(self, bi, s):
        """Slot ``s``'s block of every row of batch ``bi``, on the solver's
        device, for the plans: the evaluator's copy where it holds every
        row (no mesh), else the program's."""
        if self.ev.mesh is None:
            return self.ev._batch_const[bi][1][s]
        return torch.as_tensor(self.ev.program.batches[bi].slot_indices[s], device=self.ev.device)

    def _plan_padded(self, bi, sort_threshold, pad_waste):
        """The camera-padded layout of batch ``bi`` where its gates hold
        (one retained slot; sizes the kernels of ``ops/s_product.py``
        take; then ``padded_plan``): ``sorted_info[bi]`` with
        the rank's placement ``src``, the point of each placed row
        ``pidx_pad``, nc and K; else the refusing gate in
        ``_layout_notes``."""
        ev = self.ev
        program = ev.program
        b = program.batches[bi]
        info = self.batch_info[bi]
        if len(info["ret_slots"]) != 1:
            self._layout_notes.append(f"batch {bi}: off (structure: "
                                      f"{len(info['ret_slots'])} retained slots a row)")
            return
        s, gi, _, t = info["ret_slots"][0]
        sizes = (b.residual_dim, t, self.e_size)
        if any(x > most for x, most in zip(sizes, MAX_SIZES)):
            self._layout_notes.append(f"batch {bi}: off (S product kernels: (m, t, e) {sizes} "
                                      f"past {MAX_SIZES})")
            return
        nc = program.groups[gi].num_blocks
        K, plan = padded_plan(self._whole_rows(bi, s), self._whole_rows(bi, info["e_slot"]), nc,
                              ev.n_shards, ev.rank, sort_threshold, pad_waste)
        if K is None:
            self._layout_notes.append(f"batch {bi}: off (gate: {plan})")
            return
        src, pidx_pad = plan
        kind = "local" if ev.mesh is None else "sharded"
        # the S product's kernel plans (ops/s_product.py): the rank's rows
        # by point, as offsets into row order or, where the rows are not in
        # point order, into a permutation sorted by point; and the placed
        # rows of each camera that hold observations (the first of its K)
        idx = ev._batch_const[bi][1]
        pt, perm = idx[info["e_slot"]], None
        if len(pt) > 1 and not bool((pt[1:] >= pt[:-1]).all()):
            pt, perm = torch.sort(pt, stable=True)
        self.sorted_info[bi] = dict(
            kind=kind, nc=nc, K=K, src=src, pidx_pad=pidx_pad,
            f_first=info["ret_slots"][0][2] < info["e_col"], pt_perm=perm,
            pt_seg=torch.searchsorted(pt, torch.arange(self.num_points + 1, device=pt.device)),
            cam_rows=torch.bincount(idx[s], minlength=nc))
        m, T = b.residual_dim, b.block_tangent_size
        placed = nc * K * m * (T + 1) * torch.finfo(ev.dtype).bits // 8
        shards = "" if ev.mesh is None else f", {ev.n_shards} shards"
        self._layout_notes.append(
            f"batch {bi}: {nc} x {K} ({kind}{shards}), waste "
            f"{ev.n_shards * nc * K / b.num_blocks:.4f}, placed {placed / 2**20:.1f} MiB a rank")

    @property
    def camera_padded_layout(self) -> str:
        """Where each observation batch took the camera-padded layout (nc x
        K, the waste ns nc K / B, the placed copy's size), or the gate
        that refused it (``Summary.camera_padded_layout``)."""
        return "; ".join(self._layout_notes)

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

    # -- the camera-padded layout -----------------------------------------------

    def _place_rows(self, bi, *parts):
        """Place the rank's rows of batch ``bi``, the column blocks
        ``parts`` (each (B, w_i)) side by side, into the camera-padded order:
        (nc*K, sum w_i), one ``index_select`` over the rows and a zero row
        that every unused slot reads."""
        with span("skeres.schur.place"):
            sinfo = self.sorted_info[bi]
            n = parts[0].shape[0]
            rows = parts[0].new_empty((n + 1, sum(p.shape[1] for p in parts)))
            c = 0
            for p in parts:
                rows[:n, c : c + p.shape[1]] = p
                c += p.shape[1]
            rows[n].zero_()
            return rows.index_select(0, sinfo["src"])

    def _cam_fe(self, asm, bi):
        """The placed rows of padded batch ``bi``: (its retained group, their
        F columns (nc*K, m, t), their E columns (nc*K, m, e), the point of
        each row (nc*K,))."""
        info = self.batch_info[bi]
        _, gi, c, t = info["ret_slots"][0]
        rows = self._placed(asm, bi)
        ec = info["e_col"]
        return (gi, rows[:, :, c : c + t], rows[:, :, ec : ec + self.e_size],
                self.sorted_info[bi]["pidx_pad"])

    def _cam_reduce(self, bi, vals):
        """Sum the placed rows' values ``vals (nc*K, ...)`` of the batch's
        ``nc`` cameras by camera -> ``(nc, ...)``: a reshape and a sum, in a
        fixed order; under a mesh the rank's sums, then one ``all_reduce``
        of the table. (The JAX
        package's ``_cam_reduce`` also takes the row function and its
        operands, for ``shard_map``; here the caller computes the rows.)"""
        red = vals.reshape(-1, self.sorted_info[bi]["K"], *vals.shape[1:]).sum(1)
        return self.ev.all_reduce(red)

    def _point_pass(self, asm, bi, v, cinv=None, s_e=None):
        """``W^T v`` by point over padded batch ``bi``'s scaled rows in row
        order, times ``C^-1`` and ``s_e`` where given
        (``ops/s_product.point_sums``): (n_pts, e), the rank's rows."""
        sinfo = self.sorted_info[bi]
        s, gi = self.batch_info[bi]["ret_slots"][0][:2]
        return point_sums(asm["per_batch"][bi][1], sinfo["f_first"], self.ev._batch_const[bi][1][s],
                          self._ret_view(v, gi), sinfo["pt_seg"], sinfo["pt_perm"], cinv, s_e)

    def _placed(self, asm, bi):
        """The placed rows of padded batch ``bi`` as the kernels of
        ``ops/s_product`` take them: (nc*K, m, T)."""
        return asm["cam"][bi].unflatten(1, (self.ev.program.batches[bi].residual_dim, -1))

    def _camera_pass(self, asm, bi, v, wc):
        """``s_f F^T (F (s_f v) - E wc)`` by camera over padded batch
        ``bi``'s placed rows (``ops/s_product.camera_sums``): (nc, t), the
        rank's rows."""
        sinfo = self.sorted_info[bi]
        gi = self.batch_info[bi]["ret_slots"][0][1]
        return camera_sums(self._placed(asm, bi), sinfo["f_first"], sinfo["pidx_pad"],
                           sinfo["cam_rows"], self._ret_view(v, gi), wc,
                           self._cam_conj(asm, bi)[1])

    def _cam_bcast(self, bi, rows, v_cam):
        """The per-row product ``rows (nc*K, m, t) @ v_cam[camera of the
        row]`` (nc*K, m), with each camera's vector ``v_cam (nc, t)``
        broadcast over its K slots, no gather."""
        sinfo = self.sorted_info[bi]
        nc, K = sinfo["nc"], sinfo["K"]
        m, t = rows.shape[1:]
        return (rows.view(nc, K, m, t) * v_cam[:, None, None, :]).sum(-1).view(nc * K, m)

    def _cam_conj(self, asm, bi):
        """The Jacobi scale that the placed rows of padded batch ``bi``
        leave out (``cam_scale``: ones where ``prepare`` placed rows that
        came scaled): (s_ret (N_f,), s_f (nc, t) of its retained group,
        s_e (n_pts, e)). The scaling is diagonal, J_s = J S, so every padded
        product takes the scale on its inputs and outputs instead of a pass
        over the placed rows."""
        scale = asm["cam_scale"]
        gi = self.batch_info[bi]["ret_slots"][0][1]
        s_ret = self._gather_f(scale)
        return s_ret, self._ret_view(s_ret, gi), self._gather_ge(scale)

    def gradient_and_diag(self, blocks):
        """g = J^T r and diag(J^T J) as ``Evaluator.gradient_and_diag``
        gives them, with the camera sums of every padded batch taken on its
        placed rows, and the placed copies for ``prepare`` to reuse
        (``skeres_tpu/core/schur.py:579-687``). Returns (g, diag, cam_raw):
        ``cam_raw[bi]`` the unscaled placed Jacobian rows (nc*K, m*T) of
        batch bi (one placement of ``(jac | r)``), and ``cam_raw[-1]`` the
        undamped E^T E (n_pts, e*e), which rides the point-side reduction
        of g and diag. Point-side sums and the other batches take the
        evaluator's reductions; where no batch is padded, all of g and diag
        do, and ``cam_raw`` is None."""
        ev = self.ev
        if not self.sorted_info:
            return (*ev.gradient_and_diag(blocks), None)
        program = ev.program
        e = self.e_size
        accs = [torch.zeros((g.num_blocks, 2 * g.tangent_size), dtype=ev.dtype, device=ev.device)
                for g in program.groups]
        cam_raw = {}
        for bi in self.sorted_info:
            _, gi, c, t = self.batch_info[bi]["ret_slots"][0]
            b = blocks[bi]
            n, m, T = b.jac.shape
            placed = self._place_rows(bi, b.jac.reshape(n, m * T), b.r)
            cam_raw[bi] = placed[:, : m * T]
            F = placed[:, : m * T].unflatten(1, (m, T))[:, :, c : c + t]
            vals = torch.cat([rows_apply_t(F, placed[:, m * T :]), (F * F).sum(1)], dim=1)
            accs[gi] = accs[gi] + self._cam_reduce(bi, vals)
        ete0_raw = None
        for bi, b in enumerate(blocks):
            info = self.batch_info[bi]
            padded_slot = info["ret_slots"][0][0] if bi in self.sorted_info else None
            for s, gi in enumerate(program.batches[bi].slot_groups):
                if s == padded_slot:
                    continue
                c, t = ev._slot_cols[bi][s]
                cols = b.jac[:, :, c : c + t]
                gb = rows_apply_t(cols, b.r)
                if s == info["e_slot"]:
                    ete = torch.einsum("bme,bmf->bef", cols, cols).reshape(-1, e * e)
                    red = ev.slot_reduce(bi, s, torch.cat([gb, ete], dim=1))
                    # the diagonal of each flat (e, e) block: a strided
                    # slice, no index list (which a CUDA graph cannot copy)
                    accs[gi] = accs[gi] + torch.cat([red[:, :e], red[:, e :: e + 1]], dim=1)
                    ete0_raw = red[:, e:] if ete0_raw is None else ete0_raw + red[:, e:]
                    continue
                vals = torch.cat([gb, (cols * cols).sum(1)], dim=1)
                accs[gi] = accs[gi] + ev.slot_reduce(bi, s, vals)
        if ete0_raw is not None:
            cam_raw[-1] = ete0_raw
        g = ev.assemble_tangent([a[:, : a.shape[1] // 2] for a in accs])
        diag = ev.assemble_tangent([a[:, a.shape[1] // 2 :] for a in accs])
        return g, diag, cam_raw

    # -- per-linearization and per-mu assembly -----------------------------------

    def prepare(self, data, cam_raw=None, scale=None):
        """Everything that does not depend on mu, once per linearization:
        the E split, the undamped per-point ``E^T E``, the placed rows of
        every padded batch (``cam``) with the scale they leave out
        (``cam_scale``), and the A = F^T E rows on the point grid where a
        plan (explicit or cluster: one layout) has K3 read them. Rejected
        steps re-solve with a new mu from the same prepared data.

        ``cam_raw`` and ``scale``: what ``gradient_and_diag`` placed
        (unscaled) and the Jacobi scale ``data`` carries. The placed rows
        are then reused as they are, ``cam_scale`` is ``scale``, and E^T E
        is ``cam_raw[-1]`` conjugated (``skeres_tpu/core/schur.py:689-747``);
        without them the rows of ``data`` are placed as they come and
        ``cam_scale`` is ones."""
        with span("skeres.schur.prepare"):
            e = self.e_size
            ete0_raw = None if cam_raw is None or scale is None else cam_raw.get(-1)
            ete0 = None
            if ete0_raw is not None:
                s_e = self._gather_ge(scale)
                ete0 = ete0_raw.view(self.num_points, e, e) * s_e[:, :, None] * s_e[:, None, :]
            per_batch = []
            for bi, (r, jac) in enumerate(data):
                E = self._split_E(bi, jac)
                if E is not None and ete0_raw is None:
                    outer = torch.einsum("bme,bmf->bef", E, E).reshape(-1, e * e)
                    s_e = self.ev.program.batches[bi].slot_groups.index(self.elim_group)
                    red = self.ev.slot_reduce(bi, s_e, outer).reshape(self.num_points, e, e)
                    ete0 = red if ete0 is None else ete0 + red
                per_batch.append((r, jac, E))
            if ete0 is None:  # no residual touches the eliminated blocks
                ete0 = data[0][1].new_zeros((self.num_points, e, e))
            prep = dict(per_batch=per_batch, ete0=ete0)
            if self.sorted_info:
                reuse = cam_raw is not None and scale is not None
                prep["cam"] = {bi: cam_raw[bi] if reuse else
                               self._place_rows(bi, data[bi][1].flatten(1))
                               for bi in self.sorted_info}
                prep["cam_scale"] = (scale if reuse else
                                     ete0.new_ones(self.ev.program.num_tangent))
            plan = self.explicit_plan or self.cluster_plan
            if plan is not None:
                with span("skeres.schur.grid"):
                    prep["explicit_grid"] = plan.build_grid(self._explicit_a_flat(per_batch))
            return prep

    def _explicit_a_flat(self, per_batch):
        """The per-row A = F^T E blocks, flat: (B, f*e), f-major."""
        _, jac, E = per_batch[self.e_batch]
        Fs = jac[:, :, self.f_col : self.f_col + self.f_size]
        return torch.einsum("bmf,bme->bfe", Fs, E).reshape(jac.shape[0], -1)

    def _assemble(self, data, g, d):
        """Per-mu elimination state: damped C^-1 and the rhs pieces.
        ``data`` is a ``prepare()`` dict or raw ``solver_data``; ``d`` is the
        clamped damping diagonal (N,), mu included."""
        prep = data if isinstance(data, dict) else self.prepare(data)
        d_e = self._gather_ge(d)
        ete = prep["ete0"] + torch.diag_embed(d_e)
        return dict(
            per_batch=prep["per_batch"],
            cam=prep.get("cam"),
            cam_scale=prep.get("cam_scale"),
            explicit_grid=prep.get("explicit_grid"),
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
        observation batch and each of its retained slots; a padded batch
        on its placed rows, ``F_s^T (E_s v_e) = s_f (F^T (E (s_e v_e)))``."""
        accs = {}
        for bi in self.e_batches:
            info = self.batch_info[bi]
            if bi in self.sorted_info:
                gi, F, E, pidx = self._cam_fe(asm, bi)
                _, s_f, s_e = self._cam_conj(asm, bi)
                red = self._cam_reduce(bi, rows_apply_t(F, rows_apply(E, (v_e * s_e)[pidx]))) * s_f
                accs[gi] = red if gi not in accs else accs[gi] + red
                continue
            _, jac, E = asm["per_batch"][bi]
            Ev = rows_apply(E, v_e[info["pidx"]])
            for s, gi, c, t in info["ret_slots"]:
                red = self.ev.slot_reduce(bi, s, rows_apply_t(jac[:, :, c : c + t], Ev))
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
            part = (rows_apply(jac[:, :, c : c + t], vs) if v_f.dim() == 1
                    else torch.bmm(jac[:, :, c : c + t], vs))
            out = part if out is None else out + part
        return out

    def _wt_apply(self, asm, v_f):
        """W^T v_f (retained -> points): (N_f,) -> (n_pt, e), summed over
        every observation batch. A padded batch takes its rows in row order
        here too (as the JAX package's): the sums are by point, which row
        order keeps contiguous."""
        out = None
        for bi in self.e_batches:
            E = asm["per_batch"][bi][2]
            red = self.ev.slot_reduce(bi, self.batch_info[bi]["e_slot"],
                                      rows_apply_t(E, self._f_rows(asm, bi, v_f)))
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

        A padded batch gives its blocks from its placed rows
        (``_padded_blocks``); every retained slot of every other batch adds
        its ``F^T F`` summed by block, minus its per-row ``Y A^T``
        (``A = F^T E``, ``Y = A C_p^-1``) summed apart."""
        with span("skeres.schur.blocks"):
            outs = {}
            for bi in self.sorted_info:
                if only_batch is None or bi == only_batch:
                    gi = self.batch_info[bi]["ret_slots"][0][1]
                    red = self._padded_blocks(asm, bi, include_e_correction)
                    outs[gi] = red if gi not in outs else outs[gi] + red
            for bj, (rb, jacb, Eb) in enumerate(asm["per_batch"]):
                if bj in self.sorted_info or (only_batch is not None and bj != only_batch):
                    continue
                info = self.batch_info[bj]
                for slot, gi, c, t in info["ret_slots"]:
                    Fs = jacb[:, :, c : c + t]
                    ftf = torch.einsum("bmf,bmg->bfg", Fs, Fs).reshape(-1, t * t)
                    red = self.ev.slot_reduce(bj, slot, ftf).view(-1, t, t)
                    if Eb is not None and include_e_correction:
                        a = torch.einsum("bmf,bme->bfe", Fs, Eb)
                        y = torch.einsum("bfe,beg->bfg", a, asm["cinv"][info["pidx"]])
                        yat = torch.einsum("bfe,bge->bfg", y, a).reshape(-1, t * t)
                        red = red - self.ev.slot_reduce(bj, slot, yat).view(-1, t, t)
                    outs[gi] = red if gi not in outs else outs[gi] + red
            d_f = asm["d_f"]
            blocks = []
            for (start, nb, t), gi in zip(self.ret_blocks, self._ret_group_order):
                dd = torch.diag_embed(d_f[start : start + nb * t].view(nb, t))
                blocks.append(dd if gi not in outs else outs[gi] + dd)
            return blocks

    def _padded_blocks(self, asm, bi, include_e_correction):
        """The camera blocks ``F^T F - Y A^T`` (or ``F^T F`` alone) of padded
        batch ``bi`` from its placed rows, (nc, t, t)
        (``ops/s_product.camera_blocks``): the rows unscaled, ``A_s =
        s_f A s_e`` and ``C_s^-1`` enters as ``s_e C_s^-1 s_e``, and the
        sums take ``s_f`` on both sides; under a mesh the rank's sums, then
        one ``all_reduce``."""
        sinfo = self.sorted_info[bi]
        placed = self._placed(asm, bi)
        t = self.batch_info[bi]["ret_slots"][0][3]
        _, s_f, s_e = self._cam_conj(asm, bi)
        cinv, s_e = (asm["cinv"], s_e) if include_e_correction else (None, None)
        red = camera_blocks(placed, sinfo["f_first"], sinfo["pidx_pad"], sinfo["cam_rows"], t,
                            cinv, s_e)
        return self.ev.all_reduce(red) * s_f[:, :, None] * s_f[:, None, :]

    def _ftf_diag(self, asm):
        """diag(F^T F) over the retained coordinates, every batch; a padded
        batch on its placed rows (``s_f^2 diag(F^T F)``, the rows
        unscaled)."""
        accs = {}
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            if bi in self.sorted_info:
                gi, Fs, _, _ = self._cam_fe(asm, bi)
                s_f = self._cam_conj(asm, bi)[1]
                red = self._cam_reduce(bi, torch.sum(Fs * Fs, dim=1)) * s_f * s_f
                accs[gi] = red if gi not in accs else accs[gi] + red
                continue
            for slot, gi, c, t in self.batch_info[bi]["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                red = self.ev.slot_reduce(bi, slot, torch.sum(Fs * Fs, dim=1))
                accs[gi] = red if gi not in accs else accs[gi] + red
        return self._ret_assemble(accs, asm["d_f"])

    def _s_matvec(self, asm, v):
        """The implicit Schur-complement product ``S v``
        (:func:`implicit_s_product`, looked up here as a module global so
        that a wrapper of the module's name sees every product)."""
        return implicit_s_product(self, asm, v)

    def _s_matmat(self, asm, v):
        """``S V`` for a retained block ``V (N_f, k)``: the product of
        ``_s_matvec`` on k columns in one pass over the rows (per slot one
        gather of (B, t, k), batched row products and one segment sum). A
        padded batch takes its scaled rows in row order here: the same
        values as its placed rows give."""
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
        with span("skeres.schur.s_build"):
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

        with span("skeres.schur.back_substitute"):
            dx_e = self._back_substitute(asm, dx_f)
            dx = torch.empty_like(g)
            self._scatter_f(dx, dx_f)
            dx[self.elim_offset : self.elim_offset + self.elim_span] = dx_e.reshape(-1)
        return dx, iters, jitter_used

    def _solve_dense(self, asm, rhs, jitter0):
        """DENSE_SCHUR: factor the equilibrated S; (dx_f, iterations,
        jitter_used)."""
        s = self._dense_s(asm)
        with span("skeres.schur.factor"):
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
        with span("skeres.schur.pcg"):
            kind = self.preconditioner_used
            if self.use_explicit:
                # reference: use_explicit_schur_complement: S once a solve, and
                # every PCG step one dense matrix-vector product
                with span("skeres.schur.s_build"):
                    s_explicit = self._dense_s_explicit(asm)
                s_matvec = lambda v: s_explicit @ v  # noqa: E731
            else:
                s_matvec = lambda v: self._s_matvec(asm, v)  # noqa: E731

            if self.use_explicit and kind == P.SCHUR_JACOBI and len(self.ret_blocks) == 1:
                # the block diagonal read off the explicit S
                precond = self._block_inverse_apply([self._diag_blocks_of(s_explicit)])
            elif self.cluster_layout is not None and kind in (P.CLUSTER_JACOBI,
                                                              P.CLUSTER_TRIDIAGONAL):
                # visibility clusters: the module entries, looked up by name
                factors = cluster_preconditioner(self, asm)
                precond = lambda v: apply_cluster_preconditioner(self, factors, v)  # noqa: E731
            elif kind == P.CLUSTER_JACOBI:
                precond = self._cluster_jacobi_precond(asm)
            elif kind == P.CLUSTER_TRIDIAGONAL:
                precond = self._cluster_tridiag_precond(asm)
            elif kind == P.SCHUR_JACOBI:
                precond = self._block_inverse_apply(self._schur_jacobi_blocks(asm))
            elif kind == P.POWER_SERIES_EXPANSION:
                precond = self._power_series_precond(asm, s_matvec)
            else:  # JACOBI and IDENTITY: diagonal scaling
                d_f = torch.clamp(asm["d_f"] + self._ftf_diag(asm),
                                  min=torch.finfo(rhs.dtype).tiny)
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
        return self._robust_linv_rung0(mats, dmax)[0]

    def _robust_linv_rung0(self, mats, dmax, ladder=True):
        """``_robust_linv``, and whether rung 0 passed for each matrix
        (...,) bool; without ``ladder``, rung 0 alone (what the ladder
        gives wherever rung 0 passes)."""
        boost0 = max(self.cluster_boost, 1e-5)
        tol = 1e-3
        eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)

        def factor_ok(chol, m):
            finite = torch.isfinite(chol).all(dim=(-2, -1))
            rn = torch.sqrt(torch.sum((chol @ chol.transpose(-1, -2) - m) ** 2, dim=(-2, -1)))
            mn = torch.sqrt(torch.sum(m * m, dim=(-2, -1)))
            return finite & (rn <= tol * mn + torch.finfo(m.dtype).tiny)

        chol = cholesky_nan(mats)
        ok = ok0 = factor_ok(chol, mats)
        for eps_rel in (boost0, 1e-1) if ladder else ():
            m_b = mats + (eps_rel * dmax)[..., None] * eye
            chol_b = cholesky_nan(m_b)
            ok_b = factor_ok(chol_b, m_b)
            chol = torch.where((~ok & ok_b)[..., None, None], chol_b, chol)
            ok = ok | ok_b
        if ladder:
            chol = torch.where(ok[..., None, None], chol, chol_b)
        chol = torch.where(torch.isfinite(chol), chol, 0.0)
        return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False), ok0

    def _to_cluster_slots(self, v):
        """Camera blocks of a retained vector -> (ncl, cs*f) cluster rows
        (zero in padded slots)."""
        plan = self.cluster_plan
        vb = torch.cat([v.reshape(-1, plan.f), v.new_zeros((1, plan.f))])
        return vb[self._cluster_slot_cam].reshape(plan.n_clusters, -1)

    def _from_cluster_slots(self, x):
        return x.reshape(-1, self.cluster_plan.f)[self._cluster_pos_of_cam].reshape(-1)

    def _cluster_jacobi_precond(self, asm):
        """CLUSTER_JACOBI on contiguous index clusters
        (``visibility_clustering`` unset): the block diagonal of S by
        camera cluster, factored once a damped solve (a batched Cholesky
        and one batched triangular solve against the identity); each PCG
        step applies ``L^-T L^-1`` as two batched matrix-vector products."""
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
        The clusters here are contiguous ranges of camera indices, one
        chain in index order: ``visibility_clustering_type`` unset (set,
        the clusters and the chains of the forest come from visibility,
        and :func:`cluster_preconditioner` builds the preconditioner)."""
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
        """v^T (J^T J) v = ||J v||^2 in one forward pass over the rows; a
        padded batch of a ``prepare()`` dict on its placed rows, the camera
        vector broadcast and the point vector gathered
        (``J_s y = F (s_f y_f) + E (s_e y_e)``, the rows unscaled)."""
        prep = data if isinstance(data, dict) else None
        pairs = [(r, jac) for (r, jac, _) in data["per_batch"]] if prep is not None else data
        total = torch.zeros((), dtype=v.dtype, device=v.device)
        for bi, (r, jac) in enumerate(pairs):
            if prep is not None and bi in prep.get("cam", {}):
                gi, F, E, pidx = self._cam_fe(prep, bi)
                s_ret, _, s_e = self._cam_conj(prep, bi)
                v_f, v_e = self._gather_f(v) * s_ret, self._gather_ge(v) * s_e
                jv = self._cam_bcast(bi, F, self._ret_view(v_f, gi)) + rows_apply(E, v_e[pidx])
            else:
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


def implicit_s_product(solver, asm, v):
    """The implicit Schur-complement product
    ``S v = (F^T F + D_f) v - W C^-1 W^T v`` of ``solver`` (a
    :class:`SchurSolver`) on its per-mu state ``asm`` (``_assemble``),
    over every batch and every retained slot: per row ``F^T (F v - E wc)`` with
    ``wc = C^-1 W^T v`` gathered by point, summed by retained block
    (reference: ``implicit_schur_complement.cc``
    RightMultiplyAndAccumulate).

    A padded batch takes the kernel pair of ``ops/s_product.py`` (their
    plain versions on the CPU): the point pass over its scaled rows in row
    order, and the same per-row ``F^T (F v - E wc)`` on its placed rows in
    the camera pass, v read by camera. The placed rows leave out the scale
    ``prepare`` records (``cam_scale``), so with the scaled rows
    ``F_s = F s_f`` and ``E_s = E s_e`` (the Jacobi scale is diagonal)

        F_s^T (F_s v - E_s wc) = s_f (F^T (F (s_f v) - E (s_e wc))):

    v goes in scaled by s_f and wc by s_e, the camera sums come out scaled
    by s_f. The JAX package's padded branch
    (``skeres_tpu/core/schur.py:1268-1292``) leaves out this conjugation, so
    on that path its PCG multiplies by the S of the unscaled Jacobian.
    Where the padded batch is the one observation batch, the point pass
    applies ``C^-1`` and ``s_e`` itself. Under a mesh each pass gives the
    rank's table, then one ``all_reduce``.

    One ``skeres.schur.s_product`` span a call (inside
    ``skeres.schur.pcg``)."""
    with span("skeres.schur.s_product"):
        ev = solver.ev
        wc, wc_of = None, {}  # C^-1 W^T v, and the wc each padded batch reads
        if solver._one_padded:
            bi = solver.e_batch
            wcp = solver._point_pass(asm, bi, v, asm["cinv"], solver._cam_conj(asm, bi)[2])
            wc_of[bi] = wcp if ev.mesh is None else ev.all_reduce(wcp.contiguous())
        else:
            wtv = v.new_zeros((solver.num_points, solver.e_size))
            for bi in solver.e_batches:
                if bi in solver.sorted_info:
                    wtv = wtv + ev.all_reduce(solver._point_pass(asm, bi, v).contiguous())
                else:
                    E = asm["per_batch"][bi][2]
                    wtv = wtv + ev.slot_reduce(bi, solver.batch_info[bi]["e_slot"],
                                               rows_apply_t(E, solver._f_rows(asm, bi, v)))
            wc = torch.einsum("pef,pf->pe", asm["cinv"], wtv)
            for bi in solver.sorted_info:
                wc_of[bi] = wc * solver._cam_conj(asm, bi)[2]
        accs = {}
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = solver.batch_info[bi]
            if not info["ret_slots"]:
                continue
            if bi in solver.sorted_info:
                gi = info["ret_slots"][0][1]
                red = ev.all_reduce(solver._camera_pass(asm, bi, v, wc_of[bi]))
                accs[gi] = red if gi not in accs else accs[gi] + red
                continue
            Fv = solver._f_rows(asm, bi, v)
            if E is not None:  # an observation batch off the layout: wc is set
                Fv = Fv - rows_apply(E, wc[info["pidx"]])
            for slot, gi, c, t in info["ret_slots"]:
                red = solver.ev.slot_reduce(bi, slot, rows_apply_t(jac[:, :, c : c + t], Fv))
                accs[gi] = red if gi not in accs else accs[gi] + red
        return asm["d_f"] * v + solver._ret_assemble(accs, v)


def cluster_preconditioner(solver, asm):
    """Build and factor the cluster preconditioner of ``solver`` (a
    :class:`SchurSolver` with visibility clusters, ``cluster_layout``) on
    its per-mu state ``asm``, once a damped solve (reference:
    ``visibility_based_preconditioner.cc``). Returns the factors that
    :func:`apply_cluster_preconditioner` applies.

    The cluster blocks of S and the band blocks between the adjacent
    clusters of each chain come from the pair plan: K3 over the point grid,
    the pairs of other clusters and across chains dropped, then the camera
    blocks of S (``_schur_jacobi_blocks``) and the damping on the slots'
    diagonal, the identity on a padded slot. One batch a slot size. The
    factor is block LDL^T down every chain at once, one position along the
    longest chain a step (a batch a pair of slot sizes):
    ``Dhat_head = D_head``, ``L_k = B_(k-1)^T Dhat_(k-1)^-1``,
    ``Dhat_k = D_k - L_k B_(k-1)``, each ``Dhat^-1`` by the boost ladder of
    ``_robust_linv``. With no chains (CLUSTER_JACOBI, or chains of one
    cluster) it is the inverse of the cluster blocks alone. The first pass
    factors each pivot at rung 0 alone, which is what the ladder gives
    where rung 0 passes; where a pivot fails it (the block tridiagonal part
    of S need not be positive definite), the factor is made again with the
    band halved, as Ceres does (positive definite on a degree-2 forest:
    Kushal and Agarwal, Lemma 1), and the whole ladder. That reads one flag
    on the host, and ``band_scale`` says which pass stood.

    One ``skeres.schur.cluster_factor`` span a call; counted by
    ``cluster_preconditioner.factors``."""
    with span("skeres.schur.cluster_factor"):
        lay = solver.cluster_layout
        mats, dmax, bands = _cluster_blocks(solver, asm)
        dinv, lblocks, ok = _chain_ldlt(solver, lay, mats, dmax, bands, ladder=False)
        band_scale = 1.0
        if not bool(ok):
            band_scale = 0.5 if lay.steps else 1.0
            dinv, lblocks, _ = _chain_ldlt(solver, lay, mats, dmax,
                                           [band_scale * b for b in bands], ladder=True)
        _counted.factors += 1
        return dict(dinv=dinv, l=lblocks, band_scale=band_scale)


def _cluster_blocks(solver, asm):
    """The preconditioner's blocks of S: each slot size's cluster matrices
    (n, s*f, s*f) and their largest diagonal entries (n, 1), and each
    step's band blocks (n, sa*f, sb*f), predecessor rows by current
    columns."""
    lay, plan = solver.cluster_layout, solver.cluster_plan
    f, e = plan.f, solver.e_size
    uniq = plan.correction_offdiag(asm["explicit_grid"], asm["cinv"].reshape(-1, e * e))
    db = solver._schur_jacobi_blocks(asm)[0]
    db = torch.cat([db, torch.eye(f, dtype=db.dtype, device=db.device)[None]])
    mats, dmax = {}, {}
    for s, grp in lay.groups.items():
        n = len(grp.ids)
        m = -plan.gather_blocks(uniq, grp.map_u, grp.map_l, n, s, s)
        slots = torch.arange(s, device=m.device)
        m.view(n, s, f, s, f)[:, slots, :, slots, :] += (
            db[grp.cams].view(n, s, f, f).transpose(0, 1))
        mats[s] = m
        dmax[s] = torch.clamp(torch.diagonal(m, dim1=1, dim2=2).amax(dim=1, keepdim=True),
                              min=torch.finfo(m.dtype).tiny)
    bands = [-plan.gather_blocks(uniq, st.map_u, st.map_l, len(st.cur), st.sa, st.sb)
             for st in lay.steps]
    return mats, dmax, bands


def _chain_ldlt(solver, lay, mats, dmax, bands, ladder):
    """Block LDL^T down the chains, each pivot at rung 0 alone or by the
    whole ``ladder``: (each slot size's ``Dhat^-1`` blocks, each step's
    ``L`` blocks, whether every pivot passed rung 0)."""
    ok = torch.ones((), dtype=torch.bool, device=next(iter(mats.values())).device)

    def inverse(m, dm):
        linv, ok0 = solver._robust_linv_rung0(m, dm, ladder)
        return linv.transpose(1, 2) @ linv, ok0.all()

    dinv = {s: torch.empty_like(m) for s, m in mats.items()}
    for s, rows in lay.heads.items():
        dinv[s][rows], ok0 = inverse(mats[s][rows], dmax[s][rows])
        ok = ok & ok0
    lblocks = []
    for st, band in zip(lay.steps, bands):
        l_k = band.transpose(1, 2) @ dinv[st.sa][st.prev]
        dh = mats[st.sb][st.cur] - l_k @ band
        dinv[st.sb][st.cur], ok0 = inverse(0.5 * (dh + dh.transpose(1, 2)), dmax[st.sb][st.cur])
        ok = ok & ok0
        lblocks.append(l_k)
    return dinv, lblocks, ok


def apply_cluster_preconditioner(solver, factors, v):
    """Apply the factors of :func:`cluster_preconditioner` to the retained
    vector ``v``, once a PCG iteration: the camera blocks into the slot
    vector, the forward sweep ``z_k = v_k - L_k z_(k-1)``, ``w = Dhat^-1
    z``, the backward sweep ``x_(k-1) = w_(k-1) - L_k^T x_k``, and back to
    camera order. A sweep is one batched product a step (a position along
    the longest chain, a pair of slot sizes), with no host read.

    One ``skeres.schur.cluster_apply`` span a call; counted by
    ``cluster_preconditioner.applies``."""
    with span("skeres.schur.cluster_apply"):
        lay = solver.cluster_layout
        f = lay.f
        z = torch.cat([v.view(-1, f), v.new_zeros((1, f))])[lay.slot_cam].reshape(-1)
        for st, l_k in zip(lay.steps, factors["l"]):
            z.index_add_(0, st.rows_cur.reshape(-1),
                         torch.bmm(l_k, z[st.rows_prev].unsqueeze(2)).reshape(-1), alpha=-1)
        w = torch.empty_like(z)
        for s, grp in lay.groups.items():
            w[grp.rows] = torch.bmm(factors["dinv"][s], z[grp.rows].unsqueeze(2)).squeeze(2)
        for st, l_k in zip(reversed(lay.steps), reversed(factors["l"])):
            w.index_add_(0, st.rows_prev.reshape(-1),
                         torch.bmm(l_k.transpose(1, 2), w[st.rows_cur].unsqueeze(2)).reshape(-1),
                         alpha=-1)
        _counted.applies += 1
        return w.view(-1, f)[lay.slot_of_cam].reshape(-1)


def dense_cluster_solve(solver, asm, v, band_scale=1.0):
    """The plain version of :func:`cluster_preconditioner` and
    :func:`apply_cluster_preconditioner`: the same cluster and band blocks
    (the band times ``band_scale``), each chain's block tridiagonal matrix
    dense, solved by ``torch.linalg.solve``; for the checks of the two."""
    lay = solver.cluster_layout
    f = lay.f
    mats, _, bands = _cluster_blocks(solver, asm)
    vs = torch.cat([v.view(-1, f), v.new_zeros((1, f))])[lay.slot_cam].reshape(-1)
    out = torch.empty_like(vs)
    rows, block, band = {}, {}, {}
    for s, grp in lay.groups.items():
        for k, c in enumerate(grp.ids.tolist()):
            rows[c], block[c] = grp.rows[k], mats[s][k]
    for st, b in zip(lay.steps, bands):
        for k, c in enumerate(lay.groups[st.sb].ids[st.cur].tolist()):
            band[c] = band_scale * b[k]  # (c - 1 rows, c columns)
    for chain in lay.clusters.chains:
        idx = torch.cat([rows[c] for c in chain])
        m = v.new_zeros((len(idx), len(idx)))
        at = 0
        for i, c in enumerate(chain):
            w = len(rows[c])
            m[at : at + w, at : at + w] = block[c]
            if i:
                wp = len(rows[chain[i - 1]])
                m[at - wp : at, at : at + w] = band[c]
                m[at : at + w, at - wp : at] = band[c].T
            at += w
        out[idx] = torch.linalg.solve(m, vs[idx])
    return out.view(-1, f)[lay.slot_of_cam].reshape(-1)


# the counters live on the function itself, whatever wraps the module's name
_counted = cluster_preconditioner
cluster_preconditioner.factors = 0
cluster_preconditioner.applies = 0
