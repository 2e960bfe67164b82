"""Covariance estimation of the solution.

PyTorch counterpart of ``skeres_tpu/core/covariance.py`` (reference
lineage: ``include/ceres/covariance.h``, ``internal/ceres/covariance_impl.cc``):
the tangent-space covariance is the Moore-Penrose pseudo-inverse of J^T J
with the reference's rank rules (``null_space_rank``,
``min_reciprocal_condition_number``), lifted to ambient coordinates through
the manifolds' plus-Jacobians as the reference's ``GetCovarianceBlock``.

  - DENSE_SVD: the pseudo-inverse of the full (free) J^T J.
  - SCHUR_COMPLEMENT: the block inverse through the reduced camera system
    S (``core/schur.py``, undamped: K3 builds it on the explicit path,
    the column probe on the general structure, as ``skeres_tpu``'s
    ``_dense_s``); the full J^T J is never formed.

The pseudo-inverse: the JAX package calls ``np.linalg.svd(a,
hermitian=True)`` on the host, which gives s = |eigenvalues| in
descending order with the eigenvectors as u. Here ``torch.linalg.eigh``
runs in float64 on the evaluator's device and its output is reordered the
same way; a library call, as in the JAX package. Everything stays on the
device: the per-point C_p guard takes every point's eigenvalues at once
(``_batched_eigvalsh``), and a point query selects that point's Jacobian
rows there (the JAX form copies every
Jacobian block to the host and scans them per query). Queries return
float64 numpy arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.minimizer import synchronize
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.types import CovarianceAlgorithmType

__all__ = ["Covariance", "CovarianceOptions"]


def _batched_eigvalsh(a, sweeps: int = 8):
    """The eigenvalues (..., n), ascending, of a batch of small symmetric
    matrices (..., n, n) by cyclic Jacobi rotations, in torch ops: one
    rotation a pair (p, q), ``sweeps`` times over all pairs (the
    convergence is quadratic; at n = 3 the eigenvalues agree with LAPACK's
    to 2.4e-15 of the largest). cuSOLVER's batched eigensolver, which
    ``torch.linalg.eigvalsh`` calls on the card, refused the covariance's
    batches (CUSOLVER_STATUS_INVALID_VALUE from its workspace query for
    65,536 and for 1,000,000 3 x 3 matrices; torch 2.11, CUDA 12.8)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a)
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = a[..., p, q]
                nz = apq != 0
                theta = (a[..., q, q] - a[..., p, p]) / (
                    2.0 * torch.where(nz, apq, torch.ones_like(apq)))
                t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
                t = torch.where(theta == 0, torch.ones_like(t), t)
                t = torch.where(nz, t, torch.zeros_like(t))
                c = 1.0 / torch.sqrt(t * t + 1.0)
                rot = eye.clone()
                rot[..., p, p] = c
                rot[..., q, q] = c
                rot[..., p, q] = t * c
                rot[..., q, p] = -t * c
                a = rot.transpose(-1, -2) @ a @ rot
    return torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1).values


@dataclasses.dataclass
class CovarianceOptions:
    """Reference: ``Covariance::Options`` (the dense-SVD fields and the
    algorithm: SCHUR_COMPLEMENT takes the place of the reference's
    SPARSE_QR on BA structure), plus the port's ``device`` (the card unless
    the caller asks for the CPU), ``dtype`` of the evaluation and the S
    assembly, and ``evaluation_chunk_size`` (rows per evaluation chunk, as
    ``SolverOptions``)."""

    algorithm_type: CovarianceAlgorithmType = CovarianceAlgorithmType.DENSE_SVD
    min_reciprocal_condition_number: float = 1e-14
    # >= 0: treat exactly this many trailing singular values as null space;
    # -1: find the rank by the condition-number test
    null_space_rank: int = 0
    apply_loss_function: bool = True
    device: Any = "cuda"
    dtype: torch.dtype = torch.float64
    evaluation_chunk_size: Optional[int] = None


class Covariance:
    """Compute and query covariance blocks of a solved problem.

    After ``compute()``: ``rank`` is the number of singular values kept,
    ``smallest_kept`` the least of them, and ``seconds`` the wall seconds
    of its parts (``evaluate``, ``assemble``, ``eigh``, and ``pinv``: the
    ``eigh`` and the product; the device synchronized before each reading)."""

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._program = None
        self._rank: Optional[int] = None
        self.smallest_kept: Optional[float] = None
        self.seconds: dict = {}
        # DENSE_SVD: the pseudo-inverse over the free coordinates and each
        # tangent coordinate's index among them (-1: constant)
        self._cov_free = None
        self._free_index = None
        # SCHUR_COMPLEMENT
        self._schur = None
        self._s_inv = None  # (N_f, N_f), zero on the constant cameras
        self._cinv = None  # (P, e, e)
        self._blocks = None  # the evaluator's corrected blocks, on the device

    def _evaluate(self, problem, program):
        o = self.options
        device = torch.device(o.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"CovarianceOptions.device is {o.device!r} but no CUDA device is "
                "available; pass device='cpu' to compute on the CPU"
            )
        program = program or problem.compile()
        ev = Evaluator(program, device=device, dtype=o.dtype, chunk_size=o.evaluation_chunk_size,
                       apply_loss_function=o.apply_loss_function)
        t0 = time.time()
        _, blocks = ev.blocks(program.initial_state(device, o.dtype))
        synchronize(device)
        self.seconds = {"evaluate": time.time() - t0}
        return program, ev, blocks

    def compute(self, problem, program=None) -> bool:
        """The covariance of the solution (the problem's current values).
        Returns False when the system is rank-deficient beyond what the
        options allow (the reference's Compute returns false then)."""
        if self.options.algorithm_type == CovarianceAlgorithmType.SCHUR_COMPLEMENT:
            return self._compute_schur(problem, program)
        return self._compute_dense_svd(problem, program)

    def _compute_dense_svd(self, problem, program=None) -> bool:
        program, ev, blocks = self._evaluate(problem, program)
        t0 = time.time()
        free = torch.as_tensor(np.nonzero(program.free_mask > 0.0)[0], device=ev.device)
        jtj = ev.jtj_dense(blocks).to(torch.float64)
        del blocks
        jtj_f = jtj[free][:, free]
        del jtj
        synchronize(ev.device)
        self.seconds["assemble"] = time.time() - t0
        cov_f = self._pinv_spd(jtj_f)
        if cov_f is None:
            return False
        index = torch.full((program.num_tangent,), -1, dtype=torch.int64, device=ev.device)
        index[free] = torch.arange(free.numel(), device=ev.device)
        self._cov_free, self._free_index = cov_f, index
        self._program = program
        return True

    def _pinv_spd(self, a):
        """The pseudo-inverse of symmetric ``a`` (float64, on its device)
        with the reference's rank rules; sets ``rank`` and ``smallest_kept``.
        Returns None on a rank deficiency the options do not allow."""
        t0 = time.time()
        if a.numel() == 0:
            return None
        w, u = torch.linalg.eigh(a)
        synchronize(a.device)
        self.seconds["eigh"] = time.time() - t0
        # numpy's svd(hermitian=True): s = |eigenvalues|, descending
        s, order = torch.sort(w.abs(), descending=True, stable=True)
        u = u[:, order]
        o = self.options
        thresh = o.min_reciprocal_condition_number * s[0]
        if o.null_space_rank < 0:
            keep = s > thresh
        else:
            cutoff = len(s) - o.null_space_rank
            keep = torch.arange(len(s), device=s.device) < cutoff
            # with the automatic detection off, a kept singular value below
            # the threshold is a rank deficiency
            bad = s[:cutoff] <= thresh
            n_bad, n_good = torch.stack([bad.sum(), (~bad).sum()]).tolist()
            if n_bad:
                self._rank = int(n_good)
                return None
        inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), 0.0)
        rank, smallest = torch.stack([
            keep.sum().to(s.dtype),
            torch.where(keep, s, torch.full_like(s, float("inf"))).min()]).tolist()
        self._rank, self.smallest_kept = int(rank), smallest
        out = (u * inv_s[None, :]) @ u.T
        synchronize(a.device)
        self.seconds["pinv"] = time.time() - t0
        return out

    # -- SCHUR_COMPLEMENT -------------------------------------------------------

    def _compute_schur(self, problem, program=None) -> bool:
        """With H = [[B, W], [W^T, C]] (B the camera block of J^T J, C the
        point block, W the cross term) and S = B - W C^-1 W^T:

            H^-1_ff = S^-1                              (camera-camera)
            H^-1_fe = -S^-1 W C^-1                      (camera-point)
            H^-1_ee = C^-1 + (W C^-1)^T S^-1 (W C^-1)   (point-point)

        Only S (N_f x N_f) is dense; a point query rebuilds that point's
        W_p from its Jacobian rows."""
        program, ev, blocks = self._evaluate(problem, program)
        t0 = time.time()
        schur = SchurSolver(ev, iterative=False)
        n = program.num_tangent
        zeros = torch.zeros(n, dtype=ev.dtype, device=ev.device)
        prep = schur.prepare(schur.solver_data(blocks))
        asm = schur._assemble(prep, zeros, zeros)  # undamped: J^T J itself
        s_mat = schur._dense_s(asm).to(torch.float64)
        cinv, ete = asm["cinv"], prep["ete0"]
        del prep, asm
        # rank-deficiency guard (reference: Compute returns false): a
        # singular C_p (a point seen too few times, or degenerate geometry)
        # makes its closed-form inverse non-finite or huge-but-finite; test
        # the undamped E^T E's eigenvalues per point, with a threshold no
        # tighter than the working dtype's resolution
        eigs = _batched_eigvalsh(ete.to(torch.float64))  # (P, e) ascending
        rcond = max(self.options.min_reciprocal_condition_number,
                    100.0 * torch.finfo(cinv.dtype).eps)
        bad = ~(torch.isfinite(s_mat).all() & torch.isfinite(cinv).all())
        bad = bad | (eigs[:, 0] <= rcond * torch.clamp(eigs[:, -1], min=0.0)).any()
        synchronize(ev.device)
        self.seconds["assemble"] = time.time() - t0
        if bool(bad):
            return False

        # the free retained coordinates (a constant camera's rows of S are
        # zero)
        free_f = torch.as_tensor(np.nonzero(program.free_mask[schur.ret_index] > 0.0)[0],
                                 device=ev.device)
        s_inv_free = self._pinv_spd(s_mat[free_f][:, free_f])
        if s_inv_free is None:
            return False
        s_inv = torch.zeros_like(s_mat)
        s_inv.index_copy_(0, free_f, torch.zeros(
            (free_f.numel(), s_mat.shape[1]), dtype=s_mat.dtype, device=s_mat.device,
        ).index_copy_(1, free_f, s_inv_free))
        self._s_inv = s_inv
        self._cinv = cinv.to(torch.float64)
        self._schur = schur
        self._blocks = blocks
        self._program = program
        self._cov_free = None
        return True

    def _point_u(self, p: int):
        """U_p = W_p C_p^-1 (N_f, e) for point p, from its Jacobian rows in
        every observation batch and each retained slot (selected on the
        device)."""
        schur = self._schur
        u = torch.zeros((schur.num_f, schur.e_size), dtype=torch.float64,
                        device=self._cinv.device)
        for bi in schur.e_batches:
            info = schur.batch_info[bi]
            idx = schur.ev._batch_const[bi][1]
            rows = torch.nonzero(info["pidx"] == p).reshape(-1)
            jac = self._blocks[bi].jac[rows].to(torch.float64)
            ec = info["e_col"]
            E = jac[:, :, ec : ec + schur.e_size]  # (r, m, e)
            for s, gi, c, t in info["ret_slots"]:
                w = torch.einsum("rmt,rme->rte", jac[:, :, c : c + t], E)
                schur._ret_view(u, gi).index_add_(0, idx[s][rows], w)
        return u @ self._cinv[p]

    # -- queries ---------------------------------------------------------------

    def _tangent_span(self, block) -> Tuple[int, int]:
        program = self._program
        g = program.groups[block.group_index]
        return program.tangent_offset[block.group_index] + block.row * g.tangent_size, g.tangent_size

    def get_covariance_block_in_tangent_space(self, b1, b2) -> np.ndarray:
        if self._s_inv is not None:
            out = self._schur_block(b1, b2)
        else:
            if self._cov_free is None:
                raise RuntimeError("call compute() first")
            (o1, t1), (o2, t2) = self._tangent_span(b1), self._tangent_span(b2)
            r, c = self._free_index[o1 : o1 + t1], self._free_index[o2 : o2 + t2]
            out = self._cov_free[r.clamp(min=0)][:, c.clamp(min=0)]
            out = out * ((r >= 0)[:, None] & (c >= 0)[None, :])
        return out.detach().to("cpu").numpy().copy()

    def _ret_rows(self, block):
        o, t = self._tangent_span(block)
        r = self._schur.glob2ret[o : o + t]
        if (r < 0).any():
            raise ValueError("not a block of a retained group")
        return torch.as_tensor(r, device=self._s_inv.device)

    def _schur_block(self, b1, b2):
        elim = self._schur.elim_group
        p1, p2 = b1.group_index == elim, b2.group_index == elim
        if not p1 and not p2:  # camera-camera
            return self._s_inv[self._ret_rows(b1)][:, self._ret_rows(b2)]
        if not p1 and p2:  # camera-point: -S^-1 W C^-1
            return -(self._s_inv[self._ret_rows(b1)] @ self._point_u(b2.row))
        if p1 and not p2:
            return -(self._point_u(b1.row).T @ self._s_inv[:, self._ret_rows(b2)])
        # point-point: delta C^-1 + (W C^-1)^T S^-1 (W C^-1)
        u1 = self._point_u(b1.row)
        u2 = u1 if b2.row == b1.row else self._point_u(b2.row)
        out = u1.T @ self._s_inv @ u2
        if b1.row == b2.row:
            out = out + self._cinv[b1.row]
        return out

    def get_covariance_block(self, b1, b2) -> np.ndarray:
        """Ambient-space covariance J_plus(x1) C J_plus(x2)^T (reference:
        ``CovarianceImpl::GetCovarianceBlockInTangentOrAmbientSpace``)."""
        ct = self.get_covariance_block_in_tangent_space(b1, b2)
        j1, j2 = (
            self._program.groups[b.group_index].manifold.plus_jacobian(
                torch.as_tensor(np.asarray(b.value, dtype=np.float64))).numpy()
            for b in (b1, b2)
        )
        return j1 @ ct @ j2.T

    @property
    def rank(self) -> Optional[int]:
        return self._rank
