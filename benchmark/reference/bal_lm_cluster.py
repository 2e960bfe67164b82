"""The plain reference of ``reference/bal_lm_blocked.py`` with the
visibility-based preconditioners of ITERATIVE_SCHUR: CLUSTER_JACOBI and
CLUSTER_TRIDIAGONAL (Kushal and Agarwal, CVPR 2012; Ceres
``visibility_based_preconditioner.cc``), in plain torch, float64, with
nothing of the program under test.

The cameras' clusters and chains come from ``reference/visibility.py``
under the cell's ``visibility_clustering_type`` (unset: contiguous ranges
of ``cluster_jacobi_size`` camera indices, one chain in index order). The
preconditioner is S kept where two cameras lie in one cluster, or in two
clusters next to each other on one chain (CLUSTER_TRIDIAGONAL), and zero
elsewhere: one dense matrix a chain, cameras in cluster order, each block
straight from S's definition,

    S_ij = delta_ij (F_i^T F_i + D_i) - sum_p A_ip C_p^-1 A_jp^T,

``A_ip = F_ip^T E_p`` over the points p that cameras i and j both see,
summed a block of points at a time. Each chain's matrix is factored by
``torch.linalg.cholesky_ex`` once a damped solve and applied by
``torch.cholesky_solve`` in every PCG iteration (the Q-test's PCG of
``BalLM``). Where any chain's matrix is not positive definite, every
matrix is made again with its blocks between clusters halved, which is
positive definite on chains (Kushal and Agarwal, Lemma 1), as Ceres does.

SCHUR_JACOBI is ``BalLMBlocked``'s.
"""

from __future__ import annotations

import torch

from benchmark.reference.bal_lm import POINTS_PER_CHUNK
from benchmark.reference.bal_lm_blocked import BalLMBlocked
from benchmark.reference.visibility import clusters_and_chains, index_range_clusters

__all__ = ["BalLMCluster"]

CLUSTER_KINDS = ("CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL")


class BalLMCluster(BalLMBlocked):
    """``BalLMBlocked`` with the cluster preconditioners."""

    _layout = None

    def chain_layout(self, opts: dict):
        """(each camera's cluster, the chains as lists of clusters), once."""
        if self._layout is None:
            band = opts["preconditioner_type"] == "CLUSTER_TRIDIAGONAL"
            kind = opts.get("visibility_clustering_type")
            if kind is None:
                cluster, chains = index_range_clusters(self.nc, opts.get("cluster_jacobi_size", 64),
                                                       band)
            else:
                cluster, chains = clusters_and_chains(self.ci, self.pi, self.nc, kind, band)
            self._layout = (cluster, chains)
        return self._layout

    def _chain_matrices(self, lin, cinv, u_d, opts):
        """Per chain: its cameras (in cluster order) and its dense matrix,
        and the block-diagonal part of it (the blocks inside one cluster)."""
        cluster, chains = self.chain_layout(opts)
        dev = self.device
        cluster_t = torch.as_tensor(cluster, device=dev)
        # each camera's chain and place in it, cameras of a cluster by index
        chain_of_cluster = torch.empty(int(cluster.max()) + 1, dtype=torch.long, device=dev)
        pos_of_cluster = torch.empty_like(chain_of_cluster)
        for k, chain in enumerate(chains):
            chain_of_cluster[chain] = k
            pos_of_cluster[chain] = torch.arange(len(chain), device=dev)
        cam_chain = chain_of_cluster[cluster_t]
        order = torch.argsort(cam_chain * (int(cluster.max()) + 1) * self.nc
                              + pos_of_cluster[cluster_t] * self.nc
                              + torch.arange(self.nc, device=dev))
        sizes = torch.bincount(cam_chain, minlength=len(chains))
        first = torch.cumsum(sizes, 0) - sizes
        place = torch.empty(self.nc, dtype=torch.long, device=dev)
        place[order] = torch.arange(self.nc, device=dev) - first[cam_chain[order]]
        base = torch.cumsum(sizes * sizes, 0) - sizes * sizes  # a chain's first block
        flat = torch.zeros((int((sizes * sizes).sum()), 9, 9), dtype=self.dtype, device=dev)

        def position(ca, cb):
            return base[cam_chain[ca]] + place[ca] * sizes[cam_chain[ca]] + place[cb]

        cams = torch.arange(self.nc, device=dev)
        flat[position(cams, cams)] += u_d
        a, rows = lin["a"], self.point_rows
        pad = self.num_rows
        for p0 in range(0, self.npt, POINTS_PER_CHUNK):
            grid = rows[p0 : p0 + POINTS_PER_CHUNK]
            cinv_chunk = cinv[p0 : p0 + POINTS_PER_CHUNK]
            for ka in range(grid.shape[1]):
                for kb in range(grid.shape[1]):
                    ok = (grid[:, ka] < pad) & (grid[:, kb] < pad)
                    ra, rb = grid[:, ka], grid[:, kb]
                    ca, cb = self.ci[ra.clamp(max=pad - 1)], self.ci[rb.clamp(max=pad - 1)]
                    la, lb = cluster_t[ca], cluster_t[cb]
                    keep = ok & (cam_chain[ca] == cam_chain[cb]) & (
                        (pos_of_cluster[la] - pos_of_cluster[lb]).abs() <= 1)
                    sel = torch.nonzero(keep)[:, 0]
                    ra, rb, ca, cb = ra[sel], rb[sel], ca[sel], cb[sel]
                    t = torch.bmm(torch.bmm(a[ra], cinv_chunk[sel]), a[rb].transpose(1, 2))
                    flat.index_add_(0, position(ca, cb), -t)
        out = []
        for k in range(len(chains)):
            n = int(sizes[k])
            blocks = flat[int(base[k]) : int(base[k]) + n * n].view(n, n, 9, 9)
            cam_cl = cluster_t[order[int(first[k]) : int(first[k]) + n]]
            inside = (cam_cl[:, None] == cam_cl[None, :])[:, :, None, None]
            m = blocks.permute(0, 2, 1, 3).reshape(9 * n, 9 * n)
            d = torch.where(inside, blocks, 0.0).permute(0, 2, 1, 3).reshape(9 * n, 9 * n)
            out.append((order[int(first[k]) : int(first[k]) + n], m, d))
        return out

    def _cluster_precond(self, lin, cinv, u_d, opts):
        """v -> the preconditioner's solve, chain by chain."""
        mats = self._chain_matrices(lin, cinv, u_d, opts)
        factors = [torch.linalg.cholesky_ex(m) for _, m, _ in mats]
        if any(int(info) != 0 for _, info in factors):
            factors = [torch.linalg.cholesky_ex(d + 0.5 * (m - d)) for _, m, d in mats]
        if any(int(info) != 0 for _, info in factors):
            raise ValueError("the cluster preconditioner is not positive definite")

        def precond(v):
            v = v.view(self.nc, 9)
            out = torch.empty_like(v)
            for (cams, _, _), (chol, _) in zip(mats, factors):
                out[cams] = torch.cholesky_solve(v[cams].reshape(-1, 1), chol).view(-1, 9)
            return out.reshape(-1)

        return precond

    def damped_step(self, lin, mu: float, opts: dict):
        """The damped step by PCG with the cell's preconditioner:
        (y_c (nc, 9), y_p (npt, 3), linear solver iterations)."""
        if opts["preconditioner_type"] not in CLUSTER_KINDS:
            return super().damped_step(lin, mu, opts)
        if opts["linear_solver_type"] != "ITERATIVE_SCHUR":
            raise ValueError(f"the cluster reference solves ITERATIVE_SCHUR, not "
                             f"{opts['linear_solver_type']}")
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
        precond = self._cluster_precond(lin, cinv, u_d, opts)

        def matvec(v):
            v = v.view(nc, 9)
            w = self._by_point(lambda k: torch.einsum("bji,bj->bi", a[k], v[ci[k]]))
            wc = torch.einsum("pij,pj->pi", cinv, w)
            out = torch.einsum("cij,cj->ci", u_d, v) - self._by_camera(
                lambda k: torch.einsum("bij,bj->bi", a[k], wc[pi[k]]))
            return out.reshape(-1)

        y, iterations = self._pcg(matvec, rhs.reshape(-1), precond,
                                  opts["max_linear_solver_iterations"], opts["eta"])
        y_c = y.view(nc, 9)
        y_p = torch.einsum("pij,pj->pi", cinv, b_p - self._by_point(
            lambda k: torch.einsum("bji,bj->bi", a[k], y_c[ci[k]])))
        return y_c, y_p, iterations
