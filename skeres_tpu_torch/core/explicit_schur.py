"""Explicit Schur-complement assembly: S from per-point pair products.

PyTorch counterpart of ``skeres_tpu/core/explicit_schur.py``, single
device (reference lineage: ``schur_complement_solver.cc`` assembling S
block by block). DENSE_SCHUR builds S this way once the dense per-point W
of the dense-W path passes its gate (venice-1778: 192 GB):

  S = blockdiag(F^T F + D_f) - W C^-1 W^T

- the per-row ``A_r = F_r^T E_r`` blocks are laid on a point grid
  (P, kp) (a pure reshape when every point has kp observations in row
  order);
- the OFF-diagonal blocks are the pair products ``Y_pk A_pl^T`` (k < l)
  of every point, computed by K3 (``ops/pair_product.py``), reduced onto
  the unique camera pairs by a host-planned hierarchical sum: each level
  is one index-select, a reshape and a sum, with fan-in <= ``pair_cap``.
  It is deterministic, where an ``index_add_`` would sum in a different
  order on every run;
- dense S is then gather-built: every (ci, cj) block position reads its
  unique-pair row, its transpose, a per-camera diagonal row, or zero.

With ``cluster_of`` (a cluster id per camera) the plan is the CLUSTER_JACOBI
and CLUSTER_TRIDIAGONAL preconditioners': pairs across clusters are dropped
(with ``cluster_band``, pairs of adjacent clusters are kept), so the
unique-pair table stays small however many cameras, and
:meth:`cluster_offdiag` and :meth:`cluster_band_offdiag` gather it into
batched per-cluster matrices. K3 computes the pair products of either
plan; on a cluster plan most pairs are invalid and come out as zero rows.

All index arrays are problem structure, built once on the host.

Under a mesh (``mesh=``, the counterpart of ``_plan_sharded``,
``skeres_tpu/core/explicit_schur.py:469-606``) the observation rows are
split over the ranks by the JAX package's convention
(``parallel/mesh.py``), so the pair products are local to a rank for
every point whose rows all lie on it. Every rank plans on the host from
the whole problem, so that all take the same decisions: the points that
straddle a shard boundary (at most ``max(4 ns, 64)``, or the plan is
rejected), each shard's list of whole points, and the same two
``ValueError`` gates (too many straddlers, shard imbalance) as the JAX
package, plus its level-0 waste gate checked for every shard. At run time
a rank builds the grid of its own whole points from its rows, runs K3 and
its own hierarchical sum on it, places the local unique-pair sums into
the global unique-pair table and runs one ``all_reduce`` over it; the
straddling points' rows are collected by a zero-filled ``all_reduce``
(each rank contributes the rows it owns) into a small replicated fixup
grid, whose K3 products and sum every rank adds after the reduce.
The JAX package's ``_uniformize_shard_levels`` exists only because one SPMD
program needs the same level shapes on every shard; each rank here runs
its own levels, so it has no counterpart. Unlike the JAX package's
sharded plan, which drops them, the band pairs of a CLUSTER_TRIDIAGONAL
plan are kept on every shard and in the fixup (``_pair_metadata``'s
``cluster_band``), so the sharded band equals the single-device one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from skeres_tpu_torch.ops.pair_product import pair_products
from skeres_tpu_torch.parallel.mesh import all_reduce_sum, shard_rows

__all__ = ["ExplicitSchurPlan"]

# cameras per block row of the dense-S gather-build: bounds its transient
# (chunk * nc, f, f) gather to ~1/14 of S at venice-1778 shape
_CHUNK_CAMS = 127


class _SumLevel(NamedTuple):
    src: torch.Tensor  # (n_dest * cap,) int64 into the previous level's rows
    n_dest: int
    cap: int


def _hierarchical_sum_plan(
    ids: np.ndarray, raw_rows: np.ndarray, n_rows: int, cap: int = 32,
    adaptive: bool = False,
) -> Tuple[list, np.ndarray]:
    """Plan ``out[u] = sum(values[raw_rows][ids == uniq[u]])`` as static
    gather+reshape+sum levels with fan-in <= cap per level (numpy,
    vectorized; venice has ~10M pair rows).

    ``adaptive=True`` shrinks each level's fan-in toward the median group
    size (power of two, >= 2), bounding the padded-row waste even for
    low-fan-in (unstructured-visibility) id distributions, at the cost of
    one or two extra levels.

    Returns (levels, uniq_ids (n_uniq,)) with levels as raw
    ``(src ndarray, n_dest, cap)`` tuples. Level k's gather indexes the
    output rows of level k-1 (level 0 indexes the raw value rows); the
    sentinel index == n_rows_of_previous_level selects a zero row appended
    at run time.
    """
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    uniq, start = np.unique(sorted_ids, return_index=True)
    counts = np.diff(np.append(start, len(ids)))

    levels = []
    n_prev = n_rows
    cur_counts = counts.astype(np.int64)
    cur_rows = raw_rows[order].astype(np.int64)  # grouped by id
    max_cap = cap
    while True:
        if adaptive and len(cur_counts):
            med = max(int(np.median(cur_counts)), 2)
            cap = min(max_cap, 1 << int(np.ceil(np.log2(med))))
        n_dest = len(cur_counts)
        n_d = (cur_counts + cap - 1) // cap  # sub-rows per destination
        sub_start = np.concatenate([[0], np.cumsum(n_d)[:-1]]).astype(np.int64)
        n_sub = int(n_d.sum())
        # position of the j-th row of destination d: sub_start[d]*cap + j
        dest_of_row = np.repeat(np.arange(n_dest), cur_counts)
        starts = np.concatenate([[0], np.cumsum(cur_counts)[:-1]]).astype(np.int64)
        j_within = np.arange(len(cur_rows)) - starts[dest_of_row]
        positions = sub_start[dest_of_row] * cap + j_within
        src = np.full(n_sub * cap, n_prev, dtype=np.int64)  # sentinel
        src[positions] = cur_rows
        levels.append((src, n_sub, cap))
        if n_dest == 0 or (n_d == 1).all():
            break
        # next level reduces each destination's sub-rows
        cur_rows = np.arange(n_sub, dtype=np.int64)
        cur_counts = n_d
        n_prev = n_sub
    return levels, uniq


def _freeze_levels(levels, device) -> List[_SumLevel]:
    return [_SumLevel(torch.as_tensor(src).to(device), n_dest, cap) for src, n_dest, cap in levels]


def _apply_hierarchical_sum(levels: List[_SumLevel], values: torch.Tensor) -> torch.Tensor:
    """values: (n_rows, D) -> (n_last_dest, D) via the planned levels."""
    cur = values
    for lvl in levels:
        padded = torch.cat([cur, cur.new_zeros((1,) + cur.shape[1:])])
        cur = padded.index_select(0, lvl.src).view(lvl.n_dest, lvl.cap, -1).sum(dim=1)
    return cur


def _check_level0_waste(levels, n_rows: int, factor: float = 3.0):
    """Reject pathological (unstructured) visibility: when unique camera
    pairs have tiny fan-in (every point seeing random cameras), the
    level-0 padded-gather form inflates to n_uniq*cap rows. Real BA
    visibility is structured; structured cases sit near 1.0x here."""
    if levels:
        src, n_dest, cap = levels[0]
        # only material sizes: a few hundred KB of padding on a tiny
        # problem is irrelevant and must not reject it
        if n_dest * cap >= (1 << 20) and n_dest * cap > factor * max(n_rows, 1):
            raise ValueError(
                "unique-pair fan-in too low for the hierarchical padded "
                f"sum ({n_dest * cap} padded rows vs {n_rows} pair rows)"
            )


def _pair_metadata(grid_cam: np.ndarray, num_cameras: int, iu, ju, cluster_of=None,
                   cluster_band=False):
    """Per-point-row pair bookkeeping from a (Pn, kp) camera grid:
    (swap (Pn, npair) bool, valid (Pn, npair) bool, pair_id (Pn*npair,)
    with -1 for invalid). With ``cluster_of`` (a cluster id per camera),
    pairs whose cameras lie in different clusters are dropped, the
    CLUSTER_JACOBI restriction; ``cluster_band`` keeps the pairs of
    adjacent clusters too (the CLUSTER_TRIDIAGONAL band)."""
    npair = len(iu)
    ca = grid_cam[:, iu].reshape(-1)
    cb = grid_cam[:, ju].reshape(-1)
    pair_valid = (ca >= 0) & (cb >= 0)
    if cluster_of is not None:
        dcl = np.abs(cluster_of[np.clip(ca, 0, None)] - cluster_of[np.clip(cb, 0, None)])
        pair_valid &= dcl <= (1 if cluster_band else 0)
    swap = ca > cb
    lo = np.where(swap, cb, ca)
    hi = np.where(swap, ca, cb)
    pair_id = np.where(pair_valid, lo * num_cameras + hi, -1)
    pn = grid_cam.shape[0]
    return swap.reshape(pn, npair), pair_valid.reshape(pn, npair), pair_id


def _transpose_blocks(flat: torch.Tensor, f: int) -> torch.Tensor:
    """Transpose every flat (f*f,) f-major block row."""
    return flat.view(-1, f, f).transpose(1, 2).reshape(-1, f * f)


def _level0_rows(ids: np.ndarray, cap: int) -> int:
    """The padded rows of level 0 of a fixed-cap hierarchical sum over
    ``ids``: what ``_check_level0_waste`` reads, without the plan."""
    if len(ids) == 0:
        return 0
    _, counts = np.unique(ids, return_counts=True)
    return int(((counts + cap - 1) // cap).sum()) * cap


class ExplicitSchurPlan:
    """Static plan for explicit-S assembly of ONE observation batch with a
    single retained slot (the bundle-adjustment case), on one device, or
    with ``mesh`` over this rank's share of the rows."""

    def __init__(
        self,
        cam_idx: np.ndarray,  # (B,) camera block id per row
        pt_idx: np.ndarray,  # (B,) point block id per row
        num_cameras: int,
        num_points: int,
        f_size: int,
        e_size: int,
        pair_cap: int = 32,
        pad_waste: float = 1.5,
        chunk_value_budget: int = 1 << 26,  # bytes of pair values the plain
        # version of K3 materializes at once
        cluster_of: Optional[np.ndarray] = None,  # (nc,) cluster id per camera:
        # keep only the pairs inside a cluster (the CLUSTER_JACOBI plan)
        cluster_band: bool = False,  # keep the pairs of adjacent clusters too and
        # build the (c, c+1) band maps (CLUSTER_TRIDIAGONAL)
        *,
        device,
        mesh=None,
    ):
        B = len(cam_idx)  # the port's batches have no pad rows
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self.n_shards = 1 if self.mesh is None else mesh.size()
        self.rank = 0 if self.mesh is None else mesh.get_local_rank()
        self.nc = num_cameras
        self.np_ = num_points
        self.f = f_size
        self.e = e_size
        self.cluster_of = None if cluster_of is None else np.asarray(cluster_of, dtype=np.int64)
        self.cluster_band = bool(cluster_band)

        # -- point grid stats + skew gate ----------------------------------
        counts = np.bincount(pt_idx, minlength=num_points)
        kp = int(counts.max()) if num_points else 0
        self.kp = kp
        if num_points * kp > pad_waste * B * 2.0:
            raise ValueError("point-degree skew too high for explicit S")

        iu, ju = np.triu_indices(kp, k=1)
        self.npairs = npairs = len(iu)
        self.pair_kl = torch.as_tensor(np.stack([iu, ju]).astype(np.int32)).to(device)
        # points per chunk of K3's plain version: bound its pair-value bytes
        self.chunk_points = max(256, chunk_value_budget // max(1, npairs * f_size * f_size * 4))

        order = np.argsort(pt_idx, kind="stable")
        sorted_pt = pt_idx[order]
        starts = np.searchsorted(sorted_pt, np.arange(num_points))
        pos = np.arange(B) - starts[sorted_pt]
        grid_src = np.full(num_points * kp, B, dtype=np.int64)  # sentinel
        grid_src[sorted_pt * kp + pos] = order
        grid_cam = np.full(num_points * kp, -1, dtype=np.int64)
        gvalid = grid_src < B
        grid_cam[gvalid] = cam_idx[grid_src[gvalid]]
        grid_cam = grid_cam.reshape(num_points, kp)
        swap_g, valid_g, pair_id_g = _pair_metadata(
            grid_cam, num_cameras, iu, ju, self.cluster_of, self.cluster_band)
        uniq = np.unique(pair_id_g[pair_id_g >= 0])
        self.n_uniq = n_uniq = len(uniq)

        self.n_straddle = 0  # points whose rows straddle a shard boundary
        if self.mesh is None:
            # uniform point-sorted rows: the grid is the identity reshape of the rows
            self.grid_is_reshape = bool(
                num_points * kp == B and (counts == kp).all()
                and (grid_src == np.arange(B)).all()
            )
            self.grid_src = None if self.grid_is_reshape else torch.as_tensor(grid_src).to(device)
            self.swap_mask = torch.as_tensor(swap_g).to(device)
            self.pair_valid = torch.as_tensor(valid_g).to(device)
            rows = np.nonzero(pair_id_g >= 0)[0]
            self.n_pair_rows = len(pair_id_g)
            levels, uniq_l = _hierarchical_sum_plan(
                pair_id_g[rows], rows, self.n_pair_rows, cap=pair_cap, adaptive=True,
            )
            assert len(uniq_l) == n_uniq
            _check_level0_waste(levels, self.n_pair_rows)
            self.levels = _freeze_levels(levels, device)
        else:
            self.grid_is_reshape = False
            self._plan_sharded(B, pt_idx, grid_src.reshape(num_points, kp), swap_g, valid_g,
                               pair_id_g.reshape(num_points, npairs), uniq, pad_waste,
                               pair_cap, device)

        # -- dense-S gather map: block position (ci, cj) -> table row ------
        # SAME-CAMERA pairs (a point observed twice by one camera) store a
        # real uniq row at the diagonal position; the dense builds fold both
        # of its read directions into the per-camera diagonal region
        pos2u = np.full(num_cameras * num_cameras, n_uniq, dtype=np.int64)
        pos2u[uniq] = np.arange(n_uniq)
        lo_all = uniq // num_cameras
        hi_all = uniq % num_cameras
        pos2u_t = np.full(num_cameras * num_cameras, n_uniq, dtype=np.int64)
        pos2u_t[hi_all * num_cameras + lo_all] = np.arange(n_uniq)
        dd = np.arange(num_cameras)
        self.diag_pair_idx = torch.as_tensor(pos2u[dd * num_cameras + dd]).to(device)
        # one read per position from the combined table
        # [uniq | uniq^T | per-camera diagonal region | zero]
        comb = np.full(num_cameras * num_cameras, 2 * n_uniq + num_cameras, np.int64)
        has_up = pos2u < n_uniq
        comb[has_up] = pos2u[has_up]
        has_low = (pos2u_t < n_uniq) & ~has_up
        comb[has_low] = n_uniq + pos2u_t[has_low]
        comb[dd * num_cameras + dd] = 2 * n_uniq + dd
        self.pos2u_combined = torch.as_tensor(comb).to(device)

        # -- cluster block maps: slot (c, i, j) -> unique-pair row ----------
        if self.cluster_of is not None:
            ncl = int(self.cluster_of.max()) + 1 if num_cameras else 0
            members = [np.nonzero(self.cluster_of == c)[0] for c in range(ncl)]
            cs = max((len(m) for m in members), default=1)
            cam_of = np.full((ncl, cs), -1, dtype=np.int64)
            for c, m in enumerate(members):
                cam_of[c, : len(m)] = m
            self.n_clusters = ncl
            self.cluster_slot_size = cs
            self.cluster_cam_of = cam_of  # (ncl, cs) on the host, -1 = pad

            def block_maps(rows_cam, cols_cam):
                """Per (cluster, i, j) the unique-pair row of the pair
                (rows_cam[c, i], cols_cam[c, j]) in either orientation;
                ``n_uniq`` (a zero row) where unobserved or padded."""
                a = np.broadcast_to(rows_cam[:, :, None], (len(rows_cam), cs, cs))
                b = np.broadcast_to(cols_cam[:, None, :], (len(rows_cam), cs, cs))
                ok = ((a >= 0) & (b >= 0)).reshape(-1)
                flat = np.where(ok, (np.clip(a, 0, None) * num_cameras
                                     + np.clip(b, 0, None)).reshape(-1), 0)
                return (torch.as_tensor(np.where(ok, pos2u[flat], n_uniq)).to(device),
                        torch.as_tensor(np.where(ok, pos2u_t[flat], n_uniq)).to(device))

            self.cluster_map_u, self.cluster_map_l = block_maps(cam_of, cam_of)
            # cluster c (rows) against cluster c + 1 (columns); both
            # orientations, so the build holds for any cluster_of
            self.band_map_u = self.band_map_l = None
            if self.cluster_band and ncl > 1:
                self.band_map_u, self.band_map_l = block_maps(cam_of[:-1], cam_of[1:])

    # -- the sharded plan (skeres_tpu/core/explicit_schur.py:469-606) --------

    def _plan_sharded(self, B, pt_idx, grid_src, swap_g, valid_g, pair_id_g, uniq,
                      pad_waste, cap, device):
        """This rank's grid of whole points, its hierarchical sum ending in a
        placement onto the global unique-pair table, and the replicated
        straddle fixup. ``grid_src``, ``swap_g``, ``valid_g`` and
        ``pair_id_g`` are the whole problem's point grid, one row a point
        (rows of a point in row order, as the JAX package's per-shard
        grids take them)."""
        ns, kp, npairs = self.n_shards, self.kp, self.npairs
        bs = -(-B // ns)
        lo, hi = shard_rows(B, ns, self.rank)
        b_local = hi - lo

        # straddle detection: per point, the shards of its first and last rows
        pt_v = np.asarray(pt_idx, dtype=np.int64)
        order = np.argsort(pt_v, kind="stable")
        sp = pt_v[order]
        sh = order // bs
        starts = np.searchsorted(sp, np.arange(self.np_))
        ends = np.append(starts[1:], B)
        nonempty = ends > starts
        first_sh = np.full(self.np_, -1, dtype=np.int64)
        last_sh = np.full(self.np_, -1, dtype=np.int64)
        first_sh[nonempty] = sh[starts[nonempty]]
        last_sh[nonempty] = sh[ends[nonempty] - 1]
        straddle = np.nonzero(nonempty & (first_sh != last_sh))[0]
        if len(straddle) > max(4 * ns, 64):
            # rows not point-clustered: per-shard pair locality is gone
            raise ValueError("too many shard-straddling points for sharded explicit S")
        whole = nonempty & (first_sh == last_sh)
        # per-shard whole point lists (straddlers excluded), as the JAX plan
        self.shard_points = [np.nonzero(whole & (first_sh == s))[0] for s in range(ns)]
        p_max = max(1, max(len(p) for p in self.shard_points))
        if ns * p_max * kp > 1.5 * pad_waste * 2.0 * max(B, 1):
            raise ValueError("shard point imbalance too high for explicit S")
        # every shard's level-0 waste, at the JAX plan's uniform p_max grid,
        # so that every rank takes the same decision
        n_rows0 = p_max * npairs
        for pts in self.shard_points:
            ids = pair_id_g[pts].reshape(-1)
            n0 = _level0_rows(ids[ids >= 0], cap)
            if n0 >= (1 << 20) and n0 > 3.0 * max(n_rows0, 1):
                raise ValueError(
                    "unique-pair fan-in too low for the hierarchical padded "
                    f"sum ({n0} padded rows vs {n_rows0} pair rows)"
                )

        def local_src(rows):
            """Global row ids (sentinel ``B``) -> this rank's row ids, the
            sentinel ``b_local`` (a zero row) for a row another rank holds."""
            mine = (rows >= lo) & (rows < hi)
            return torch.as_tensor(np.where(mine, rows - lo, b_local).reshape(-1)).to(device)

        def sum_plan(pts):
            """The hierarchical sum over the points ``pts``' pair rows and
            its placement onto the global unique-pair table."""
            ids = pair_id_g[pts].reshape(-1)
            rows = np.nonzero(ids >= 0)[0]
            levels, uniq_s = _hierarchical_sum_plan(ids[rows], rows, len(pts) * npairs, cap=cap)
            place = torch.as_tensor(np.searchsorted(uniq, uniq_s)).to(device)
            return _freeze_levels(levels, device), place

        pts = self.shard_points[self.rank]
        self.local_pt = torch.as_tensor(pts).to(device)
        self.grid_src = local_src(grid_src[pts])
        self.swap_mask = torch.as_tensor(swap_g[pts]).to(device)
        self.pair_valid = torch.as_tensor(valid_g[pts]).to(device)
        self.levels, self.place = sum_plan(pts)

        self.n_straddle = len(straddle)
        self.fix_pt = torch.as_tensor(straddle).to(device)
        self.fix_src = local_src(grid_src[straddle])
        self.fix_swap = torch.as_tensor(swap_g[straddle]).to(device)
        self.fix_valid = torch.as_tensor(valid_g[straddle]).to(device)
        self.fix_levels, self.fix_place = sum_plan(straddle)
        # K3 launches on the fixup grid (the wrapper counts every launch)
        self.fix_products = 0

    # -- runtime -----------------------------------------------------------

    def build_grid(self, a_flat: torch.Tensor) -> dict:
        """mu-independent prep: lay the per-row A = F^T E rows (B, f*e) onto
        the point grid (P, kp*f*e). Hoisted to once per linearization
        (SchurSolver.prepare); rejected-step re-solves then pay only the
        C^-1-dependent pair products. Under a mesh ``a_flat`` holds this
        rank's rows; the grid is that of its whole points, and ``"fix"``
        the replicated straddle grid, collected by one ``all_reduce``."""
        d = a_flat.shape[1]
        if self.mesh is not None:
            padded = torch.cat([a_flat, a_flat.new_zeros((1, d))])
            grid = padded[self.grid_src].reshape(-1, self.kp * d)
            fix = all_reduce_sum(padded[self.fix_src], self.mesh)
            return {"grid": grid, "fix": fix.reshape(self.n_straddle, self.kp * d)}
        if self.grid_is_reshape:
            grid = a_flat.reshape(self.np_, self.kp * d)
        else:
            padded = torch.cat([a_flat, a_flat.new_zeros((1, d))])
            grid = padded[self.grid_src].reshape(self.np_, self.kp * d)
        return {"grid": grid}

    def _pair_values(self, grid, cinv_rows, swap, valid):
        """(Pn, kp*f*e) grid -> (Pn*npairs, f*f) pair values by K3."""
        return pair_products(
            grid, cinv_rows, swap, valid, self.pair_kl, self.f, self.e, self.chunk_points
        )

    def correction_offdiag(self, grid: dict, cinv_flat: torch.Tensor) -> torch.Tensor:
        """sum over points of Y_pk A_pl^T for k < l, reduced to the unique
        camera-pair blocks: flat (n_uniq, f*f) f-major rows.

        grid:      dict from :meth:`build_grid` (mu-independent);
        cinv_flat: (P, e*e).
        """
        if self.n_uniq == 0 or self.npairs == 0:
            return cinv_flat.new_zeros((self.n_uniq, self.f * self.f))
        if self.mesh is not None:
            return self._correction_offdiag_sharded(grid, cinv_flat)
        vals = self._pair_values(
            grid["grid"].contiguous(), cinv_flat.contiguous(), self.swap_mask, self.pair_valid
        )
        return _apply_hierarchical_sum(self.levels, vals)

    def _correction_offdiag_sharded(self, grid, cinv_flat):
        """K3 on this rank's grid, its own levels, the placement into the
        global table and one ``all_reduce``; then K3 on the replicated
        fixup grid, added after the reduce
        (``skeres_tpu/core/explicit_schur.py:735-801``)."""
        uniq = cinv_flat.new_zeros((self.n_uniq, self.f * self.f))
        if self.place.numel():  # a valid pair on this rank's whole points
            vals = self._pair_values(grid["grid"].contiguous(),
                                     cinv_flat[self.local_pt].contiguous(),
                                     self.swap_mask, self.pair_valid)
            uniq[self.place] = _apply_hierarchical_sum(self.levels, vals)
        all_reduce_sum(uniq, self.mesh)
        if self.fix_place.numel():
            vals = self._pair_values(grid["fix"].contiguous(),
                                     cinv_flat[self.fix_pt].contiguous(),
                                     self.fix_swap, self.fix_valid)
            if vals.is_cuda:
                self.fix_products += 1
            uniq[self.fix_place] += _apply_hierarchical_sum(self.fix_levels, vals)
        return uniq

    def dense_s_full(self, uniq_flat, diag_flat):
        """The full (nc*f, nc*f) correction-plus-diagonal matrix in one
        gather-build: the per-camera diagonal blocks ``diag_flat``
        (nc, f*f) ride as the table's diagonal region. The off-diagonal is
        exactly symmetric by construction: entries (a, b) and (b, a) read
        the same table row, one of them transposed."""
        zero = uniq_flat.new_zeros((1, self.f * self.f))
        cc = torch.cat([uniq_flat, zero])[self.diag_pair_idx]
        diag_region = cc + _transpose_blocks(cc, self.f) + diag_flat
        combined = torch.cat(
            [uniq_flat, _transpose_blocks(uniq_flat, self.f), diag_region, zero]
        )
        return self._rearrange_dense(combined)

    def dense_s_offdiag(self, uniq_flat):
        """The (nc*f, nc*f) off-diagonal correction from the unique pair
        blocks, by the same gather-build as :meth:`dense_s_full` with no
        diagonal blocks beyond the same-camera pair fold."""
        return self.dense_s_full(uniq_flat, uniq_flat.new_zeros((self.nc, self.f * self.f)))

    def _cluster_blocks(self, uniq_flat, map_u, map_l, n: int):
        """(n, cs*f, cs*f) matrices from the unique-pair table: block
        (i, j) of matrix c reads its pair's row as stored (``map_u``, the
        lower-numbered camera's rows) or transposed (``map_l``). K3 writes
        f-major rows, so the transpose of a block is the transpose of its
        (f, f) view."""
        cs, f = self.cluster_slot_size, self.f
        padded = torch.cat([uniq_flat, uniq_flat.new_zeros((1, f * f))])
        blocks = padded[map_u] + _transpose_blocks(padded[map_l], f)
        return blocks.view(n, cs, cs, f, f).permute(0, 1, 3, 2, 4).reshape(n, cs * f, cs * f)

    def cluster_offdiag(self, uniq_flat):
        """Batched (n_clusters, cs*f, cs*f) off-diagonal correction blocks
        from the cluster-restricted unique-pair table, the CLUSTER_JACOBI
        preconditioner's matrices; rows and columns of padded cluster slots
        are zero."""
        return self._cluster_blocks(uniq_flat, self.cluster_map_u, self.cluster_map_l,
                                    self.n_clusters)

    def cluster_band_offdiag(self, uniq_flat):
        """Batched (n_clusters - 1, cs*f, cs*f) correction blocks coupling
        cluster c (rows) to cluster c + 1 (columns), the
        CLUSTER_TRIDIAGONAL band; needs a plan built with
        ``cluster_band=True``."""
        if self.band_map_u is None:
            raise ValueError("cluster_band_offdiag needs a plan built with cluster_band=True "
                             "and more than one cluster")
        return self._cluster_blocks(uniq_flat, self.band_map_u, self.band_map_l,
                                    self.n_clusters - 1)

    def _rearrange_dense(self, table):
        """Combined-table rows -> the dense (nc*f, nc*f) matrix, written in
        block rows of ``_CHUNK_CAMS`` cameras so the (nc*nc, f*f) block-row
        array never materializes whole."""
        nc, f = self.nc, self.f
        out = table.new_empty((nc * f, nc * f))
        pm = self.pos2u_combined.view(nc, nc)
        for c0 in range(0, nc, _CHUNK_CAMS):
            c1 = min(c0 + _CHUNK_CAMS, nc)
            g = table[pm[c0:c1].reshape(-1)].view(c1 - c0, nc, f, f)
            out[c0 * f : c1 * f].view(c1 - c0, f, nc, f).copy_(g.transpose(1, 2))
        return out
