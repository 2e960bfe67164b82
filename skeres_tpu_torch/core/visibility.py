"""Visibility clustering of the cameras for the cluster preconditioners
(reference: Ceres ``visibility.cc``, ``canonical_views_clustering.cc``,
``single_linkage_clustering.cc``, ``graph_algorithms.h``
``Degree2MaximumSpanningForest``, ``visibility_based_preconditioner.cc``;
Kushal and Agarwal, "Visibility Based Preconditioning for Bundle
Adjustment", CVPR 2012): the clusters of CLUSTER_JACOBI and the clusters
and chains of CLUSTER_TRIDIAGONAL when ``visibility_clustering_type`` is
set. Without it the cluster preconditioners take contiguous ranges of
``cluster_jacobi_size`` camera indices, one chain in index order.

From the observations' camera and point indices, on their device:

1. visibility: each point's cameras on a (points, kp) grid, a camera that
   sees a point twice counted once; |V_i|, the points camera i sees, and
   |V_i & V_j|, the points cameras i and j share, counted over the grid's
   camera pairs;
2. the Schur-complement graph: weight ``|V_i & V_j| / sqrt(|V_i| |V_j|)``
   on each pair of cameras that share a point, and a self edge of weight 1
   on every camera (Ceres adds it, so that a center covers itself);
3. the clusters, by
   - CANONICAL_VIEWS (Simon, Snavely and Seitz, ICCV 2007, as Ceres runs
     it): centers are chosen greedily by the gain
     ``sum_n max(0, w(n, v) - sim(n)) - SIZE_PENALTY
     - SIMILARITY_PENALTY * sum_centers w(c, v)`` over v's neighbours n
     (v itself included), ``sim(n)`` the weight of n to its most similar
     center so far (0 for none): at least ``MIN_VIEWS`` centers, then
     while the best gain is positive. A camera joins the center it is
     most similar to (the earlier center where two are equal); a camera
     with no edge to any center is a cluster of its own;
   - SINGLE_LINKAGE: the connected components of the edges of weight at
     least ``MIN_SIMILARITY``;
4. (CLUSTER_TRIDIAGONAL) the cluster graph, weight the number of points
   that two clusters both see, and its degree-2 maximum spanning forest:
   edges heaviest first, one skipped where an end already has two or where
   it closes a cycle. The forest's paths are the chains.

The constants are as recalled from ``visibility_based_preconditioner.cc``
and ``canonical_views_clustering.h`` (size penalty 3.0, similarity penalty
0.0, view score weight 0, at least 3 views; single linkage at 0.9), not
checked against the source.

Ties, which a plain reference has to follow: gains within a relative
``TIE_RTOL`` of the best count as equal, and the lowest camera index wins;
forest edges of equal weight go lowest (cluster, cluster) pair first
(Ceres's reverse sort takes the highest). Clusters are first numbered by
their center's order, then the unclustered cameras by index; a chain runs
from its lower-numbered end; chains are ordered longest first, then by
that end; and the clusters are numbered anew chain by chain, so that each
chain is a run of consecutive cluster ids (``VisibilityClusters``).

Steps 1, 2 and 4's counts and each greedy step's gains are torch ops on the
device; each greedy step reads its winner on the host, and the forest
(over a few hundred clusters' edges) is built on the host. Spans:
``skeres.plan.cluster.visibility`` (1-2), ``.views`` (3), ``.forest`` (4).

``slot_sizes`` pads the uneven clusters into as few slot sizes as keep the
padded rows under twice the real ones, and ``ChainLayout`` lays the
clusters, their slot sizes and the chains' steps out for the
preconditioner's batched factor and sweeps (``core/schur.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from skeres_tpu_torch.core.types import VisibilityClusteringType
from skeres_tpu_torch.utils.trace import span

__all__ = ["ChainLayout", "VisibilityClusters", "camera_graph", "canonical_views",
           "cluster_graph", "degree2_forest", "forest_chains", "plan_visibility",
           "point_grid", "single_linkage", "slot_sizes"]

SIZE_PENALTY = 3.0
SIMILARITY_PENALTY = 0.0
MIN_VIEWS = 3
MIN_SIMILARITY = 0.9
TIE_RTOL = 1e-12
PAD_LIMIT = 2.0  # slot rows under this many times the real rows


def point_grid(cam_idx: torch.Tensor, pt_idx: torch.Tensor, num_cameras: int,
               num_points: int) -> torch.Tensor:
    """(num_points, kp) int64: each point's distinct cameras in increasing
    order, -1 after them."""
    cam, pt, nc = cam_idx.long(), pt_idx.long(), num_cameras
    key = torch.unique(pt * nc + cam)  # sorted: by point, then camera; repeats gone
    p, c = key // nc, key % nc
    counts = torch.bincount(p, minlength=num_points)
    kp = int(counts.max()) if p.numel() else 0
    slot = torch.arange(len(p), device=p.device) - (torch.cumsum(counts, 0) - counts)[p]
    grid = torch.full((num_points, kp), -1, dtype=torch.int64, device=p.device)
    grid[p, slot] = c
    return grid


def _sorted_distinct(grid: torch.Tensor) -> torch.Tensor:
    """Each row in increasing order with its repeats and pads -1 (kept in
    place, so that the valid entries stay increasing)."""
    g = torch.sort(grid, dim=1).values
    rep = torch.zeros_like(g, dtype=torch.bool)
    rep[:, 1:] = g[:, 1:] == g[:, :-1]
    return torch.where(rep, -1, g)


def _pair_counts(grid: torch.Tensor, n: int):
    """Over the rows of ``grid`` (increasing, distinct, -1 pads), each pair
    a < b of two entries of one row and the number of rows that hold it:
    (a, b, count), ordered by (a, b)."""
    kp = grid.shape[1]
    if kp < 2:
        empty = grid.new_zeros(0)
        return empty, empty, empty
    iu, ju = torch.triu_indices(kp, kp, 1, device=grid.device)
    a, b = grid[:, iu].reshape(-1), grid[:, ju].reshape(-1)
    ok = (a >= 0) & (b >= 0)
    ids, counts = torch.unique(a[ok] * n + b[ok], return_counts=True)
    return ids // n, ids % n, counts


def camera_graph(grid: torch.Tensor, num_cameras: int):
    """The Schur-complement graph of the cameras from the point grid:
    ``(a, b, w)`` over the pairs a < b that share a point, ``w =
    |V_a & V_b| / sqrt(|V_a| |V_b|)`` in float64 (the self edges are
    implied)."""
    vis = torch.bincount(grid[grid >= 0], minlength=num_cameras).to(torch.float64)
    a, b, shared = _pair_counts(grid, num_cameras)
    return a, b, shared.to(torch.float64) / torch.sqrt(vis[a] * vis[b])


def _neighbour_grid(a, b, w, n):
    """Each camera's neighbours and weights, itself first with weight 1,
    on an (n, most) grid padded with ``n`` and weight 0."""
    dev = w.device
    src = torch.cat([torch.arange(n, device=dev), b, a])
    dst = torch.cat([torch.arange(n, device=dev), a, b])
    wt = torch.cat([torch.ones(n, dtype=w.dtype, device=dev), w, w])
    order = torch.argsort(dst, stable=True)
    src, dst, wt = src[order], dst[order], wt[order]
    counts = torch.bincount(dst, minlength=n)
    slot = torch.arange(len(dst), device=dev) - (torch.cumsum(counts, 0) - counts)[dst]
    most = int(counts.max())
    nbr = torch.full((n, most), n, dtype=torch.int64, device=dev)
    wgt = torch.zeros((n, most), dtype=w.dtype, device=dev)
    nbr[dst, slot], wgt[dst, slot] = src, wt
    return nbr, wgt


def canonical_views(a, b, w, num_cameras: int, size_penalty: float = SIZE_PENALTY,
                    similarity_penalty: float = SIMILARITY_PENALTY,
                    min_views: int = MIN_VIEWS):
    """CANONICAL_VIEWS over the camera graph ``(a, b, w)``: (the centers in
    the order chosen, a list; each camera's cluster, an int64 tensor: the
    index of its center in that list, or past them for a camera with no
    edge to any center, in camera order)."""
    n = num_cameras
    nbr, wgt = _neighbour_grid(a, b, w, n)
    dev = w.device
    sim = torch.zeros(n + 1, dtype=w.dtype, device=dev)
    sim[n] = torch.inf  # the pads improve nothing
    penalty = torch.zeros(n + 1, dtype=w.dtype, device=dev)
    owner = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    free = torch.ones(n, dtype=torch.bool, device=dev)
    order = torch.arange(n, 0, -1, device=dev)  # argmax picks the lowest index
    centers: List[int] = []
    while len(centers) < n:
        gain = torch.clamp(wgt - sim[nbr], min=0.0).sum(dim=1) - size_penalty
        if similarity_penalty:
            gain = gain - similarity_penalty * penalty[:n]
        gain = torch.where(free, gain, -torch.inf)
        best = gain.max()
        tied = free & (gain >= best - TIE_RTOL * best.abs())
        pick = torch.argmax(torch.where(tied, order, 0))
        best_v, pick_v = torch.stack([best, pick.to(best.dtype)]).tolist()
        if best_v <= 0.0 and len(centers) >= min_views:
            break
        centers.append(int(pick_v))
        free[pick] = False
        row, row_w = nbr[pick], wgt[pick]
        better = row_w > sim[row]
        sim[row] = torch.where(better, row_w, sim[row])
        owner[row] = torch.where(better, pick, owner[row])
        penalty.index_add_(0, row, row_w)
    rank = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    rank[torch.as_tensor(centers, dtype=torch.int64, device=dev)] = torch.arange(
        len(centers), device=dev)
    cluster = torch.where(owner[:n] >= 0, rank[owner[:n].clamp(min=0)], -1)
    alone = cluster < 0
    cluster[alone] = len(centers) + torch.arange(int(alone.sum()), device=dev)
    return centers, cluster


def single_linkage(a, b, w, num_cameras: int, min_similarity: float = MIN_SIMILARITY):
    """SINGLE_LINKAGE: each camera's cluster, the connected components of
    the edges of weight at least ``min_similarity``, numbered by their
    lowest camera (an int64 tensor)."""
    keep = w >= min_similarity
    a, b = a[keep], b[keep]
    label = torch.arange(num_cameras, device=w.device)
    while True:
        new = label.clone()
        new.scatter_reduce_(0, a, label[b], reduce="amin")
        new.scatter_reduce_(0, b, label[a], reduce="amin")
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    return torch.unique(label, return_inverse=True)[1]


def cluster_graph(grid: torch.Tensor, cluster: torch.Tensor, num_clusters: int):
    """The cluster graph: (a, b, number of points both clusters see) over the
    pairs a < b that share one."""
    cl = torch.where(grid >= 0, cluster[grid.clamp(min=0)], -1)
    return _pair_counts(_sorted_distinct(cl), num_clusters)


def degree2_forest(num_vertices: int, a, b, w) -> list:
    """The degree-2 maximum spanning forest of the graph ``(a, b, w)``
    (host arrays): edges heaviest first, ties lowest (a, b) first; an edge
    is skipped where an end already has two or where it closes a cycle.
    Its edges (a, b), in the order taken."""
    a, b, w = (np.asarray(x) for x in (a, b, w))
    parent = list(range(num_vertices))
    degree = [0] * num_vertices

    def root(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = []
    for k in np.lexsort((b, a, -w)):
        i, j = int(a[k]), int(b[k])
        if degree[i] == 2 or degree[j] == 2:
            continue
        ri, rj = root(i), root(j)
        if ri == rj:
            continue
        edges.append((i, j))
        degree[i] += 1
        degree[j] += 1
        parent[max(ri, rj)] = min(ri, rj)
    return edges


def forest_chains(num_vertices: int, edges) -> list:
    """The paths of a forest of degree at most 2, each from its
    lower-numbered end, longest first, then by that end."""
    adj = [[] for _ in range(num_vertices)]
    for i, j in edges:
        adj[i].append(j)
        adj[j].append(i)
    seen = [False] * num_vertices
    chains = []
    for c in range(num_vertices):
        if seen[c] or len(adj[c]) == 2:
            continue
        chain, prev = [c], None
        seen[c] = True
        while True:
            nxt = [x for x in adj[chain[-1]] if x != prev]
            if not nxt:
                break
            prev = chain[-1]
            chain.append(nxt[0])
            seen[nxt[0]] = True
        chains.append(chain)
    return sorted(chains, key=lambda ch: (-len(ch), ch[0]))


def slot_sizes(sizes, limit=None) -> np.ndarray:
    """The slot size of each cluster of ``sizes`` cameras: as few distinct
    slot sizes as keep the summed slots under ``limit`` (default
    ``PAD_LIMIT``) times the summed sizes (the fewest-padding choice for
    that number), each cluster in the smallest slot that holds it."""
    limit = PAD_LIMIT if limit is None else limit
    sizes = np.asarray(sizes, dtype=np.int64)
    u, n = np.unique(sizes, return_counts=True)
    real = int((u * n).sum())
    cum = np.concatenate([[0], np.cumsum(n)])
    # cost[i]: the fewest slot rows for the distinct sizes 0..i with the
    # current number of slot sizes, the largest of them u[i]
    cost = (u * cum[1:]).astype(np.float64)
    choice = [np.full(len(u), -1)]
    while cost[-1] >= limit * real and len(choice) < len(u):
        new = np.full(len(u), np.inf)
        pick = np.full(len(u), -1)
        for i in range(1, len(u)):
            opts = cost[:i] + u[i] * (cum[i + 1] - cum[1 : i + 1])
            j = int(np.argmin(opts))
            new[i], pick[i] = opts[j], j
        cost = new
        choice.append(pick)
    slots, i = [int(u[-1])], len(u) - 1
    for pick in reversed(choice[1:]):
        i = int(pick[i])
        slots.append(int(u[i]))
    slots = np.array(sorted(slots))
    return slots[np.searchsorted(slots, sizes)]


@dataclasses.dataclass
class VisibilityClusters:
    """The clusters and chains of one problem's cameras. Clusters are
    numbered chain by chain: chain k is the run ``chains[k]`` of cluster
    ids, consecutive; a chain of one cluster has no band."""

    kind: VisibilityClusteringType
    cluster_of: torch.Tensor  # (num_cameras,) int64, on the plan's device
    chain_of: torch.Tensor  # (num_clusters,) int64, on the plan's device
    chains: List[List[int]]
    sizes: np.ndarray  # (num_clusters,) cameras of each cluster
    slots: np.ndarray  # (num_clusters,) slot size of each cluster
    num_centers: int  # CANONICAL_VIEWS' centers (clusters with one; 0 for SINGLE_LINKAGE)

    @property
    def num_clusters(self) -> int:
        return len(self.sizes)

    @property
    def longest_chain(self) -> int:
        return max(len(c) for c in self.chains) if self.chains else 0

    @property
    def slot_sizes(self) -> list:
        return sorted({int(s) for s in self.slots})

    @property
    def padded_share(self) -> float:
        """The share of the slot rows that are padding."""
        total = int(self.slots.sum())
        return (total - int(self.sizes.sum())) / total if total else 0.0

    def describe(self) -> dict:
        return dict(kind=self.kind.value, clusters=self.num_clusters, centers=self.num_centers,
                    chains=len(self.chains), longest_chain=self.longest_chain,
                    slot_sizes=self.slot_sizes, padded_share=self.padded_share,
                    largest=int(self.sizes.max()), smallest=int(self.sizes.min()))


def plan_visibility(cam_idx, pt_idx, num_cameras: int, num_points: int,
                    kind: VisibilityClusteringType, chains: bool) -> VisibilityClusters:
    """The clusters of ``kind`` (and with ``chains``, the forest's chains;
    else every cluster a chain of its own) from the observations' camera
    and point indices (int64 tensors, on the device the plan is built on)."""
    kind = VisibilityClusteringType(kind)
    with span("skeres.plan.cluster.visibility"):
        grid = point_grid(torch.as_tensor(cam_idx), torch.as_tensor(pt_idx), num_cameras,
                          num_points)
        a, b, w = camera_graph(grid, num_cameras)
    with span("skeres.plan.cluster.views"):
        if kind == VisibilityClusteringType.CANONICAL_VIEWS:
            centers, cluster = canonical_views(a, b, w, num_cameras)
            num_centers = len(centers)
        else:
            cluster, num_centers = single_linkage(a, b, w, num_cameras), 0
        ncl = int(cluster.max()) + 1
    with span("skeres.plan.cluster.forest"):
        if chains and ncl > 1:
            ca, cb, shared = (x.cpu().numpy() for x in cluster_graph(grid, cluster, ncl))
            order = forest_chains(ncl, degree2_forest(ncl, ca, cb, shared))
        else:
            order = [[c] for c in range(ncl)]
        renumber = np.empty(ncl, dtype=np.int64)
        renumber[np.concatenate(order)] = np.arange(ncl)
        new_chains, start = [], 0
        for chain in order:
            new_chains.append(list(range(start, start + len(chain))))
            start += len(chain)
        cluster = torch.as_tensor(renumber, device=cluster.device)[cluster]
        sizes = np.bincount(cluster.cpu().numpy(), minlength=ncl)
        chain_of = np.repeat(np.arange(len(new_chains)), [len(c) for c in new_chains])
    return VisibilityClusters(kind=kind, cluster_of=cluster,
                              chain_of=torch.as_tensor(chain_of, device=cluster.device),
                              chains=new_chains, sizes=sizes, slots=slot_sizes(sizes),
                              num_centers=num_centers)


@dataclasses.dataclass
class _Group:
    """The clusters of one slot size S: their ids, the rows of their slots
    in the slot vector (n, S*f), their cameras (n*S,) (``num_cameras`` in
    a padded slot) and the pair-table maps of their (S, S) blocks."""

    ids: torch.Tensor
    rows: torch.Tensor
    cams: torch.Tensor
    map_u: torch.Tensor
    map_l: torch.Tensor


@dataclasses.dataclass
class _Step:
    """One position along the chains for one pair of slot sizes (sa of the
    previous cluster, sb of the current): the current clusters' and their
    predecessors' places in their size groups, their slot rows, and the
    maps of the (sa, sb) band blocks, predecessor rows by current
    columns."""

    sa: int
    sb: int
    prev: torch.Tensor
    cur: torch.Tensor
    rows_prev: torch.Tensor
    rows_cur: torch.Tensor
    map_u: torch.Tensor
    map_l: torch.Tensor


class ChainLayout:
    """The slot layout of ``clusters`` for a pair plan (``ExplicitSchurPlan``
    with these clusters' ``cluster_of`` and ``chain_of``): every cluster
    padded to its slot size in one slot vector of camera blocks of width
    ``f`` (clusters in id order); a size group per slot size; the chain
    heads per slot size; and the chains' steps, one list a position along
    the longest chain, split by the slot sizes of the two clusters."""

    def __init__(self, clusters: VisibilityClusters, f: int, plan):
        dev = clusters.cluster_of.device
        nc = len(clusters.cluster_of)
        slots, sizes = clusters.slots, clusters.sizes
        self.f = f
        self.clusters = clusters
        off = np.concatenate([[0], np.cumsum(slots)])
        # camera of each slot (nc for a pad), and the slot of each camera
        cl = clusters.cluster_of.cpu().numpy()
        order = np.argsort(cl, kind="stable")
        first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        pos = off[cl[order]] + np.arange(nc) - first[cl[order]]
        slot_of_cam = np.empty(nc, dtype=np.int64)
        slot_of_cam[order] = pos
        slot_cam = np.full(int(off[-1]), nc, dtype=np.int64)
        slot_cam[slot_of_cam] = np.arange(nc)
        self.slot_cam = torch.as_tensor(slot_cam, device=dev)
        self.slot_of_cam = torch.as_tensor(slot_of_cam, device=dev)

        def rows(ids, s):
            return torch.as_tensor((off[ids][:, None] * f + np.arange(s * f)[None, :]),
                                   device=dev)

        def cams(ids, s):
            return slot_cam[off[ids][:, None] + np.arange(s)[None, :]]

        self.groups: Dict[int, _Group] = {}
        place = np.empty(len(slots), dtype=np.int64)  # a cluster's row in its group
        for s in np.unique(slots):
            ids = np.nonzero(slots == s)[0]
            place[ids] = np.arange(len(ids))
            cam = cams(ids, s)
            mu, ml = plan.block_maps(torch.as_tensor(cam, device=dev),
                                     torch.as_tensor(cam, device=dev))
            self.groups[int(s)] = _Group(torch.as_tensor(ids, device=dev), rows(ids, s),
                                         torch.as_tensor(cam.reshape(-1), device=dev), mu, ml)
        heads = np.array([c[0] for c in clusters.chains], dtype=np.int64)
        self.heads = {int(s): torch.as_tensor(place[heads[slots[heads] == s]], device=dev)
                      for s in np.unique(slots[heads])}
        self.steps: List[_Step] = []
        for k in range(1, clusters.longest_chain):
            cur = np.array([c[k] for c in clusters.chains if len(c) > k], dtype=np.int64)
            prev = cur - 1
            for sa, sb in sorted({(int(slots[p]), int(slots[c])) for p, c in zip(prev, cur)}):
                sel = (slots[prev] == sa) & (slots[cur] == sb)
                p, c = prev[sel], cur[sel]
                mu, ml = plan.block_maps(torch.as_tensor(cams(p, sa), device=dev),
                                         torch.as_tensor(cams(c, sb), device=dev))
                self.steps.append(_Step(sa, sb, torch.as_tensor(place[p], device=dev),
                                        torch.as_tensor(place[c], device=dev),
                                        rows(p, sa), rows(c, sb), mu, ml))
