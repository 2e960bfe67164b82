"""Visibility clustering of the cameras, written out plainly for the
reference: the clusters and chains that Ceres's visibility-based
preconditioners use (``visibility_based_preconditioner.cc``,
``canonical_views_clustering.cc``, ``single_linkage_clustering.cc``,
``graph_algorithms.h``), from these definitions alone, in plain torch and
Python, with nothing of the program under test:

- camera i sees the set V_i of points (a point seen twice counted once);
  the similarity of cameras i and j is ``|V_i & V_j| / sqrt(|V_i| |V_j|)``
  (1 for a camera with itself), here a dense (cameras, cameras) matrix;
- CANONICAL_VIEWS: centers are added one at a time, the camera v (not yet a
  center) of the largest gain ``sum_n max(0, sim(n, v) - best(n)) - 3.0``
  over the cameras n that share a point with v or are v (``best(n)`` n's
  largest similarity to a center so far, 0 for none), gains within a
  relative 1e-12 of the largest counting as equal and the lowest index
  taken; at least 3 centers, then while the largest gain is positive
  (the similarity penalty is 0). A camera joins the center it is most
  similar to, the earlier center on a tie; a camera similar to no center
  is a cluster of its own. Clusters are numbered by their center's order,
  then those cameras by index;
- SINGLE_LINKAGE: cameras joined wherever their similarity is at least
  0.9, numbered by their lowest camera;
- the cluster graph: the number of points two clusters both see; its
  degree-2 maximum spanning forest: edges by decreasing count, then by
  increasing (cluster, cluster), each taken unless an end has two edges
  already or its ends are joined already;
- the chains: the forest's paths, each from its lower-numbered end,
  ordered longest first, then by that end.

``clusters_and_chains`` returns each camera's cluster and the chains as
lists of the original cluster numbers.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["clusters_and_chains", "index_range_clusters"]

SIZE_PENALTY = 3.0
MIN_VIEWS = 3
MIN_SIMILARITY = 0.9
TIE_RTOL = 1e-12


def _shared_counts(owner: torch.Tensor, point: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) float64: for owners a, b, the number of points both see
    (the diagonal: the points each sees), from the (owner, point) pairs."""
    key = torch.unique(point * n + owner)
    p, o = key // n, key % n
    counts = torch.bincount(p)
    kmax = int(counts.max())
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(p), device=p.device) - first[p]
    grid = torch.full((len(counts), kmax), -1, dtype=torch.long, device=p.device)
    grid[p, slot] = o
    out = torch.zeros((n, n), dtype=torch.float64, device=p.device)
    for ka in range(kmax):
        for kb in range(kmax):
            ok = (grid[:, ka] >= 0) & (grid[:, kb] >= 0)
            out.index_put_((grid[ok, ka], grid[ok, kb]),
                           torch.ones(int(ok.sum()), dtype=torch.float64, device=p.device),
                           accumulate=True)
    return out


def _canonical_views(sim: torch.Tensor):
    n = sim.shape[0]
    linked = sim > 0
    best = torch.zeros(n, dtype=torch.float64, device=sim.device)
    center_of = torch.full((n,), -1, dtype=torch.long, device=sim.device)
    free = torch.ones(n, dtype=torch.bool, device=sim.device)
    centers = []
    while len(centers) < n:
        gain = torch.where(linked, torch.clamp(sim - best[:, None], min=0.0), 0.0).sum(0)
        gain = gain - SIZE_PENALTY
        top = float(torch.max(gain[free]))
        tied = free & (gain >= top - TIE_RTOL * abs(top))
        v = int(torch.nonzero(tied)[0])
        if top <= 0.0 and len(centers) >= MIN_VIEWS:
            break
        centers.append(v)
        free[v] = False
        closer = linked[:, v] & (sim[:, v] > best)
        best = torch.where(closer, sim[:, v], best)
        center_of = torch.where(closer, v, center_of)
    number = {c: k for k, c in enumerate(centers)}
    cluster = [number[int(c)] if c >= 0 else -1 for c in center_of.tolist()]
    extra = len(centers)
    for i in range(n):
        if cluster[i] < 0:
            cluster[i] = extra
            extra += 1
    return np.array(cluster, dtype=np.int64)


def _single_linkage(sim: torch.Tensor):
    n = sim.shape[0]
    root = list(range(n))

    def find(x):
        while root[x] != x:
            x = root[x]
        return x

    ii, jj = torch.nonzero(torch.triu(sim >= MIN_SIMILARITY, diagonal=1), as_tuple=True)
    for i, j in zip(ii.tolist(), jj.tolist()):
        a, b = find(i), find(j)
        if a != b:
            root[max(a, b)] = min(a, b)
    lowest = [find(i) for i in range(n)]
    number = {r: k for k, r in enumerate(sorted(set(lowest)))}
    return np.array([number[r] for r in lowest], dtype=np.int64)


def _forest_chains(weights: torch.Tensor):
    """The chains of the degree-2 maximum spanning forest of the cluster
    graph ``weights`` (dense, symmetric, counts)."""
    n = weights.shape[0]
    ii, jj = torch.nonzero(torch.triu(weights > 0, diagonal=1), as_tuple=True)
    edges = sorted(zip((-weights[ii, jj]).tolist(), ii.tolist(), jj.tolist()))
    comp = list(range(n))

    def find(x):
        while comp[x] != x:
            x = comp[x]
        return x

    nbrs = [[] for _ in range(n)]
    for _, i, j in edges:
        if len(nbrs[i]) == 2 or len(nbrs[j]) == 2:
            continue
        a, b = find(i), find(j)
        if a == b:
            continue
        comp[max(a, b)] = min(a, b)
        nbrs[i].append(j)
        nbrs[j].append(i)
    chains, done = [], set()
    for c in range(n):
        if c in done or len(nbrs[c]) == 2:
            continue
        chain = [c]
        done.add(c)
        while True:
            nxt = [x for x in nbrs[chain[-1]] if x not in done]
            if not nxt:
                break
            chain.append(nxt[0])
            done.add(nxt[0])
        chains.append(chain)
    chains.sort(key=lambda ch: (-len(ch), ch[0]))
    return chains


def clusters_and_chains(camera_index, point_index, num_cameras: int, kind: str, chains: bool):
    """(each camera's cluster (num_cameras,) int64 array, the chains as
    lists of clusters) for visibility clustering ``kind``
    (``CANONICAL_VIEWS`` or ``SINGLE_LINKAGE``); without ``chains`` each
    cluster is a chain of its own."""
    cam = torch.as_tensor(camera_index).long()
    pt = torch.as_tensor(point_index).long()
    shared = _shared_counts(cam, pt, num_cameras)
    seen = torch.diagonal(shared)
    sim = shared / torch.sqrt(seen[:, None] * seen[None, :])
    if kind == "CANONICAL_VIEWS":
        cluster = _canonical_views(sim)
    elif kind == "SINGLE_LINKAGE":
        cluster = _single_linkage(sim)
    else:
        raise ValueError(f"no visibility clustering {kind!r}")
    ncl = int(cluster.max()) + 1
    if not chains or ncl == 1:
        return cluster, [[c] for c in range(ncl)]
    of_row = torch.as_tensor(cluster, device=cam.device)[cam]
    weights = _shared_counts(of_row, pt, ncl)
    weights.fill_diagonal_(0.0)
    return cluster, _forest_chains(weights)


def index_range_clusters(num_cameras: int, size: int, chains: bool):
    """The clusters of ``size`` consecutive camera indices, and one chain
    in index order (or each cluster a chain of its own)."""
    cluster = np.arange(num_cameras) // max(size, 1)
    ncl = int(cluster.max()) + 1
    return cluster, ([list(range(ncl))] if chains else [[c] for c in range(ncl)])
