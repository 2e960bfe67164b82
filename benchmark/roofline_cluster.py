"""The operations and bytes of one application of the visibility-based
cluster preconditioner, ``apply_cluster_preconditioner(solver, factors,
v)`` of ``core/schur.py``, counted from the solver's clusters and chains
(the rule of ``roofline.py``: each input read once, each output written
once, padding left out):

- the factor's blocks: each cluster's ``Dhat^-1`` (n f, n f) for a cluster
  of n cameras, and each ``L`` block between two clusters next to each
  other on a chain, (n_b f, n_a f), read once (the two sweeps read the
  ``L`` blocks twice; a fused apply reads them once);
- v read and the result written.

The operations are the multiply-adds of the forward sweep, the block
diagonal and the backward sweep, on the CUDA cores (matrix-vector
products).
"""

from __future__ import annotations

from benchmark.roofline import PEAK_FLOPS

__all__ = ["cluster_apply_counts"]


def cluster_apply_counts(solver, factors, v) -> dict:
    """Counts of ``apply_cluster_preconditioner(solver, factors, v)``:
    ``bytes``, ``flops`` and the ``peak`` they run at."""
    isz = v.element_size()
    f = solver.f_size
    clusters = solver.visibility
    sizes = [int(n) * f for n in clusters.sizes]
    diag = sum(n * n for n in sizes)
    band = sum(sizes[c - 1] * sizes[c] for chain in clusters.chains for c in chain[1:])
    return dict(bytes=(diag + band + 2 * v.numel()) * isz, flops=2 * diag + 4 * band,
                peak=PEAK_FLOPS[("cuda_core", isz)])
