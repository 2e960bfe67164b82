"""cluster_apply_roofline: the visibility-based cluster preconditioner's
apply as a share of its roofline, on its entry
``apply_cluster_preconditioner`` as ``core/schur.py``'s PCG calls it once
an iteration. Each call is counted from the solver's clusters and chains
(``roofline_cluster.cluster_apply_counts``: the factor's blocks over the
real cameras, v and the result) and timed by the device time of what it
launched inside the benchmark's range around it. A program without that
entry has nothing to read."""

from benchmark.roofline import roofline_share
from benchmark.roofline_cluster import cluster_apply_counts

ENTRY = ("skeres_tpu_torch.core.schur", "apply_cluster_preconditioner")


def counts(arguments):
    return cluster_apply_counts(arguments["solver"], arguments["factors"], arguments["v"])


def read(rec):
    calls = rec["calls"].get(ENTRY[1], [])
    return roofline_share(calls) if rec["trace"] is not None and calls else None
