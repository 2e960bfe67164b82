"""s_product_roofline: the implicit Schur-complement product's share of its
roofline, on its entry ``implicit_s_product`` as ``core/schur.py``'s PCG
calls it (through ``SchurSolver._s_matvec``). Each call is counted from
its shapes (``roofline_implicit.s_product_counts``: the placed and the
row-order Jacobian rows it reads, their indices, C^-1, v and the result)
and timed by the device time of what it launched inside the benchmark's
range around it. A program without that entry has nothing to read."""

from benchmark.roofline import roofline_share
from benchmark.roofline_implicit import s_product_counts

ENTRY = ("skeres_tpu_torch.core.schur", "implicit_s_product")


def counts(arguments):
    return s_product_counts(arguments["solver"], arguments["asm"], arguments["v"])


def read(rec):
    calls = rec["calls"].get(ENTRY[1], [])
    return roofline_share(calls) if rec["trace"] is not None and calls else None
