"""k2_roofline: K2's share of its roofline, the whole blocked factor (K1
panels, panel scale, trailing update) on its entry
``blocked_cholesky_factor`` as ``core/schur.py`` calls it. Each call is
counted from its shape and panel (``roofline.k2_counts``) and timed by the
device time of what it launched inside the benchmark's range around it."""

from benchmark.roofline import k2_counts, roofline_share

ENTRY = ("skeres_tpu_torch.core.schur", "blocked_cholesky_factor")


def counts(arguments):
    a = arguments["a"]
    return k2_counts(a.shape[0], int(arguments["panel"]), a.element_size())


def read(rec):
    calls = rec["calls"].get(ENTRY[1], [])
    return roofline_share(calls) if rec["trace"] is not None and calls else None
