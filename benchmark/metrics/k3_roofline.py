"""k3_roofline: K3's share of its roofline on its entry ``pair_products``
as ``core/explicit_schur.py`` calls it. Each call is counted from its own
valid mask (``roofline.k3_counts``: valid pairs, the slots and points they
use) and timed by the device time of what it launched inside the
benchmark's range around it."""

import torch

from benchmark.roofline import k3_counts, roofline_share

ENTRY = ("skeres_tpu_torch.core.explicit_schur", "pair_products")


def counts(arguments):
    """The call's counts as 0-d tensors on its device, so that counting
    waits for nothing; the harness reads them once the window has closed."""
    grid, valid, pair_kl = arguments["grid"], arguments["valid"], arguments["pair_kl"]
    f, e = int(arguments["f"]), int(arguments["e"])
    kp = grid.shape[1] // (f * e)
    # slot k of a point is used where one of its valid pairs has k or l = k
    incidence = torch.zeros((pair_kl.shape[1], kp), dtype=torch.float32, device=valid.device)
    pairs = torch.arange(pair_kl.shape[1], device=valid.device)
    incidence[pairs, pair_kl[0].long()] = 1.0
    incidence[pairs, pair_kl[1].long()] = 1.0
    used = (valid.to(torch.float32) @ incidence) > 0
    return k3_counts(used.any(dim=1).sum(), used.sum(), valid.sum(), valid.numel(), f, e,
                     grid.element_size())


def read(rec):
    calls = rec["calls"].get(ENTRY[1], [])
    return roofline_share(calls) if rec["trace"] is not None and calls else None
