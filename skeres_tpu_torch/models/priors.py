"""Prior and conditioning residuals.

PyTorch counterparts of ``skeres_tpu/models/priors.py`` (reference
lineage: ``include/ceres/normal_prior.h``, ``conditioned_cost_function.h``):
residual-function combinators, closures over torch functions.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["normal_prior", "conditioned_residual"]


def normal_prior(a, mu):
    """Residual r(x) = A (x - mu): the Gaussian prior with square-root
    information A (reference: NormalPrior). Returns a residual function for
    ``add_residual_block``; batched priors may instead pass A and mu per
    block through ``data`` as ``{"a": ..., "mu": ...}``."""
    a = torch.as_tensor(np.asarray(a, dtype=np.float64))
    mu = torch.as_tensor(np.asarray(mu, dtype=np.float64)).reshape(-1)

    def fn(params, data):
        (x,) = params
        if data is not None:
            return data["a"].to(x.dtype) @ (x - data["mu"].to(x.dtype))
        return a.to(device=x.device, dtype=x.dtype) @ (x - mu.to(device=x.device, dtype=x.dtype))

    fn.__name__ = "normal_prior"
    return fn


def conditioned_residual(fn: Callable, conditioners: Sequence[Callable]):
    """Apply per-residual conditioners s_i(r_i) to a wrapped residual
    function (reference: ConditionedCostFunction). Each conditioner is a
    scalar torch function r_i -> conditioned r_i."""

    def wrapped(params, data):
        r = fn(params, data)
        return torch.stack([c(r[i]) for i, c in enumerate(conditioners)])

    wrapped.__name__ = f"conditioned_{getattr(fn, '__name__', 'residual')}"
    return wrapped
