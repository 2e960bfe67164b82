"""Segment-reduction plans: sum per-row values by destination block.

PyTorch counterpart of ``skeres_tpu/ops/segment_reduce.py``. Every
normal-equation assembly step is "sum per-row block contributions by
destination block id", and the destination ids are fixed when the problem
is compiled, so the strategy is planned once on the host:

  'contig'  — the rows' destination ids are exactly
              ``repeat(arange(n_dest), k)`` (BAL observations grouped by
              point): a reshape and a sum, no index traffic at all.
  'scatter' — anything else: ``index_add_``.

The JAX package's 'onehot' and 'gather' kinds are workarounds for a TPU
scatter that serializes; a GPU scatter-add does not, so they are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["ReducePlan", "build_reduce_plan", "apply_reduce_plan"]


class ReducePlan(NamedTuple):
    kind: str  # 'contig' | 'scatter'
    n_dest: int
    idx: Optional[torch.Tensor]  # (B,) destination ids ('scatter')
    k: int = 0  # rows per destination ('contig')


def build_reduce_plan(idx_np, n_dest: int, device) -> ReducePlan:
    """Plan the reduction of rows with destination ids ``idx_np`` (B,)."""
    idx_np = np.asarray(idx_np, dtype=np.int64)
    b = len(idx_np)
    if n_dest > 0 and b > 0 and b % n_dest == 0:
        k = b // n_dest
        if np.array_equal(idx_np, np.repeat(np.arange(n_dest, dtype=np.int64), k)):
            return ReducePlan("contig", n_dest, None, k)
    return ReducePlan("scatter", n_dest, torch.as_tensor(idx_np).to(device))


def apply_reduce_plan(plan: ReducePlan, values: torch.Tensor) -> torch.Tensor:
    """``values (B, D)`` summed by destination -> ``(n_dest, D)``."""
    if plan.kind == "contig":
        return values.reshape(plan.n_dest, plan.k, -1).sum(dim=1)
    out = torch.zeros(
        (plan.n_dest, values.shape[1]), dtype=values.dtype, device=values.device
    )
    return out.index_add_(0, plan.idx, values)
