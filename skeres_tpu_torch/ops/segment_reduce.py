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

Under a mesh (``parallel/mesh.py``) a rank holds only its own rows
``[lo, hi)`` of a batch. Its :class:`ShardedReducePlan` is a plan of the
kinds above over those rows' ids, taken relative to the window
``[w0, w0 + R)`` of destinations they touch (observations grouped by
point keep their points in a short window, so the local plan stays
'contig' where the rank's rows hold whole points, and ``index_add_``
elsewhere); the rank reduces into the window, places it into a zero
``(n_dest, D)`` table and runs one ``all_reduce``, the counterpart of
``build_sharded_reduce_plan`` / ``apply_sharded_reduce_plan``
(``skeres_tpu/ops/segment_reduce.py:149``, ``:248``). Each rank plans its
own window, so the windows need not have one width, as the JAX package's
one SPMD program needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "ReducePlan",
    "ShardedReducePlan",
    "apply_reduce_plan",
    "apply_sharded_reduce_plan",
    "build_reduce_plan",
    "build_sharded_reduce_plan",
]


class ReducePlan(NamedTuple):
    kind: str  # 'contig' | 'scatter'
    n_dest: int
    idx: Optional[torch.Tensor]  # (B,) destination ids ('scatter')
    k: int = 0  # rows per destination ('contig')


class ShardedReducePlan(NamedTuple):
    local: ReducePlan  # over this rank's rows, destinations relative to w0
    w0: int  # first destination of the rank's window
    n_dest: int


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


def build_sharded_reduce_plan(local_idx_np, n_dest: int, device) -> ShardedReducePlan:
    """Plan a rank's share of a sharded reduction: ``local_idx_np`` holds
    the destination ids of the rank's own rows."""
    ids = np.asarray(local_idx_np, dtype=np.int64)
    if len(ids) == 0:
        return ShardedReducePlan(build_reduce_plan(ids, 0, device), 0, n_dest)
    w0 = int(ids.min())
    return ShardedReducePlan(build_reduce_plan(ids - w0, int(ids.max()) - w0 + 1, device), w0,
                             n_dest)


def apply_sharded_reduce_plan(plan: ShardedReducePlan, values: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's ``values (B_local, D)`` summed by destination over every
    rank -> the replicated ``(n_dest, D)``: a local windowed reduction,
    then one ``all_reduce``."""
    from skeres_tpu_torch.parallel.mesh import all_reduce_sum

    out = values.new_zeros((plan.n_dest, values.shape[1]))
    if plan.local.n_dest:
        out[plan.w0 : plan.w0 + plan.local.n_dest] = apply_reduce_plan(plan.local, values)
    return all_reduce_sum(out, mesh)
