"""Schur elimination-ordering discovery.

PyTorch counterpart of ``skeres_tpu/core/ordering.py`` (reference lineage:
``internal/ceres/reorder_program.cc`` ComputeStableSchurOrdering,
``parameter_block_ordering.cc`` ComputeSchurOrdering): when the user has
not declared which parameter blocks to eliminate, find them.

Parameter blocks live in typed group arrays and residual batches connect
groups through slots, so the search is over groups. A group is an
independent set exactly when no residual batch has two slots in it (no
residual couples two of its blocks): one slot takes one block per row.
Among the independent groups the one with the most parameter blocks is
eliminated, the reference's heuristic (points vastly outnumber cameras).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["independent_groups", "compute_schur_ordering", "apply_schur_ordering"]


def independent_groups(program) -> List[int]:
    """Indices of the groups that form independent sets (eliminable)."""
    out = []
    for gi in range(len(program.groups)):
        slots = [sum(g == gi for g in b.slot_groups) for b in program.batches]
        if all(n <= 1 for n in slots) and any(slots):
            out.append(gi)
    return out


def compute_schur_ordering(program) -> Optional[int]:
    """The group to eliminate: the independent group with the most blocks,
    or None when no group qualifies."""
    candidates = independent_groups(program)
    if not candidates:
        return None
    # never eliminate everything: the smallest candidate (the cameras) is
    # retained when every group is independent
    if len(candidates) == len(program.groups):
        candidates = sorted(candidates, key=lambda gi: program.groups[gi].num_blocks)[1:]
        if not candidates:
            return None
    return max(candidates, key=lambda gi: program.groups[gi].num_blocks)


def apply_schur_ordering(program) -> Optional[int]:
    """Tag the discovered group as eliminated (``schur_group = 0``) and the
    rest as retained; returns the eliminated group's index, or None."""
    gi = compute_schur_ordering(program)
    if gi is None:
        return None
    for j, g in enumerate(program.groups):
        g.schur_group = 0 if j == gi else 1
    return gi
