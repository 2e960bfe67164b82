"""The operations and bytes of one implicit Schur-complement product,
``implicit_s_product(solver, asm, v)`` of ``core/schur.py``, counted from
the call's shapes (the rule of ``roofline.py``: each input read once, each
output written once, padding left out where the call's shapes tell it).

``S v = (F^T F + D_f) v - W C^-1 W^T v`` over the observation rows:

- the point pass ``W^T v``, in row order over each observation batch:
  the rows' F and E columns, one index a row into v for each retained
  slot and one into the points for the sum;
- ``C^-1`` (points, e, e) on its result;
- the camera pass ``F^T (F v - E wc)``: on a camera-padded batch its
  placed F and E rows and their point index (the unused slots' zero
  rows left out); otherwise the rows' F and E columns again in row
  order, with their point index and one camera index a retained slot;
- v and the damping diagonal read, the result written.

The intermediate vectors by row or by point are not counted: a product
that fuses them moves none of them. The operations are the multiply-adds
of each pass, on the CUDA cores.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_FLOPS

__all__ = ["s_product_counts"]

INDEX_BYTES = 8  # int64 row indices


def s_product_counts(solver, asm, v) -> dict:
    """Counts of ``implicit_s_product(solver, asm, v)``: ``bytes``,
    ``flops`` and the ``peak`` they run at."""
    isz = v.element_size()
    n_f = v.shape[0]
    cinv = asm["cinv"]
    n_pts, e = cinv.shape[0], cinv.shape[1]
    floats = cinv.numel() + 3 * n_f
    index = 0
    flops = 2 * n_pts * e * e
    for bi in solver.e_batches:  # the point pass, row order
        _, jac, _ = asm["per_batch"][bi]
        rows, m = jac.shape[0], jac.shape[1]
        t = sum(w for _, _, _, w in solver.batch_info[bi]["ret_slots"])
        floats += rows * m * (t + e)
        index += rows * (len(solver.batch_info[bi]["ret_slots"]) + 1)
        flops += 2 * rows * m * (t + e)
    for bi, (_, jac, E) in enumerate(asm["per_batch"]):  # the camera pass
        slots = solver.batch_info[bi]["ret_slots"]
        if not slots:
            continue
        t = sum(w for _, _, _, w in slots)
        e_cols = 0 if E is None else e
        rows, m = jac.shape[0], jac.shape[1]
        # a padded batch reads its placed rows (its rows and the unused
        # slots' zero rows, which are left out) and one point index a row
        index += rows * (1 if bi in solver.sorted_info else len(slots) + (E is not None))
        floats += rows * m * (t + e_cols)
        flops += 2 * rows * m * (2 * t + e_cols)
    return dict(bytes=floats * isz + index * INDEX_BYTES, flops=flops,
                peak=PEAK_FLOPS[("cuda_core", isz)])
