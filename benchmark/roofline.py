"""The yardstick of the kernel metrics: the card's peaks, the least time a
call could take, and the operations and bytes of each kernel entry,
counted from the call's shapes and masks (not from the kernel): the work
the entry's function needs, padding left out, so that whatever implements
an entry is held to the same work and none can read above 100 %.

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W (dense
rates): 3.35 TB/s of HBM; float64 67 TFLOP/s on the tensor cores (DMMA)
and 34 TFLOP/s on the CUDA cores; float32 as 3xTF32 on the tensor cores
495 / 3 TFLOP/s, and 67 TFLOP/s on the CUDA cores. Bytes count each input
read once and each output written once.

The least time is the larger of the bytes over the bandwidth and the
operations over the peak of the units the work runs on (the rule of
``chip_smoke.py``'s ``bound``). A kernel's roofline share is the summed
least time of its calls over the summed device time of everything those
calls launched.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "bound_seconds", "k1_counts", "k2_counts",
           "k3_counts", "roofline_share"]

HBM_BYTES_PER_S = 3.35e12
# (units, itemsize) -> operations per second
PEAK_FLOPS = {
    ("tensor", 8): 67e12,
    ("cuda_core", 8): 34e12,
    ("tensor", 4): 495e12 / 3,
    ("cuda_core", 4): 67e12,
}


def bound_seconds(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time the card could take for the work."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def k1_counts(n: int, itemsize: int) -> dict:
    """K1 (``cholesky_inverse_factor``): L and L^-1 of an n x n SPD matrix.
    Reads A's lower triangle, writes L and L^-1; n^3/3 for the factor and
    as many for the inverse. The updates run on the tensor cores."""
    return dict(bytes=(n * (n + 1) // 2 + 2 * n * n) * itemsize, flops=2 * n ** 3 / 3,
                peak=PEAK_FLOPS[("tensor", itemsize)])


def k2_counts(n: int, panel: int, itemsize: int) -> dict:
    """K2 (``blocked_cholesky_factor``): the blocked factor of an n x n SPD
    matrix over ``panel``-wide panels. Reads A's lower triangle, writes L
    (n x n) and the panels' inverses; n^3/3 operations."""
    panels = [min(panel, n - off) for off in range(0, n, panel)]
    return dict(bytes=(n * (n + 1) // 2 + n * n + sum(w * w for w in panels)) * itemsize,
                flops=n ** 3 / 3, peak=PEAK_FLOPS[("tensor", itemsize)])


def k3_counts(points: int, slots: int, pairs: int, mask_entries: int, f: int, e: int,
              itemsize: int) -> dict:
    """K3 (``pair_products``): Y = A C^-1 for each observed slot and Y_k A_l^T
    for each valid pair (k, l), counted from the call's valid mask, so that
    padded slots and invalid pairs (written as zeros) count no work.
    ``points`` have a valid pair, ``slots`` lie in one, ``pairs`` are valid,
    ``mask_entries`` is the mask's size. Reads the observed slots' (f, e)
    blocks, those points' C^-1 (e, e), the valid mask and the valid pairs'
    swap flags (a byte each); writes the valid pairs' (f, f) blocks. On the
    CUDA cores."""
    floats = pairs * f * f + slots * f * e + points * e * e
    return dict(bytes=floats * itemsize + mask_entries + pairs,
                flops=2 * (slots * f * e * e + pairs * f * f * e),
                peak=PEAK_FLOPS[("cuda_core", itemsize)])


def roofline_share(calls) -> float | None:
    """Percent of the roofline over ``calls`` (each with ``bytes``,
    ``flops``, ``peak`` and ``device_s``, the device time of what it
    launched); a call that launched nothing the trace saw (one made while
    a CUDA graph was captured) is left out. None where nothing ran."""
    timed = [c for c in calls if c.get("device_s", 0.0) > 0.0]
    seconds = sum(c["device_s"] for c in timed)
    if seconds <= 0.0:
        return None
    return 100.0 * sum(bound_seconds(c["bytes"], c["flops"], c["peak"]) for c in timed) / seconds
