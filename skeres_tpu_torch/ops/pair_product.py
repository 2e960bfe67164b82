"""K3: the explicit-Schur pair products, a hand-written CUDA kernel.

Counterpart of ``skeres_tpu/ops/pallas/pair_product.py``
(``pair_products_lanes`` → ``_pair_kernel``), with the form of
``ExplicitSchurPlan._chunk_vals`` to match: for every point p and every
pair (k, l) of its observation slots, ``T = Y_pk A_pl^T`` with
``Y_pk = A_pk C_p^-1``, stored in canonical camera order (transposed where
``swap`` is set) and zeroed where the pair is not ``valid``. Rows are
f-major (``T[i, j]`` at column ``i * f + j``), the layout the rest of the
explicit-S assembly reads, so the JAX package's ``perm_t`` column
permutation has no counterpart here.

The kernel is ``csrc/pair_product.cu`` (its header says what bounds it on
the card: the output write). It is built at first use by
``ops/build.py``. A CUDA tensor launches it or raises; a CPU tensor takes
the plain version, :func:`pair_products_reference`, which is point-chunked
by the same byte budget as the JAX package's ``_chunked_pair_values``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from skeres_tpu_torch.ops.build import load_library

__all__ = [
    "KERNEL_SHAPES",
    "build_kernels",
    "pair_products",
    "pair_products_reference",
]

KERNEL_SHAPES = ((9, 3), (5, 3))  # (f, e) instances in csrc/pair_product.cu
_SMEM_BUDGET = 40 * 1024  # bytes of shared memory a block's tile may take


@functools.lru_cache(maxsize=None)
def build_kernels():
    """Compile ``csrc/pair_product.cu`` (``ops/build.py``) and bind it.
    Returns ``(library, compiler_log)``."""
    lib, log = load_library("pair_product")
    for name in ("skeres_pair_products_f32", "skeres_pair_products_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_long] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib, log


def _check(grid, cinv_flat, swap, valid, pair_kl, f, e):
    if grid.dtype not in (torch.float32, torch.float64) or cinv_flat.dtype != grid.dtype:
        raise TypeError(
            f"K3 takes float32 or float64 grid and C^-1 of one dtype, got "
            f"{grid.dtype} and {cinv_flat.dtype}"
        )
    p = grid.shape[0]
    if grid.ndim != 2 or grid.shape[1] % (f * e) or grid.shape[1] < 2 * f * e:
        raise ValueError(f"K3 takes a (P, kp * {f * e}) grid with kp >= 2, got {tuple(grid.shape)}")
    npairs = pair_kl.shape[-1]
    shapes = {
        "cinv_flat": (cinv_flat, (p, e * e), None),
        "swap": (swap, (p, npairs), torch.bool),
        "valid": (valid, (p, npairs), torch.bool),
        "pair_kl": (pair_kl, (2, npairs), torch.int32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or (dtype is not None and t.dtype != dtype):
            raise ValueError(f"K3 takes {name} {shape} {dtype or ''}, got {tuple(t.shape)} {t.dtype}")
    for t in (grid, cinv_flat, swap, valid, pair_kl):
        if not t.is_contiguous():
            raise ValueError("K3 takes contiguous (row-major) tensors")
        if t.device != grid.device:
            raise ValueError(f"K3 takes tensors on one device, got {t.device} and {grid.device}")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K3 runs on cuda (or its plain version on cpu), not {grid.device}")


def pair_products_reference(grid, cinv_flat, swap, valid, pair_kl, f: int, e: int,
                            chunk_points: Optional[int] = None):
    """Plain version of K3: ``(P * npairs, f * f)`` canonical pair-product
    rows by ``torch.einsum``, ``chunk_points`` points at a time."""
    p = grid.shape[0]
    kp = grid.shape[1] // (f * e)
    k_idx, l_idx = pair_kl[0].long(), pair_kl[1].long()
    npairs = k_idx.numel()
    out = torch.empty((p * npairs, f * f), dtype=grid.dtype, device=grid.device)
    step = chunk_points or max(p, 1)
    for c0 in range(0, p, step):
        c1 = min(c0 + step, p)
        a = grid[c0:c1].reshape(c1 - c0, kp, f, e)
        y = torch.einsum("pkfe,peg->pkfg", a, cinv_flat[c0:c1].reshape(c1 - c0, e, e))
        t = torch.einsum("pnfe,pnge->pnfg", y[:, k_idx], a[:, l_idx])
        t = torch.where(swap[c0:c1, :, None, None], t.transpose(2, 3), t)
        t = torch.where(valid[c0:c1, :, None, None], t, t.new_zeros(()))
        out[c0 * npairs : c1 * npairs] = t.reshape(-1, f * f)
    return out


def pair_products(grid, cinv_flat, swap, valid, pair_kl, f: int, e: int,
                  chunk_points: Optional[int] = None):
    """Canonical pair-product rows ``(P * npairs, f * f)``, f-major.

    ``grid`` (P, kp*f*e): per point its kp slots' A = F^T E blocks,
    f-major; ``cinv_flat`` (P, e*e); ``swap``, ``valid`` (P, npairs) bool;
    ``pair_kl`` (2, npairs) int32, the slots (k, l) of each pair.
    ``chunk_points`` bounds the plain version's transients.
    ``pair_products.launches`` counts kernel launches."""
    _check(grid, cinv_flat, swap, valid, pair_kl, f, e)
    if grid.device.type == "cpu":
        return pair_products_reference(grid, cinv_flat, swap, valid, pair_kl, f, e, chunk_points)
    if (f, e) not in KERNEL_SHAPES:
        raise ValueError(f"K3 is instantiated for (f, e) in {KERNEL_SHAPES}, not ({f}, {e})")
    p, npairs = grid.shape[0], pair_kl.shape[1]
    kp = grid.shape[1] // (f * e)
    out = torch.empty((p * npairs, f * f), dtype=grid.dtype, device=grid.device)
    if p == 0:
        return out
    # the tile: as many points as fit the shared-memory budget (their grid
    # rows, Y, C^-1 and pair flags, beside the pair table), at most 64;
    # 36 at venice-1778 shape in float32
    item = grid.element_size()
    per_point = (2 * kp * f * e + e * e) * item + npairs
    tile = min(64, max(1, (_SMEM_BUDGET - 8 * npairs) // per_point))
    lib, _ = build_kernels()
    fn = lib.skeres_pair_products_f32 if grid.dtype == torch.float32 else lib.skeres_pair_products_f64
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(grid.data_ptr(), cinv_flat.data_ptr(), swap.data_ptr(), valid.data_ptr(),
                 pair_kl.data_ptr(), out.data_ptr(), p, kp, npairs, f, e, tile, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    pair_products.launches += 1
    return out


pair_products.launches = 0
