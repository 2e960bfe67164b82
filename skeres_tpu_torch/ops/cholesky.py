"""K1 and K2: dense Cholesky factors for the reduced camera system.

K1 is a hand-written CUDA kernel: the factor L and the explicit L^-1 of
one SPD matrix of up to 1024 rows. Counterpart of
``skeres_tpu/ops/pallas/cholesky.py`` (``_chol_inv_kernel`` through
``_chol_both_padded``, ``cholesky_inverse_factor`` and ``chol_solve``).
``SchurSolver`` factors the equilibrated reduced camera system with it on
every damped solve and on every jitter retry; returning L^-1 turns both
triangular solves into matrix-vector products.

K2 is the blocked factor past 1024 rows (``blocked_cholesky_factor`` /
``blocked_chol_solve``, counterparts of the JAX package's
``_blocked_factor_padded`` / ``_blocked_solve_padded``): a right-looking
factor over ``panel``-wide block columns, each diagonal panel factored
and inverted by K1, the panel scale as ``torch.matmul`` (full float32
unless the caller turns TF32 on), the trailing update by a kernel of its
own (``trailing_update_``: the lower triangle only, float32 as 3xTF32 on
the tensor cores), and a block substitution through the panels' inverses.

Both kernels are in ``csrc/cholesky.cu`` (its header says what bounds them
on the card and how the design answers that). It is compiled with ``nvcc``
for ``sm_90a`` at first use, from the sources in this checkout, into
``build/skeres_tpu_torch/`` keyed by a hash of the source and flags, and
bound through ``ctypes`` (``ops/build.py``). Nothing is compiled at import.

A CUDA tensor launches the kernel or raises. A CPU tensor takes the plain
PyTorch version beside it (``cholesky_both_reference``,
``trailing_update_reference_``; K2's panel loop runs the same on either
device), which the tests and ``chip_smoke.py`` also call by name to check
the kernels. ``blocked_cholesky_factor_reference`` is K2's plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from skeres_tpu_torch.ops.build import load_library

__all__ = [
    "BlockedCholFactor",
    "MAX_CHOLESKY_N",
    "PANEL",
    "blocked_chol_solve",
    "blocked_cholesky_factor",
    "blocked_cholesky_factor_reference",
    "build_kernels",
    "cholesky_both",
    "cholesky_both_reference",
    "cholesky_inverse_factor",
    "cholesky_inverse_factor_reference",
    "chol_solve",
    "trailing_update_",
    "trailing_update_reference_",
]

MAX_CHOLESKY_N = 1024  # K1's shared-memory copy of a block column; larger S is K2's


@functools.lru_cache(maxsize=None)
def build_kernels():
    """Compile ``csrc/cholesky.cu`` (``ops/build.py``) and bind it.
    Returns ``(library, compiler_log)``."""
    lib, log = load_library("cholesky")
    for name in ("skeres_chol_inv_f32", "skeres_chol_inv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("skeres_syrk_lower_f32", "skeres_syrk_lower_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, log


def _check(a: torch.Tensor, what: str = "K1", max_n=MAX_CHOLESKY_N) -> None:
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {a.dtype}")
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{what} takes one square matrix, got shape {tuple(a.shape)}")
    if a.shape[0] < 1 or (max_n is not None and a.shape[0] > max_n):
        raise ValueError(f"{what} takes 1 <= n <= {max_n}, got n = {a.shape[0]}")
    if not a.is_contiguous():
        raise ValueError(f"{what} takes a contiguous (row-major) matrix")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (or its plain version on cpu), not {a.device}")


def cholesky_both_reference(a: torch.Tensor):
    """Plain version of K1: ``(L, L^-1)`` by ``torch.linalg``, all NaN when
    the factorization fails."""
    l, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    failed = info != 0
    return (
        torch.where(failed, torch.full_like(l, float("nan")), l),
        torch.where(failed, torch.full_like(linv, float("nan")), linv),
    )


def cholesky_both(a: torch.Tensor):
    """``(L, L^-1)`` for SPD ``a = L L^T`` (lower). Only the lower triangle
    of ``a`` is read. On a failed factorization every output element is
    NaN. ``cholesky_both.launches`` counts kernel launches."""
    _check(a)
    if a.device.type == "cpu":
        return cholesky_both_reference(a)
    lib, _ = build_kernels()
    fn = lib.skeres_chol_inv_f32 if a.dtype == torch.float32 else lib.skeres_chol_inv_f64
    l = torch.empty_like(a)
    linv = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), l.data_ptr(), linv.data_ptr(), a.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    cholesky_both.launches += 1
    return l, linv


cholesky_both.launches = 0


def cholesky_inverse_factor(a: torch.Tensor) -> torch.Tensor:
    """``L^-1`` for SPD ``a = L L^T`` (lower), through K1."""
    return cholesky_both(a)[1]


def cholesky_inverse_factor_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cholesky_inverse_factor`."""
    return cholesky_both_reference(a)[1]


def chol_solve(linv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given ``linv = L^-1``: two matrix-vector products."""
    return linv.T @ (linv @ b)


# ---------------------------------------------------------------------------
# K2: blocked factor past K1's 1024 rows (venice-1778's S has 16,002).
# ---------------------------------------------------------------------------

PANEL = 512  # K2's panel width, the fastest of 128, 256 and 512 on the card (PERF.md)


def trailing_update_reference_(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`trailing_update_`, in the working dtype."""
    return c.sub_(torch.tril(p @ p.T))


def trailing_update_(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``C -= tril(P P^T)`` in place, for ``c`` (m x m, unit column stride,
    any row stride: a view into the factor) and ``p`` (m x w): the lower
    triangle of C is updated, its strict upper triangle is not touched.
    float32 runs 3xTF32 on the tensor cores (``wgmma``), float64 DMMA.
    ``trailing_update_.launches`` counts kernel launches."""
    m = p.shape[0]
    if c.dtype not in (torch.float32, torch.float64) or p.dtype != c.dtype:
        raise TypeError(f"the trailing update takes float32 or float64, got {c.dtype}, {p.dtype}")
    if c.ndim != 2 or p.ndim != 2 or tuple(c.shape) != (m, m) or m < 1 or p.shape[1] < 1:
        raise ValueError(f"the trailing update takes C m x m and P m x w, got "
                         f"{tuple(c.shape)} and {tuple(p.shape)}")
    if c.stride(1) != 1 or c.stride(0) < m:
        raise ValueError("the trailing update takes C with unit column stride")
    if c.device != p.device or c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the trailing update runs on cuda (or its plain version on cpu), "
                         f"got {c.device} and {p.device}")
    if c.device.type == "cpu":
        return trailing_update_reference_(c, p)
    vec = 16 // p.element_size()  # the kernel copies 16-byte rows of P
    w = p.shape[1]
    if not p.is_contiguous() or w % vec or p.data_ptr() % 16:
        padded = p.new_zeros(m, -(-w // vec) * vec)
        padded[:, :w] = p
        p = padded
    lib, _ = build_kernels()
    fn = lib.skeres_syrk_lower_f32 if c.dtype == torch.float32 else lib.skeres_syrk_lower_f64
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(p.data_ptr(), p.stride(0), m, p.shape[1], c.data_ptr(), c.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"trailing update launch failed: CUDA error {err}")
    trailing_update_.launches += 1
    return c


trailing_update_.launches = 0


class BlockedCholFactor:
    """K2's factorization of an n x n SPD matrix: ``l`` the lower factor
    (upper triangle zero), ``dinv`` the inverses of its diagonal panels,
    each ``panel`` wide except a shorter last one."""

    def __init__(self, l: torch.Tensor, dinv: List[torch.Tensor], panel: int):
        self.l = l
        self.dinv = dinv
        self.panel = panel

    @property
    def n(self) -> int:
        return self.l.shape[0]


def blocked_cholesky_factor(a: torch.Tensor, panel: int = PANEL, jitter=None) -> BlockedCholFactor:
    """Factor SPD ``a`` (only its lower triangle is read), or ``a + jitter
    I`` where ``jitter`` (a float or a 0-d tensor on ``a``'s device) is
    given: it is added to the diagonal of the copy the factor works in, so
    ``a`` is neither changed nor copied twice. A failed panel leaves it and
    every later panel NaN, and so every entry of a solve through the
    factor. On the card it launches K1 once a panel
    (``cholesky_both.launches``) and the trailing update once a panel but
    the last (``trailing_update_.launches``)."""
    _check(a, "K2", max_n=None)
    if panel < 1 or panel > MAX_CHOLESKY_N:
        raise ValueError(f"K2 takes 1 <= panel <= {MAX_CHOLESKY_N}, got {panel}")
    n = a.shape[0]
    l = a.clone()
    if jitter is not None:
        l.diagonal().add_(jitter)
    dinv = []
    for off in range(0, n, panel):
        end = min(off + panel, n)
        lkk, vkk = cholesky_both(l[off:end, off:end].contiguous())
        dinv.append(vkk)
        l[off:end, off:end] = lkk
        if end < n:
            pcol = l[end:, off:end] @ vkk.T
            l[end:, off:end] = pcol
            trailing_update_(l[end:, end:], pcol)
    return BlockedCholFactor(l.tril_(), dinv, panel)


def blocked_cholesky_factor_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the lower factor by ``torch.linalg``, all NaN
    when the factorization fails."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info != 0, torch.full_like(l, float("nan")), l)


def blocked_chol_solve(fac: BlockedCholFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` through a :class:`BlockedCholFactor` of A: forward
    then back block substitution, one matrix-vector product with a panel
    inverse per block."""
    l, p, n = fac.l, fac.panel, fac.n
    y = torch.empty_like(b)
    for i, vkk in enumerate(fac.dinv):
        off, end = i * p, min(i * p + p, n)
        rhs = b[off:end] if off == 0 else b[off:end] - l[off:end, :off] @ y[:off]
        y[off:end] = vkk @ rhs
    x = torch.empty_like(b)
    for i in reversed(range(len(fac.dinv))):
        off, end = i * p, min(i * p + p, n)
        rhs = y[off:end] if end == n else y[off:end] - l[end:, off:end].T @ x[end:]
        x[off:end] = fac.dinv[i].T @ rhs
    return x
