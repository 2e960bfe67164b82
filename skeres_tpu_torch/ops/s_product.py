"""The implicit Schur-complement product's two passes over a camera-padded
observation batch, a hand-written CUDA kernel pair, and the camera blocks
of S from the same placed rows, a third kernel.

``S v = (F^T F + D_f) v - W C^-1 W^T v`` on a batch whose rows hold one
camera block F (m x t) and one point block E (m x e) each:

- :func:`point_sums`, the point pass: per point p the sum over its rows,
  in row order, of ``E^T (F v_cam)``; with ``cinv`` it returns
  ``C_p^-1`` times that, and with ``s_e`` that scaled by ``s_e`` (``wc``
  as the camera pass reads it). The rows are the batch's in row order,
  grouped by point through ``seg`` (offsets, (n_pts + 1,)) and, where the
  rows are not in point order, ``perm`` (a permutation sorted by point);
- :func:`camera_sums`, the camera pass: per camera c the sum over its
  placed rows of ``F^T (F (s_f v_c) - E wc[p])``, scaled by ``s_f``;
- :func:`camera_blocks`, the camera blocks: per camera c the sum over its
  placed rows of ``F^T (I - E (s_e C_p^-1 s_e) E^T) F`` (``F^T F`` alone
  without ``cinv``), the diagonal blocks of S before the caller's ``s_f``.

The kernels are ``csrc/s_product.cu`` (its header says what bounds them on
the card: the bytes of the two passes), built at first use by
``ops/build.py``. A CUDA tensor launches them or raises; a CPU tensor takes
the plain versions, :func:`point_sums_reference`,
:func:`camera_sums_reference` and :func:`camera_blocks_reference`, the
port's PyTorch code before the kernels: row products as a multiply and a
sum, segment sums by point, batched products of the per-row blocks, the
camera sums a reshape and a sum. ``point_sums.launches``,
``camera_sums.launches`` and ``camera_blocks.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from skeres_tpu_torch.ops.build import load_library

__all__ = [
    "MAX_SIZES",
    "PADDED_BLOCK_BYTES",
    "build_kernels",
    "camera_blocks",
    "camera_blocks_reference",
    "camera_sums",
    "camera_sums_reference",
    "point_sums",
    "point_sums_reference",
    "rows_apply",
    "rows_apply_t",
]

MAX_SIZES = (4, 16, 4)  # the most (m, t, e) the kernels take
# the most bytes of per-row (t, t) products that the plain camera blocks hold
# at once (three such tensors live at a time)
PADDED_BLOCK_BYTES = 4 << 30


def rows_apply(mat, v):
    """Per-row product ``mat (B, m, t) @ v (B, t) -> (B, m)`` of the
    observation rows (m = 2), as a multiply and a sum: ``torch.einsum``
    lowers it to a batched product of 2 x t matrices, 5-18x slower on an
    NVIDIA H100 80GB HBM3 (700 W) at 5M rows (``chip_smoke.py`` phase 18
    times both)."""
    return (mat * v[:, None, :]).sum(-1)


def rows_apply_t(mat, u):
    """Per-row transposed product ``mat (B, m, t)^T @ u (B, m) -> (B, t)``."""
    return (mat * u[:, :, None]).sum(1)


@functools.lru_cache(maxsize=None)
def build_kernels():
    """Compile ``csrc/s_product.cu`` (``ops/build.py``) and bind it.
    Returns ``(library, compiler_log)``."""
    lib, log = load_library("s_product")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for dt in ("f32", "f64"):
        point = getattr(lib, f"skeres_s_point_{dt}")
        point.argtypes = [p, n, i, i, i, i, i, p, p, p, p, n, p, p, p, i, p]
        point.restype = ctypes.c_int
        camera = getattr(lib, f"skeres_s_camera_{dt}")
        camera.argtypes = [p, n, i, i, i, i, i, p, p, n, n, p, p, p, n, i, p, p]
        camera.restype = ctypes.c_int
        blocks = getattr(lib, f"skeres_s_blocks_{dt}")
        blocks.argtypes = [p, n, i, i, i, i, i, p, p, n, n, p, p, p, p]
        blocks.restype = ctypes.c_int
    return lib, log


def _split(rows, f_first: bool, t: int):
    """The F (n, m, t) and E (n, m, e) columns of rows (n, m, t + e)."""
    e = rows.shape[2] - t
    return (rows[:, :, :t], rows[:, :, t:]) if f_first else (rows[:, :, e:], rows[:, :, :e])


def _check(what, rows, t, floats, indices):
    """The checks the kernels share: float32 or float64 of one dtype, int64
    indices, one device, rows (n, m, t + e) whose values a row are
    contiguous, and (m, t, e) within ``MAX_SIZES``."""
    dtype, dev = rows.dtype, rows.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64 rows, got {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (or its plain version on cpu), not {dev}")
    if rows.ndim != 3 or rows.shape[2] <= t:
        raise ValueError(f"{what} takes rows (n, m, t + e) of t = {t} camera columns, got "
                         f"{tuple(rows.shape)}")
    m = rows.shape[1]
    e = rows.shape[2] - t
    if rows.stride(2) != 1 or rows.stride(1) != rows.shape[2]:
        raise ValueError(f"{what} takes rows whose m x (t + e) values are contiguous, got strides "
                         f"{rows.stride()}")
    if m > MAX_SIZES[0] or t > MAX_SIZES[1] or e > MAX_SIZES[2]:
        raise ValueError(f"{what} takes (m, t, e) up to {MAX_SIZES}, got {(m, t, e)}")
    for name, x in floats.items():
        if x is not None and (x.dtype != dtype or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{what} takes {name} contiguous, {dtype} on {dev}, got "
                             f"{x.dtype} on {x.device}")
    for name, x in indices.items():
        if x is not None and (x.dtype != torch.int64 or x.device != dev or x.ndim != 1
                              or not x.is_contiguous()):
            raise ValueError(f"{what} takes {name} contiguous int64 (n,) on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return m, t, e


def _camera_table(what, v_cam) -> int:
    """The columns t of a camera table (n_cams, t)."""
    if v_cam.ndim != 2:
        raise ValueError(f"{what} takes a camera table (n_cams, t), got {tuple(v_cam.shape)}")
    return v_cam.shape[1]


def _vec(rows) -> int:
    """The widest load (16 or 8 bytes) to which every row of ``rows`` is
    aligned, else the element size."""
    item = rows.element_size()
    for width in (16, 8):
        if width > item and all(x % width == 0 for x in (
                rows.data_ptr(), rows.stride(0) * item, rows.shape[1] * rows.shape[2] * item)):
            return width
    return item


def point_sums_reference(rows, f_first: bool, cam, v_cam, seg, perm=None, cinv=None, s_e=None):
    """Plain version of :func:`point_sums`."""
    F, E = _split(rows, f_first, v_cam.shape[1])
    vals = rows_apply_t(E, rows_apply(F, v_cam[cam]))
    if perm is not None:
        vals = vals[perm]
    sums = torch.segment_reduce(vals, "sum", offsets=seg)
    if cinv is not None:
        sums = torch.einsum("pef,pf->pe", cinv, sums)
    return sums if s_e is None else sums * s_e


def point_sums(rows, f_first: bool, cam, v_cam, seg, perm=None, cinv=None, s_e=None):
    """The point pass: ``(n_pts, e)``, per point p
    ``s_e,p C_p^-1 sum_r E_r^T (F_r v_cam[cam_r])`` over its rows r, in
    row order (``cinv``, ``s_e``: each left out where None).

    ``rows`` (B, m, t + e): the batch's rows, F first where ``f_first``;
    ``cam`` (B,) int64 the camera of each row; ``v_cam`` (n_cams, t);
    ``seg`` (n_pts + 1,) int64: point p's rows are ``seg[p]:seg[p+1]`` of
    the rows in ``perm`` order ((B,) int64, or None for row order);
    ``cinv`` (n_pts, e, e); ``s_e`` (n_pts, e). On the card the result is a
    view of an (n_pts, 4) table where e = 3, so that the camera pass
    gathers a point's values in one aligned load."""
    m, t, e = _check("point_sums", rows, _camera_table("point_sums", v_cam),
                     {"v_cam": v_cam, "cinv": cinv, "s_e": s_e},
                     {"cam": cam, "seg": seg, "perm": perm})
    n_pts = seg.shape[0] - 1
    if cinv is not None and tuple(cinv.shape) != (n_pts, e, e):
        raise ValueError(f"point_sums takes cinv ({n_pts}, {e}, {e}), got {tuple(cinv.shape)}")
    if s_e is not None and tuple(s_e.shape) != (n_pts, e):
        raise ValueError(f"point_sums takes s_e ({n_pts}, {e}), got {tuple(s_e.shape)}")
    if cam.shape[0] != rows.shape[0] or (perm is not None and perm.shape[0] != rows.shape[0]):
        raise ValueError("point_sums takes cam and perm of one entry a row")
    if rows.device.type == "cpu":
        return point_sums_reference(rows, f_first, cam, v_cam, seg, perm, cinv, s_e)
    ldo = 4 if e == 3 else e
    out = torch.empty((n_pts, ldo), dtype=rows.dtype, device=rows.device)
    lib, _ = build_kernels()
    fn = lib.skeres_s_point_f32 if rows.dtype == torch.float32 else lib.skeres_s_point_f64
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), rows.stride(0), _vec(rows), m, t, e, int(f_first),
                 cam.data_ptr(), v_cam.data_ptr(), seg.data_ptr(),
                 None if perm is None else perm.data_ptr(), n_pts,
                 None if cinv is None else cinv.data_ptr(),
                 None if s_e is None else s_e.data_ptr(), out.data_ptr(), ldo, stream)
    if err != 0:
        raise RuntimeError(f"point_sums launch failed: CUDA error {err}")
    point_sums.launches += 1
    return out[:, :e]


def camera_sums_reference(placed, f_first: bool, pidx, counts, v_cam, wc, s_f=None):
    """Plain version of :func:`camera_sums` (it reads every placed row;
    the unused slots' zero rows add nothing)."""
    nc, t = v_cam.shape
    K = placed.shape[0] // nc
    m = placed.shape[1]
    F, E = _split(placed, f_first, t)
    v_in = v_cam if s_f is None else v_cam * s_f
    fv = ((F.view(nc, K, m, t) * v_in[:, None, None, :]).sum(-1).view(nc * K, m)
          - rows_apply(E, wc[pidx]))
    red = rows_apply_t(F, fv).reshape(nc, K, t).sum(1)
    return red if s_f is None else red * s_f


def camera_sums(placed, f_first: bool, pidx, counts, v_cam, wc, s_f=None):
    """The camera pass: ``(n_cams, t)``, per camera c
    ``s_f,c sum_r F_r^T (F_r (s_f,c v_c) - E_r wc[pidx_r])``
    over its placed rows r (``s_f``: left out where None).

    ``placed`` (n_cams * K, m, t + e): camera c's rows at
    ``c*K : c*K + counts[c]``, zero rows after them (which the kernel
    skips); ``pidx`` (n_cams * K,) int64 the point of each placed row;
    ``counts`` (n_cams,) int64; ``v_cam``, ``s_f`` (n_cams, t); ``wc``
    (n_pts, e), its rows any stride (:func:`point_sums` gives 4 for e = 3)."""
    m, t, e = _check("camera_sums", placed, _camera_table("camera_sums", v_cam),
                     {"v_cam": v_cam, "s_f": s_f}, {"pidx": pidx, "counts": counts})
    nc = v_cam.shape[0]
    if nc == 0 or placed.shape[0] % nc or pidx.shape[0] != placed.shape[0]:
        raise ValueError(f"camera_sums takes placed rows and pidx of n_cams * K rows, got "
                         f"{placed.shape[0]} and {pidx.shape[0]} for {nc} cameras")
    if counts.shape[0] != nc:
        raise ValueError(f"camera_sums takes counts ({nc},), got {tuple(counts.shape)}")
    if s_f is not None and s_f.shape != v_cam.shape:
        raise ValueError(f"camera_sums takes s_f {tuple(v_cam.shape)}, got {tuple(s_f.shape)}")
    if (wc.ndim != 2 or wc.shape[1] != e or wc.stride(1) != 1 or wc.dtype != placed.dtype
            or wc.device != placed.device):
        raise ValueError(f"camera_sums takes wc (n_pts, {e}) {placed.dtype} with unit column "
                         f"stride, got {tuple(wc.shape)} {wc.dtype} strides {wc.stride()}")
    if placed.device.type == "cpu":
        return camera_sums_reference(placed, f_first, pidx, counts, v_cam, wc, s_f)
    out = torch.empty((nc, t), dtype=placed.dtype, device=placed.device)
    ldw = wc.stride(0)
    wvec = int(e == 3 and ldw == 4 and wc.data_ptr() % (4 * wc.element_size()) == 0)
    lib, _ = build_kernels()
    fn = lib.skeres_s_camera_f32 if placed.dtype == torch.float32 else lib.skeres_s_camera_f64
    with torch.cuda.device(placed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(placed.data_ptr(), placed.stride(0), _vec(placed), m, t, e, int(f_first),
                 pidx.data_ptr(), counts.data_ptr(), nc, placed.shape[0] // nc,
                 v_cam.data_ptr(), None if s_f is None else s_f.data_ptr(), wc.data_ptr(), ldw,
                 wvec, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"camera_sums launch failed: CUDA error {err}")
    camera_sums.launches += 1
    return out


def camera_blocks_reference(placed, f_first: bool, pidx, counts, t: int, cinv=None, s_e=None):
    """Plain version of :func:`camera_blocks`: the per-row ``(t, t)``
    products ``F^T F - A (s_e C^-1 s_e) A^T`` (``A = F^T E``) as batched
    products, taken for whole cameras at a time, at most
    ``PADDED_BLOCK_BYTES`` of them a pass (one pass where they fit), each
    pass summed by camera as a reshape and a sum (it reads every placed row;
    the unused slots' zero rows add nothing)."""
    nc = counts.shape[0]
    K = placed.shape[0] // nc
    F, E = _split(placed, f_first, t)
    if cinv is not None and s_e is not None:
        cinv = cinv * s_e[:, :, None] * s_e[:, None, :]
    per_cam = K * t * t * F.element_size()
    step = max(1, min(nc, PADDED_BLOCK_BYTES // max(per_cam, 1)))
    parts = []
    for c0 in range(0, nc, step):
        rows = slice(c0 * K, min(nc, c0 + step) * K)
        f_rows = F[rows]
        ftf = torch.einsum("bmf,bmg->bfg", f_rows, f_rows)
        if cinv is not None:
            a = torch.einsum("bmf,bme->bfe", f_rows, E[rows])
            y = torch.bmm(a, cinv[pidx[rows]])
            ftf = ftf - torch.bmm(y, a.transpose(1, 2))
            del a, y
        parts.append(ftf.reshape(-1, K, t, t).sum(1))
        del ftf
    return torch.cat(parts)


def camera_blocks(placed, f_first: bool, pidx, counts, t: int, cinv=None, s_e=None):
    """The camera blocks: ``(n_cams, t, t)``, per camera c
    ``sum_r F_r^T (I - E_r (s_e,p C_p^-1 s_e,p) E_r^T) F_r`` over its placed
    rows r of point p = ``pidx[r]`` (``F^T F`` alone where ``cinv`` is None;
    ``s_e``: left out where None). ``C_p^-1`` is read as the symmetric
    matrix it is, and each block is written symmetric.

    ``placed`` (n_cams * K, m, t + e), ``pidx`` and ``counts`` as
    :func:`camera_sums` takes them; ``t`` the camera columns; ``cinv``
    (n_pts, e, e); ``s_e`` (n_pts, e), only with ``cinv``."""
    m, t, e = _check("camera_blocks", placed, t, {"cinv": cinv, "s_e": s_e},
                     {"pidx": pidx, "counts": counts})
    nc = counts.shape[0]
    if nc == 0 or placed.shape[0] % nc or pidx.shape[0] != placed.shape[0]:
        raise ValueError(f"camera_blocks takes placed rows and pidx of n_cams * K rows, got "
                         f"{placed.shape[0]} and {pidx.shape[0]} for {nc} cameras")
    if s_e is not None and cinv is None:
        raise ValueError("camera_blocks takes s_e only with cinv, which it scales")
    if cinv is not None and (cinv.ndim != 3 or tuple(cinv.shape[1:]) != (e, e)):
        raise ValueError(f"camera_blocks takes cinv (n_pts, {e}, {e}), got {tuple(cinv.shape)}")
    if s_e is not None and tuple(s_e.shape) != (cinv.shape[0], e):
        raise ValueError(f"camera_blocks takes s_e ({cinv.shape[0]}, {e}), got "
                         f"{tuple(s_e.shape)}")
    if placed.device.type == "cpu":
        return camera_blocks_reference(placed, f_first, pidx, counts, t, cinv, s_e)
    out = torch.empty((nc, t, t), dtype=placed.dtype, device=placed.device)
    lib, _ = build_kernels()
    fn = lib.skeres_s_blocks_f32 if placed.dtype == torch.float32 else lib.skeres_s_blocks_f64
    with torch.cuda.device(placed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(placed.data_ptr(), placed.stride(0), _vec(placed), m, t, e, int(f_first),
                 pidx.data_ptr(), counts.data_ptr(), nc, placed.shape[0] // nc,
                 None if cinv is None else cinv.data_ptr(),
                 None if s_e is None else s_e.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"camera_blocks launch failed: CUDA error {err}")
    camera_blocks.launches += 1
    return out


point_sums.launches = 0
camera_sums.launches = 0
camera_blocks.launches = 0
