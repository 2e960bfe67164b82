"""The Snavely reprojection residual with its closed-form 2 x 12 Jacobian
over a batch of observation rows, a hand-written CUDA kernel.

The batched form of ``models/reprojection.py:snavely_reprojection_error``
(Ceres's analytic ``CostFunction`` beside ``AutoDiffCostFunction``): per
row, camera ``(aa (3), t (3), f, k1, k2)`` and point ``X (3)`` gathered
from their tables by the row's slot indices,

    P = R(aa) X + t,   (x, y) = -(P0, P1) / P2,   r2 = x^2 + y^2,
    r = f (1 + r2 (k1 + k2 r2)) (x, y) - observation,

and ``J = dr / d(camera, point)`` (2 x 12, camera columns first), the
derivative of the port's own piecewise rotation
(``ops/rotation.py:angle_axis_rotate_point``): Rodrigues where
``theta^2 >= _SMALL``, else ``X + aa x X`` with its derivatives ``-[X]x``
in ``aa`` and ``I + [aa]x`` in ``X``. On the Rodrigues branch, with
``A = sin(theta)/theta``, ``B = (1 - cos(theta))/theta^2`` (taken as
``2 sin^2(theta/2)/theta^2``, which keeps its digits at small theta),
``C = (cos(theta) - A)/theta^2`` and ``D = (A - 2B)/theta^2``, a row
``g`` of ``dr/dP`` gives

    g dP/daa = (-A g.X + C g.(aa x X) + D (aa.X)(g.aa)) aa^T + A X x g
               + B ((g.aa) X + (aa.X) g),
    g dP/dX  = cos(theta) g + A g x aa + B (g.aa) aa.

:func:`snavely_rows` gives ``r`` and ``J`` (written into the caller's
outputs where given), :func:`snavely_costs` the per-row cost
``0.5 |r|^2``, the residual-only mode of the same kernel. The kernel is
``csrc/reprojection.cu`` (its header says what bounds it on the card),
built at first use by ``ops/build.py``. A CUDA tensor launches it or
raises; a CPU tensor takes the plain versions,
:func:`snavely_rows_reference` and :func:`snavely_costs_reference`, the
same formulas in PyTorch. ``snavely_rows.launches`` and
``snavely_costs.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from skeres_tpu_torch.ops.build import load_library
from skeres_tpu_torch.ops.rotation import _SMALL

__all__ = [
    "SNAVELY",
    "AnalyticRows",
    "build_kernels",
    "snavely_costs",
    "snavely_costs_reference",
    "snavely_rows",
    "snavely_rows_reference",
]


class AnalyticRows(NamedTuple):
    """A residual function's batched form with its closed-form Jacobian:
    ``rows(*tables, *indices, data, r=None, jac=None) -> (r, jac)`` and
    ``costs(*tables, *indices, data) -> (B,)``, each table and index in the
    function's slot order."""

    rows: Callable
    costs: Callable


@functools.lru_cache(maxsize=None)
def build_kernels():
    """Compile ``csrc/reprojection.cu`` (``ops/build.py``) and bind it.
    Returns ``(library, compiler_log)``."""
    lib, log = load_library("reprojection")
    p, n = ctypes.c_void_p, ctypes.c_long
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"skeres_snavely_{dt}")
        fn.argtypes = [p, p, p, p, p, n, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib, log


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _dot(a, b):
    return (a * b).sum(1)


def _project(cameras, points, cam, pt, obs):
    """The rows' residuals and what their Jacobian reuses."""
    c, x = cameras[cam], points[pt]
    aa, f, k1, k2 = c[:, 0:3], c[:, 6], c[:, 7], c[:, 8]
    theta2 = _dot(aa, aa)
    small = theta2 < _SMALL
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    w = aa * (1.0 / theta)[:, None]
    big = (cos_t[:, None] * x + sin_t[:, None] * _cross(w, x)
           + ((1.0 - cos_t) * _dot(w, x))[:, None] * w)
    p = torch.where(small[:, None], x + _cross(aa, x), big) + c[:, 3:6]
    xy = -p[:, 0:2] / p[:, 2:3]
    r2 = _dot(xy, xy)
    dist = 1.0 + r2 * (k1 + k2 * r2)
    r = (f * dist)[:, None] * xy - obs
    return r, (aa, x, f, k1, k2, theta, theta2, small, cos_t, sin_t, p, xy, r2, dist)


def snavely_costs_reference(cameras, points, cam, pt, obs):
    """Plain version of :func:`snavely_costs`."""
    r, _ = _project(cameras, points, cam, pt, obs)
    return 0.5 * _dot(r, r)


def snavely_rows_reference(cameras, points, cam, pt, obs):
    """Plain version of :func:`snavely_rows`: ``(r (B, 2), J (B, 2, 12))``."""
    r, (aa, x, f, k1, k2, theta, theta2, small, cos_t, sin_t, p, xy, r2, dist) = _project(
        cameras, points, cam, pt, obs)
    # d r / d(x, y), then d(x, y) / dP: the rows g of dr/dP
    dd = 2.0 * (k1 + 2.0 * k2 * r2)
    m00 = f * (dist + dd * xy[:, 0] * xy[:, 0])
    m01 = f * (dd * xy[:, 0] * xy[:, 1])
    m11 = f * (dist + dd * xy[:, 1] * xy[:, 1])
    inv_z = -1.0 / p[:, 2]
    g = [torch.stack([m00 * inv_z, m01 * inv_z, (m00 * xy[:, 0] + m01 * xy[:, 1]) * inv_z], 1),
         torch.stack([m01 * inv_z, m11 * inv_z, (m01 * xy[:, 0] + m11 * xy[:, 1]) * inv_z], 1)]
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    a = sin_t / theta
    b = 2.0 * torch.sin(0.5 * theta) ** 2 / t2
    c = (cos_t - a) / t2
    d = (a - 2.0 * b) / t2
    ax, ap = _cross(aa, x), _dot(aa, x)
    rows = []
    for i, gi in enumerate(g):
        ga = _dot(gi, aa)
        k = -a * _dot(gi, x) + c * _dot(gi, ax) + d * ap * ga
        d_aa = torch.where(small[:, None], _cross(x, gi),
                           k[:, None] * aa + a[:, None] * _cross(x, gi)
                           + b[:, None] * (ga[:, None] * x + ap[:, None] * gi))
        g_x = _cross(gi, aa)
        d_x = torch.where(small[:, None], gi + g_x,
                          cos_t[:, None] * gi + a[:, None] * g_x + (b * ga)[:, None] * aa)
        u = xy[:, i]
        rows.append(torch.cat([d_aa, gi, torch.stack([dist * u, f * r2 * u, f * r2 * r2 * u], 1),
                               d_x], dim=1))
    return r, torch.stack(rows, dim=1)


def _check(what, cameras, points, cam, pt, obs):
    """The checks both entries share: one float type (float32 or float64)
    and device, tables (nc, 9) and (np, 3) and observations (B, 2)
    contiguous, int64 (B,) indices."""
    dtype, dev = cameras.dtype, cameras.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64 tables, got {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (or its plain version on cpu), not {dev}")
    for name, t, width in (("cameras", cameras, 9), ("points", points, 3), ("obs", obs, 2)):
        if t.ndim != 2 or t.shape[1] != width:
            raise ValueError(f"{what} takes {name} (n, {width}), got {tuple(t.shape)}")
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what} takes {name} contiguous, {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    for name, x in (("cam", cam), ("pt", pt)):
        if (x.dtype != torch.int64 or x.device != dev or x.ndim != 1 or not x.is_contiguous()
                or x.shape[0] != obs.shape[0]):
            raise ValueError(f"{what} takes {name} contiguous int64 ({obs.shape[0]},) on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _out(what, out, shape, like):
    """The caller's output, checked, or a new one. The kernel stores a
    row's values 16 bytes at a time (8 for the float32 residual), so an
    output starts on such a boundary."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    align = min(16, shape[-1] * like.element_size()) if len(shape) == 2 else 16
    if (tuple(out.shape) != shape or out.dtype != like.dtype or out.device != like.device
            or not out.is_contiguous() or out.data_ptr() % align):
        raise ValueError(f"{what} takes an output {shape} contiguous {like.dtype} on "
                         f"{like.device}, {align}-byte aligned, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    return out


def _launch(what, cameras, points, cam, pt, obs, r=None, jac=None, cost=None):
    lib, _ = build_kernels()
    fn = lib.skeres_snavely_f32 if cameras.dtype == torch.float32 else lib.skeres_snavely_f64
    with torch.cuda.device(cameras.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cameras.data_ptr(), points.data_ptr(), cam.data_ptr(), pt.data_ptr(),
                 obs.data_ptr(), obs.shape[0], None if r is None else r.data_ptr(),
                 None if jac is None else jac.data_ptr(), None if cost is None else cost.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def snavely_rows(cameras, points, cam, pt, obs, r=None, jac=None):
    """Residuals ``r (B, 2)`` and Jacobians ``J (B, 2, 12)`` of the rows:
    row b observes point ``pt[b]`` (of ``points (np, 3)``) from camera
    ``cam[b]`` (of ``cameras (nc, 9)``) at ``obs[b]``. ``r`` and ``jac``,
    where given, are written in place (a chunk's rows of the evaluator's
    batch outputs) and returned; one launch on the card."""
    _check("snavely_rows", cameras, points, cam, pt, obs)
    b = obs.shape[0]
    r = _out("snavely_rows", r, (b, 2), cameras)
    jac = _out("snavely_rows", jac, (b, 2, 12), cameras)
    if cameras.device.type == "cpu":
        r_ref, jac_ref = snavely_rows_reference(cameras, points, cam, pt, obs)
        return r.copy_(r_ref), jac.copy_(jac_ref)
    if b:
        _launch("snavely_rows", cameras, points, cam, pt, obs, r=r, jac=jac)
        snavely_rows.launches += 1
    return r, jac


def snavely_costs(cameras, points, cam, pt, obs):
    """The rows' costs ``0.5 |r|^2`` (B,), as :func:`snavely_rows` takes
    its arguments: the residual-only mode, one launch on the card."""
    _check("snavely_costs", cameras, points, cam, pt, obs)
    if cameras.device.type == "cpu":
        return snavely_costs_reference(cameras, points, cam, pt, obs)
    cost = torch.empty((obs.shape[0],), dtype=cameras.dtype, device=cameras.device)
    if obs.shape[0]:
        _launch("snavely_costs", cameras, points, cam, pt, obs, cost=cost)
        snavely_costs.launches += 1
    return cost


snavely_rows.launches = 0
snavely_costs.launches = 0

# the form the evaluator takes for snavely_reprojection_error
SNAVELY = AnalyticRows(snavely_rows, snavely_costs)
