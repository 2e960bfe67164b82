"""Differentiable cubic interpolation of sampled grids.

PyTorch counterpart of ``skeres_tpu/ops/interpolation.py`` (reference
lineage: ``include/ceres/cubic_interpolation.h``): Catmull-Rom cubic
Hermite interpolation over uniformly sampled 1-D and 2-D grids, usable
inside residual functions under ``torch.func`` (the derivatives flow
through the cubic weights; the floor and the clipped indices carry none).
Out-of-range samples take the edge value, as the reference's
Grid1D/Grid2D. The floor and the index arithmetic run on the device of
the query.
"""

from __future__ import annotations

import torch

__all__ = ["CubicInterpolator", "BiCubicInterpolator"]


def _cubic_hermite(p0, p1, p2, p3, x):
    """The Catmull-Rom spline at x in [0, 1] through 4 samples, with the
    reference's CubicHermiteSpline coefficients:
      a = -0.5 p0 + 1.5 p1 - 1.5 p2 + 0.5 p3
      b =      p0 - 2.5 p1 + 2.0 p2 - 0.5 p3
      c = -0.5 p0          + 0.5 p2
      d =              p1
    """
    a = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    b = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    c = -0.5 * p0 + 0.5 * p2
    return p1 + x * (c + x * (b + x * a))


def _frac_at(x, n: int):
    """(floor of x clipped to [0, n - 1] as an index, x minus it)."""
    xi = torch.clamp(torch.floor(x), 0.0, n - 1.0)
    return xi.to(torch.int64), x - xi


def _take(values, index):
    """``values[index]`` along the first axis for an integer tensor index
    of any shape, a gather that also runs under ``torch.func.vmap`` (where
    indexing by a 0-d tensor would read it on the host)."""
    out = values.index_select(0, index.reshape(-1))
    return out.reshape(index.shape + values.shape[1:])


def _on_device(interp, device):
    """The grid's samples on ``device``, moved there once on first use."""
    if interp.values.device != device:
        interp.values = interp.values.to(device)
    return interp.values


class CubicInterpolator:
    """f(x) for x in [0, n-1] over samples (n,) or (n, k) (vector-valued)."""

    def __init__(self, values):
        self.values = torch.as_tensor(values)
        self.n = self.values.shape[0]

    def evaluate(self, x):
        n = self.n
        i, frac = _frac_at(x, n)
        values = _on_device(self, frac.device)

        def at(j):
            return _take(values, torch.clamp(j, 0, n - 1))

        return _cubic_hermite(at(i - 1), at(i), at(i + 1), at(i + 2), frac)

    __call__ = evaluate


class BiCubicInterpolator:
    """f(r, c) over a (rows, cols) or (rows, cols, k) grid."""

    def __init__(self, values):
        self.values = torch.as_tensor(values)
        self.rows = self.values.shape[0]
        self.cols = self.values.shape[1]

    def evaluate(self, r, c):
        rows, cols = self.rows, self.cols
        i, fr = _frac_at(r, rows)
        j, fc = _frac_at(c, cols)
        flat = _on_device(self, fr.device).flatten(0, 1)

        def at(a, b):
            return _take(flat, torch.clamp(a, 0, rows - 1) * cols + torch.clamp(b, 0, cols - 1))

        # along the columns for 4 neighbouring rows, then along the rows
        rows_interp = [
            _cubic_hermite(at(i + di, j - 1), at(i + di, j), at(i + di, j + 1),
                           at(i + di, j + 2), fc)
            for di in (-1, 0, 1, 2)
        ]
        return _cubic_hermite(*rows_interp, fr)

    __call__ = evaluate
