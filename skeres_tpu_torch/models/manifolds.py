"""Manifolds (local parameterizations) for constrained parameter blocks.

PyTorch counterpart of ``skeres_tpu/models/manifolds.py`` (reference
lineage: ``include/ceres/manifold.h``). The protocol is the same four
operations, ``plus``, ``minus``, ``plus_jacobian`` and ``minus_jacobian``.
Each works on the last axis and broadcasts over leading ones, so the
evaluator calls ``plus`` on ONE block inside ``torch.func.vmap`` (where it
differentiates ``residual(plus(x, delta))`` at ``delta = 0``) and on a
whole group's ``(n_blocks, size)`` array when it steps the state; the JAX
package ``vmap``s a one-block function for the latter.

Small-angle branches keep the double-``where`` guard of the JAX package:
no square root or division sees the masked value, so ``torch.func.jvp`` and
``vjp`` stay finite at ``delta = 0``. ``SubsetManifold`` keeps its 0/1 lift
matrix as a tensor per dtype and device, made on first use (before a CUDA
graph is captured: the device loop warms every branch up first).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from skeres_tpu_torch.ops import rotation as rot

__all__ = [
    "Manifold",
    "EuclideanManifold",
    "SubsetManifold",
    "QuaternionManifold",
    "EigenQuaternionManifold",
    "SphereManifold",
    "LineManifold",
    "AngleManifold",
    "ProductManifold",
]

_SMALL = 1e-12


class Manifold:
    """Protocol: a smooth (sub)manifold with a local exp/log map."""

    ambient_size: int
    tangent_size: int

    def plus(self, x, delta):
        """x (+) delta: ambient (..., n) x tangent (..., m) -> ambient (..., n)."""
        raise NotImplementedError

    def minus(self, y, x):
        """y (-) x: tangent (..., m) with plus(x, minus(y, x)) ~= y."""
        raise NotImplementedError

    def plus_jacobian(self, x):
        """d plus(x, delta) / d delta at delta = 0 -> (ambient, tangent)."""
        zero = torch.zeros(self.tangent_size, dtype=x.dtype, device=x.device)
        return torch.func.jacfwd(lambda d: self.plus(x, d))(zero)

    def minus_jacobian(self, x):
        """d minus(y, x) / d y at y = x -> (tangent, ambient)."""
        return torch.func.jacfwd(lambda y: self.minus(y, x))(x)


class EuclideanManifold(Manifold):
    """R^n with plus = +."""

    def __init__(self, size: int):
        self.ambient_size = int(size)
        self.tangent_size = int(size)

    def plus(self, x, delta):
        return x + delta

    def minus(self, y, x):
        return y - x

    def plus_jacobian(self, x):
        return torch.eye(self.ambient_size, dtype=x.dtype, device=x.device)

    def minus_jacobian(self, x):
        return torch.eye(self.ambient_size, dtype=x.dtype, device=x.device)


class SubsetManifold(Manifold):
    """Euclidean manifold with a subset of coordinates held constant."""

    def __init__(self, size: int, constant_indices):
        self.ambient_size = int(size)
        self.constant_indices = tuple(sorted(int(i) for i in constant_indices))
        self.free_indices = tuple(i for i in range(size) if i not in self.constant_indices)
        self.tangent_size = len(self.free_indices)
        lift = np.zeros((size, self.tangent_size))
        for col, row in enumerate(self.free_indices):
            lift[row, col] = 1.0
        self._lift_np = lift  # (ambient, tangent) 0/1 matrix
        self._lifts = {}  # (dtype, device) -> tensor

    def _lift(self, like):
        key = (like.dtype, like.device)
        if key not in self._lifts:
            self._lifts[key] = torch.as_tensor(self._lift_np, dtype=like.dtype,
                                               device=like.device)
        return self._lifts[key]

    def plus(self, x, delta):
        return x + delta @ self._lift(x).T

    def minus(self, y, x):
        return (y - x) @ self._lift(x)

    def plus_jacobian(self, x):
        return self._lift(x).clone()

    def minus_jacobian(self, x):
        return self._lift(x).T.clone()


def _quat_exp(delta):
    """Tangent (..., 3) -> unit quaternion [w,x,y,z]; |delta| is the half-angle."""
    n2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    small = n2 < _SMALL
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k = torch.where(small, 1.0 - n2 / 6.0, torch.sin(n) / n)
    w = torch.where(small, 1.0 - n2 / 2.0, torch.cos(n))
    return torch.cat([w, k * delta], dim=-1)


def _quat_log(q):
    """Unit quaternion [w,x,y,z] -> tangent (..., 3) (half-angle scaled axis)."""
    xyz = q[..., 1:]
    w = q[..., :1]
    s2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = s2 < _SMALL
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    angle = torch.atan2(s, w)
    k = torch.where(small, 1.0 / torch.where(small, w, torch.ones_like(w)), angle / s)
    return k * xyz


class QuaternionManifold(Manifold):
    """Unit quaternions, Ceres scalar-first [w,x,y,z] convention.

    plus(x, delta) = exp(delta) * x; minus(y, x) = log(y * conj(x)).
    """

    ambient_size = 4
    tangent_size = 3

    def plus(self, x, delta):
        return rot.quaternion_product(_quat_exp(delta), x)

    def minus(self, y, x):
        # no double-cover flip, as the reference's QuaternionManifold::Minus
        return _quat_log(rot.quaternion_product(y, rot.quaternion_conjugate(x)))


class EigenQuaternionManifold(Manifold):
    """Unit quaternions in Eigen [x,y,z,w] storage order."""

    ambient_size = 4
    tangent_size = 3

    def plus(self, x, delta):
        q = rot.eigen_quaternion_to_ceres(x)
        return rot.ceres_quaternion_to_eigen(rot.quaternion_product(_quat_exp(delta), q))

    def minus(self, y, x):
        qy = rot.eigen_quaternion_to_ceres(y)
        qx = rot.eigen_quaternion_to_ceres(x)
        return _quat_log(rot.quaternion_product(qy, rot.quaternion_conjugate(qx)))


def _householder(x):
    """Householder vector (v, beta) with (I - beta v v^T) x ~ mu * e_last
    (reference: ``internal/ceres/householder_vector.h``), guarded for
    tracing like the JAX package's."""
    sigma = torch.sum(x[..., :-1] * x[..., :-1], dim=-1)
    pivot = x[..., -1]
    mu = torch.sqrt(pivot * pivot + sigma)
    degenerate = sigma < _SMALL

    v_pivot_neg = pivot - mu
    v_pivot_pos = -sigma / torch.where(degenerate, torch.ones_like(pivot), pivot + mu)
    v_pivot = torch.where(pivot <= 0.0, v_pivot_neg, v_pivot_pos)
    v_pivot = torch.where(degenerate, torch.ones_like(v_pivot), v_pivot)

    beta = 2.0 * v_pivot * v_pivot / (sigma + v_pivot * v_pivot)
    beta = torch.where(degenerate,
                       torch.where(pivot >= 0.0, torch.zeros_like(beta),
                                   torch.full_like(beta, 2.0)),
                       beta)
    # only the head is divided by v_pivot; the last entry stays 1
    safe_pivot = torch.where(degenerate, torch.ones_like(v_pivot), v_pivot)
    head = x[..., :-1] / safe_pivot[..., None]
    head = torch.where(degenerate[..., None], torch.zeros_like(head), head)
    v = torch.cat([head, torch.ones_like(pivot)[..., None]], dim=-1)
    return v, beta


def _apply_householder(v, beta, y):
    return y - beta[..., None] * v * torch.sum(v * y, dim=-1, keepdim=True)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _sphere_exp(delta):
    """Tangent (..., m) -> the point (..., m + 1) of the unit sphere at
    angle |delta| from e_last."""
    n2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    small = n2 < _SMALL
    nd = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    sinc = torch.where(small, 1.0 - n2 / 6.0, torch.sin(nd) / nd)
    w = torch.where(small, 1.0 - n2 / 2.0, torch.cos(nd))
    return torch.cat([sinc * delta, w], dim=-1)


def _sphere_log(hy):
    """The inverse of :func:`_sphere_exp` for a unit vector ``hy``."""
    head, last = hy[..., :-1], hy[..., -1:]
    hn2 = torch.sum(head * head, dim=-1, keepdim=True)
    small = hn2 < _SMALL
    hn = torch.sqrt(torch.where(small, torch.ones_like(hn2), hn2))
    angle = torch.atan2(hn, last)
    k = torch.where(small, 1.0 / torch.where(small, last, torch.ones_like(last)), angle / hn)
    return k * head


class SphereManifold(Manifold):
    """The (n-1)-sphere of radius ||x|| embedded in R^n (n >= 2); the
    tangent basis comes from the Householder reflection taking x to
    ||x|| e_n."""

    def __init__(self, size: int):
        assert size >= 2
        self.ambient_size = int(size)
        self.tangent_size = int(size) - 1

    def plus(self, x, delta):
        v, beta = _householder(x)
        return _norm(x) * _apply_householder(v, beta, _sphere_exp(delta))

    def minus(self, y, x):
        v, beta = _householder(x)
        return _sphere_log(_apply_householder(v, beta, y) / _norm(y))


class LineManifold(Manifold):
    """A line in R^n as (origin, direction): ambient 2n, tangent 2(n-1).
    The origin moves within the hyperplane orthogonal to the direction
    (through the Householder basis that maps the direction to ||d|| e_n),
    the direction on the sphere as SphereManifold."""

    def __init__(self, size: int):
        assert size >= 2
        self.line_dim = int(size)
        self.ambient_size = 2 * int(size)
        self.tangent_size = 2 * (int(size) - 1)

    def plus(self, x, delta):
        n = self.line_dim
        origin, direction = x[..., :n], x[..., n:]
        d_origin, d_dir = delta[..., : n - 1], delta[..., n - 1:]
        v, beta = _householder(direction)
        r = _norm(direction)
        y_o = torch.cat([d_origin, torch.zeros_like(d_origin[..., :1])], dim=-1)
        origin_plus = origin + r * _apply_householder(v, beta, y_o)
        dir_plus = r * _apply_householder(v, beta, _sphere_exp(d_dir))
        return torch.cat([origin_plus, dir_plus], dim=-1)

    def minus(self, y, x):
        n = self.line_dim
        origin_y, dir_y = y[..., :n], y[..., n:]
        origin_x, dir_x = x[..., :n], x[..., n:]
        v, beta = _householder(dir_x)
        h_o = _apply_householder(v, beta, (origin_y - origin_x) / _norm(dir_x))
        d_dir = _sphere_log(_apply_householder(v, beta, dir_y) / _norm(dir_y))
        return torch.cat([h_o[..., :-1], d_dir], dim=-1)


class AngleManifold(Manifold):
    """SO(2) as a single angle, wrapped to (-pi, pi] (the 2-D pose-graph
    example's angle parameterization)."""

    ambient_size = 1
    tangent_size = 1

    @staticmethod
    def normalize(a):
        return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))

    def plus(self, x, delta):
        return self.normalize(x + delta)

    def minus(self, y, x):
        return self.normalize(y - x)


class ProductManifold(Manifold):
    """Cartesian product of manifolds over contiguous coordinate spans."""

    def __init__(self, *manifolds: Manifold):
        self.manifolds = tuple(manifolds)
        self.ambient_size = sum(m.ambient_size for m in manifolds)
        self.tangent_size = sum(m.tangent_size for m in manifolds)

    def _spans(self):
        a = t = 0
        for m in self.manifolds:
            yield m, a, t
            a += m.ambient_size
            t += m.tangent_size

    def plus(self, x, delta):
        return torch.cat([
            m.plus(x[..., a : a + m.ambient_size], delta[..., t : t + m.tangent_size])
            for m, a, t in self._spans()
        ], dim=-1)

    def minus(self, y, x):
        return torch.cat([
            m.minus(y[..., a : a + m.ambient_size], x[..., a : a + m.ambient_size])
            for m, a, t in self._spans()
        ], dim=-1)
