"""SO(3) and quaternion rotations, differentiable with ``torch.func``.

PyTorch counterpart of ``skeres_tpu/ops/rotation.py`` (reference lineage:
``include/ceres/rotation.h``), all thirteen of its functions. Every function works on the last axis and broadcasts over
leading axes, so it runs on one block under ``torch.func.vmap`` and on a
whole batch alike. Small-angle branches keep the double-``where`` guard:
the square root never sees the masked value, so ``vjp``/``jvp`` stay
finite at theta == 0.

Quaternions are scalar-first ``[w, x, y, z]`` (the Ceres order) unless the
function name says ``eigen`` (``[x, y, z, w]``, scalar last).
"""

from __future__ import annotations

import torch

__all__ = [
    "angle_axis_to_quaternion",
    "quaternion_to_angle_axis",
    "quaternion_product",
    "quaternion_conjugate",
    "unit_quaternion_rotate_point",
    "quaternion_rotate_point",
    "angle_axis_rotate_point",
    "quaternion_to_rotation_matrix",
    "rotation_matrix_to_quaternion",
    "angle_axis_to_rotation_matrix",
    "rotation_matrix_to_angle_axis",
    "eigen_quaternion_to_ceres",
    "ceres_quaternion_to_eigen",
]

_SMALL = 1e-12  # threshold on theta^2 below which Taylor branches engage


def _safe_sqrt(x2, use_taylor):
    """sqrt(x2) that has a finite derivative on the Taylor branch."""
    return torch.sqrt(torch.where(use_taylor, torch.ones_like(x2), x2))


def angle_axis_to_quaternion(aa):
    """Angle-axis (…,3) -> unit quaternion (…,4), scalar-first:
    q = [cos(theta/2), sin(theta/2)/theta * aa]."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < _SMALL
    theta = _safe_sqrt(theta2, small)
    half = 0.5 * theta
    # sin(theta/2)/theta; Taylor: 1/2 - theta^2/48
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * aa], dim=-1)


def quaternion_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quaternion_product(a, b):
    """Hamilton product, scalar-first (z = a * b)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def unit_quaternion_rotate_point(q, p):
    """Rotate point(s) p (…,3) by the unit quaternion q (…,4), scalar-first,
    in the expanded form p + w t + q.xyz x t with t = 2 q.xyz x p."""
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    tx = 2.0 * (y * pz - z * py)
    ty = 2.0 * (z * px - x * pz)
    tz = 2.0 * (x * py - y * px)
    rx = px + w * tx + (y * tz - z * ty)
    ry = py + w * ty + (z * tx - x * tz)
    rz = pz + w * tz + (x * ty - y * tx)
    return torch.cat([rx, ry, rz], dim=-1)


def quaternion_rotate_point(q, p):
    """Rotate by a quaternion that need not be unit (normalized first)."""
    scale = 1.0 / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return unit_quaternion_rotate_point(scale * q, p)


def angle_axis_rotate_point(aa, p):
    """Rodrigues rotation of p (…,3) by angle-axis aa (…,3), finite
    derivatives at 0."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < _SMALL
    theta = _safe_sqrt(theta2, small)
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    inv_theta = 1.0 / torch.where(small, torch.ones_like(theta), theta)
    w = aa * inv_theta  # unit axis (garbage on the small branch; masked below)

    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    cx = wy * pz - wz * py
    cy = wz * px - wx * pz
    cz = wx * py - wy * px
    dot = wx * px + wy * py + wz * pz
    big = torch.cat(
        [
            cos_t * px + sin_t * cx + (1.0 - cos_t) * dot * wx,
            cos_t * py + sin_t * cy + (1.0 - cos_t) * dot * wy,
            cos_t * pz + sin_t * cz + (1.0 - cos_t) * dot * wz,
        ],
        dim=-1,
    )
    # small angle: p + cross(aa, p)  (first-order Rodrigues)
    ax, ay, az = aa[..., 0:1], aa[..., 1:2], aa[..., 2:3]
    small_val = p + torch.cat(
        [ay * pz - az * py, az * px - ax * pz, ax * py - ay * px], dim=-1
    )
    return torch.where(small, small_val, big)


def quaternion_to_angle_axis(q):
    """Unit quaternion (…,4) scalar-first -> angle-axis (…,3)."""
    w = q[..., :1]
    xyz = q[..., 1:]
    sin2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    small = sin2 < _SMALL
    sin_theta = _safe_sqrt(sin2, small)
    # atan2 handles w < 0 (angle > pi)
    theta = 2.0 * torch.atan2(sin_theta, w)
    # k = theta / sin(theta/2); Taylor about sin -> 0: k -> 2/w
    k = torch.where(
        small, 2.0 / torch.where(small, w, torch.ones_like(w)), theta / sin_theta
    )
    return k * xyz


def quaternion_to_rotation_matrix(q):
    """Unit quaternion (…,4) scalar-first -> rotation matrix (…,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotation_matrix_to_quaternion(r):
    """Rotation matrix (…,3,3) -> unit quaternion (…,4) scalar-first.

    Branchless Shepperd form: all four candidate quaternions are computed
    and the one keyed by the largest diagonal combination is selected."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def _q(t, a, b, c, order):
        s = torch.sqrt(torch.clamp(t, min=1e-30))
        half = 0.5 / s
        comps = {"t": 0.5 * s, "a": a * half, "b": b * half, "c": c * half}
        return torch.stack([comps[k] for k in order], dim=-1)

    qw = _q(tw, m21 - m12, m02 - m20, m10 - m01, ("t", "a", "b", "c"))
    qx = _q(tx, m21 - m12, m01 + m10, m02 + m20, ("a", "t", "b", "c"))
    qy = _q(ty, m02 - m20, m01 + m10, m12 + m21, ("a", "b", "t", "c"))
    qz = _q(tz, m10 - m01, m20 + m02, m21 + m12, ("a", "b", "c", "t"))

    idx = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    q_all = torch.stack([qw, qx, qy, qz], dim=-2)  # (…, 4 candidates, 4)
    index = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(q_all, -2, index)[..., 0, :]
    # canonical sign: w >= 0
    return torch.where(q[..., :1] < 0, -q, q)


def angle_axis_to_rotation_matrix(aa):
    return quaternion_to_rotation_matrix(angle_axis_to_quaternion(aa))


def rotation_matrix_to_angle_axis(r):
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(r))


def eigen_quaternion_to_ceres(q_xyzw):
    """[x,y,z,w] -> [w,x,y,z]."""
    return torch.cat([q_xyzw[..., 3:4], q_xyzw[..., :3]], dim=-1)


def ceres_quaternion_to_eigen(q_wxyz):
    """[w,x,y,z] -> [x,y,z,w]."""
    return torch.cat([q_wxyz[..., 1:4], q_wxyz[..., :1]], dim=-1)
