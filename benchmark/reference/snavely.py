"""The Snavely camera model of the BAL dataset, written out in plain torch.

A camera is 9 numbers: angle-axis rotation (3), translation (3), focal
length, radial distortion k1, k2. A point X is seen at

    p = R(aa) X + t,   (x, y) = -(p_x, p_y) / p_z,
    pixel = f (1 + k1 r^2 + k2 r^4) (x, y),   r^2 = x^2 + y^2,

the convention of ``bundle_adjuster.cc``'s ``SnavelyReprojectionError``
(the camera looks down its -z axis). Every function takes batches of
rows; nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["angle_axis_rotate", "project", "rotation_matrix_to_angle_axis"]


def angle_axis_rotate(aa: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate the rows of ``x`` (B, 3) by the angle-axis rows ``aa`` (B, 3):
    Rodrigues' formula, and its first-order form near the identity, as
    Ceres's ``AngleAxisRotatePoint``."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 <= torch.finfo(aa.dtype).eps
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    w = aa / theta
    cos, sin = torch.cos(theta), torch.sin(theta)
    w_cross_x = torch.linalg.cross(w, x, dim=-1)
    w_dot_x = torch.sum(w * x, dim=-1, keepdim=True)
    exact = x * cos + w_cross_x * sin + w * w_dot_x * (1.0 - cos)
    first_order = x + torch.linalg.cross(aa, x, dim=-1)
    return torch.where(small, first_order, exact)


def project(cameras: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Predicted pixels (B, 2) of the point rows (B, 3) in the camera rows (B, 9)."""
    p = angle_axis_rotate(cameras[:, 0:3], points) + cameras[:, 3:6]
    xp = -p[:, 0] / p[:, 2]
    yp = -p[:, 1] / p[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cameras[:, 7] + cameras[:, 8] * r2)
    f = cameras[:, 6] * distortion
    return torch.stack([f * xp, f * yp], dim=1)


def rotation_matrix_to_angle_axis(r: np.ndarray) -> np.ndarray:
    """Angle-axis rows (n, 3) of the rotation matrices (n, 3, 3), by way of
    the unit quaternion (Shepperd's choice of the largest pivot)."""
    n = r.shape[0]
    q = np.zeros((n, 4))  # (w, x, y, z)
    tr = np.trace(r, axis1=1, axis2=2)
    pivots = np.stack([tr, r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]], axis=1)
    which = np.argmax(pivots, axis=1)
    for i in range(n):
        m = r[i]
        k = which[i]
        if k == 0:
            s = 2.0 * np.sqrt(1.0 + tr[i])
            q[i] = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                    (m[1, 0] - m[0, 1]) / s]
        else:
            a = k - 1
            b, c = (a + 1) % 3, (a + 2) % 3
            s = 2.0 * np.sqrt(1.0 + m[a, a] - m[b, b] - m[c, c])
            v = np.zeros(3)
            v[a] = 0.25 * s
            v[b] = (m[b, a] + m[a, b]) / s
            v[c] = (m[c, a] + m[a, c]) / s
            q[i] = [(m[c, b] - m[b, c]) / s, *v]
    q *= np.where(q[:, :1] < 0.0, -1.0, 1.0)  # w >= 0: the angle in [0, pi]
    sin_half = np.linalg.norm(q[:, 1:], axis=1)
    angle = 2.0 * np.arctan2(sin_half, q[:, 0])
    factor = np.where(sin_half > 0.0, angle / np.where(sin_half > 0.0, sin_half, 1.0), 2.0)
    return q[:, 1:] * factor[:, None]
