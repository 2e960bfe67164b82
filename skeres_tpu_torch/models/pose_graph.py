"""Pose-graph (SLAM) residuals: SE(2) and SE(3) relative-pose constraints.

PyTorch counterpart of ``skeres_tpu/models/pose_graph.py`` (reference
lineage: ``examples/slam/pose_graph_2d/pose_graph_2d_error_term.h``,
``examples/slam/pose_graph_3d/pose_graph_3d_error_term.h``): each edge
(a, b) with measured relative pose T_ab and square-root information L
contributes the L-weighted discrepancy between the relative pose of
(x_a, x_b) and the measurement. A pose is one block, SE(2) as
(x, y, yaw) with a wrapped angle, SE(3) as (px, py, pz, qx, qy, qz, qw)
with the quaternion in Eigen order (scalar last) and computed in the
Ceres order (scalar first) inside, so whole graphs batch as two-slot
residual arrays. Each residual is written for one edge; the evaluator
maps it over the edges with ``torch.func.vmap``.
"""

from __future__ import annotations

import torch

from skeres_tpu_torch.models.manifolds import (
    AngleManifold,
    EigenQuaternionManifold,
    EuclideanManifold,
    ProductManifold,
)
from skeres_tpu_torch.ops import rotation as rot

__all__ = [
    "se2_manifold",
    "se3_manifold",
    "pose_graph_2d_error",
    "pose_graph_3d_error",
]


def se2_manifold() -> ProductManifold:
    """(x, y) Euclidean x yaw, wrapped to (-pi, pi]."""
    return ProductManifold(EuclideanManifold(2), AngleManifold())


def se3_manifold() -> ProductManifold:
    """(px, py, pz) Euclidean x a unit quaternion in Eigen [x,y,z,w] order."""
    return ProductManifold(EuclideanManifold(3), EigenQuaternionManifold())


def pose_graph_2d_error(params, data):
    """SE(2) relative-pose residual (3,).

    params = (pose_a (3,), pose_b (3,)) with pose = (x, y, yaw).
    data = dict(t_ab (2,), yaw_ab (), sqrt_information (3, 3)).

    r = L [ R(yaw_a)^T (p_b - p_a) - t_ab ;
            normalize(yaw_b - yaw_a - yaw_ab) ]
    """
    pose_a, pose_b = params
    yaw_a = pose_a[2]
    c, s = torch.cos(yaw_a), torch.sin(yaw_a)
    d = pose_b[:2] - pose_a[:2]
    local = torch.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1]])  # R(yaw_a)^T d
    r_yaw = AngleManifold.normalize(pose_b[2] - yaw_a - data["yaw_ab"])
    r = torch.cat([local - data["t_ab"], r_yaw[None]])
    return data["sqrt_information"] @ r


def pose_graph_3d_error(params, data):
    """SE(3) relative-pose residual (6,).

    params = (pose_a (7,), pose_b (7,)) with pose = (p (3,), q_xyzw (4,)).
    data = dict(t_ab (3,), q_ab (4,) xyzw, sqrt_information (6, 6)).

    r = L [ R(q_a)^T (p_b - p_a) - t_ab ;
            2 vec(q_ab^-1 (q_a^-1 q_b)) ]
    """
    pose_a, pose_b = params
    q_a = rot.eigen_quaternion_to_ceres(pose_a[3:7])
    q_b = rot.eigen_quaternion_to_ceres(pose_b[3:7])
    q_ab = rot.eigen_quaternion_to_ceres(data["q_ab"])

    q_a_inv = rot.quaternion_conjugate(q_a)
    # the estimated relative rotation and translation in frame a
    q_ab_est = rot.quaternion_product(q_a_inv, q_b)
    t_ab_est = rot.unit_quaternion_rotate_point(q_a_inv, pose_b[:3] - pose_a[:3])

    dq = rot.quaternion_product(rot.quaternion_conjugate(q_ab), q_ab_est)
    r = torch.cat([t_ab_est - data["t_ab"], 2.0 * dq[1:4]])
    return data["sqrt_information"] @ r
