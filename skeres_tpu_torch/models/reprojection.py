"""Bundle-adjustment reprojection residuals.

PyTorch counterpart of ``skeres_tpu/models/reprojection.py``: the Snavely
camera model of the Bundle Adjustment in the Large dataset — 9-parameter
camera (angle-axis rotation (3), translation (3), focal length, k1, k2),
3-parameter point, 2D pixel observation. Written for ONE observation; the
evaluator maps it over all observations with ``torch.func.vmap`` and
differentiates it with ``torch.func.vjp``/``jvp``. The unsplit residual
also brings its batched form with a closed-form Jacobian
(``snavely_reprojection_error.analytic``, ``ops/reprojection.py``: a CUDA
kernel on the card), which the evaluator takes where both compute the same
function (``core/evaluator.py``).
"""

from __future__ import annotations

import torch

from skeres_tpu_torch.ops import reprojection as batched
from skeres_tpu_torch.ops import rotation as rot

__all__ = ["snavely_reprojection_error", "snavely_reprojection_error_fixed_k",
           "snavely_reprojection_error_split"]


def snavely_reprojection_error(params, observation):
    """params = (camera (9,), point (3,)); observation = (u, v) pixels.

    BAL convention: the camera looks down the -z axis, so the projection is
    p = -P / P.z with P the point in camera coordinates.
    """
    camera, point = params
    p = rot.angle_axis_rotate_point(camera[0:3], point) + camera[3:6]
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (camera[7] + camera[8] * r2)
    focal = camera[6]
    return torch.stack(
        [focal * distortion * xp - observation[0],
         focal * distortion * yp - observation[1]]
    )


snavely_reprojection_error.analytic = batched.SNAVELY


def snavely_reprojection_error_fixed_k(params, observation):
    """Variant with intrinsics folded into the observation:
    observation = (u, v, focal, k1, k2); camera is the 6-dof pose only."""
    camera, point = params
    p = rot.angle_axis_rotate_point(camera[0:3], point) + camera[3:6]
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (observation[3] + observation[4] * r2)
    f = observation[2]
    return torch.stack(
        [f * distortion * xp - observation[0], f * distortion * yp - observation[1]]
    )


def snavely_reprojection_error_split(params, observation):
    """The Snavely residual with the camera split in two blocks:
    params = (pose (6,): angle-axis and translation, intrinsics (3,): focal
    length, k1, k2, point (3,)). The same function of the same 12
    parameters as :func:`snavely_reprojection_error`."""
    pose, intrinsics, point = params
    return snavely_reprojection_error((torch.cat([pose, intrinsics]), point), observation)
