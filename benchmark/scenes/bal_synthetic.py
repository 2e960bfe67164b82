"""A BAL-style bundle-adjustment scene at a BAL problem's published counts.

A frozen copy, in plain torch and numpy, of the scene that the program's
``synthetic_bal`` draws: cameras on a ring looking at a point cloud near
the origin, each point seen by consecutive cameras of the ring, pixel
observations of the true scene plus Gaussian noise, then a perturbed
start (rotation, translation and point offsets) so that the solver has
work. The counts come from the configuration file: cameras, points, and
how many points have each track length (the floor and the ceiling of the
published mean, so that the observations match the published count
exactly).

A configuration is one problem, as a BAL file is: the scene is drawn from
the configuration's ``scene_seed``, every draw on the device from one
``torch.Generator`` in a fixed order. The run's seed decides the order in
which the problem is handed over: the cameras and the points are
relabelled by random permutations, and the observations listed point by
point (each point's cameras in increasing order), as a BAL file lists
them. Every seed thus asks for the same solve, step for step, in another
order. The scene is handed over as host float64 arrays, as a loaded BAL
file gives them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.snavely import project, rotation_matrix_to_angle_axis

__all__ = ["BalScene", "build_problem", "generate", "make_reference"]


@dataclasses.dataclass
class BalScene:
    cameras: np.ndarray  # (num_cameras, 9) float64, the perturbed start
    points: np.ndarray  # (num_points, 3) float64, the perturbed start
    camera_index: np.ndarray  # (num_observations,) int32
    point_index: np.ndarray  # (num_observations,) int32
    observations: np.ndarray  # (num_observations, 2) float64

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]


def _ring_cameras(num_cameras: int, radius: float, height: float) -> np.ndarray:
    """Angle-axis and translation (n, 6) of cameras on a ring, each looking
    at the origin along its -z axis."""
    theta = 2.0 * np.pi * np.arange(num_cameras) / num_cameras
    c = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                  np.full_like(theta, height)], axis=1)
    z = c / np.linalg.norm(c, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    r = np.stack([x, y, z], axis=1)  # world -> camera
    return np.concatenate([rotation_matrix_to_angle_axis(r), -np.einsum("nij,nj->ni", r, c)],
                          axis=1)


def _draw(config: dict, device):
    """The scene of ``config``, in ring and point order, from its
    ``scene_seed``: (cameras, points, camera index, point index,
    observations), all on ``device``."""
    a = config["assumed"]
    nc, npt = config["num_cameras"], config["num_points"]
    tracks = {int(k): v for k, v in config["track_lengths"].items()}
    if sum(tracks.values()) != npt or max(tracks) > nc:
        raise ValueError(f"track lengths {tracks} do not fit {npt} points and {nc} cameras")
    f64 = torch.float64
    g = torch.Generator(device=device)
    g.manual_seed(a["scene_seed"])

    points = torch.randn((npt, 3), generator=g, device=device, dtype=f64) * a["point_sigma"]
    cameras = torch.zeros((nc, 9), dtype=f64, device=device)
    cameras[:, 0:6] = torch.from_numpy(
        _ring_cameras(nc, a["ring_radius"], a["ring_height"])).to(device)
    cameras[:, 6] = a["focal_mean"] + a["focal_sigma"] * torch.randn(
        nc, generator=g, device=device, dtype=f64)
    cameras[:, 7] = a["k1"]
    cameras[:, 8] = a["k2"]

    lengths = torch.cat([torch.full((n,), k, dtype=torch.int64, device=device)
                         for k, n in sorted(tracks.items())])
    lengths = lengths[torch.randperm(npt, generator=g, device=device)]
    start = torch.randint(0, nc, (npt,), generator=g, device=device)
    pt_idx = torch.repeat_interleave(torch.arange(npt, device=device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    slot = torch.arange(pt_idx.numel(), device=device) - first[pt_idx]
    cam_idx = (start[pt_idx] + slot) % nc

    obs = project(cameras[cam_idx], points[pt_idx])
    obs += a["pixel_noise"] * torch.randn(obs.shape, generator=g, device=device, dtype=f64)

    points += a["perturb_point"] * torch.randn(points.shape, generator=g, device=device, dtype=f64)
    cameras[:, 3:6] += a["perturb_translation"] * torch.randn(
        (nc, 3), generator=g, device=device, dtype=f64)
    cameras[:, 0:3] += a["perturb_rotation"] * torch.randn(
        (nc, 3), generator=g, device=device, dtype=f64)
    return cameras, points, cam_idx, pt_idx, obs


def generate(config: dict, seed: int, device) -> BalScene:
    """The problem of ``config`` in the order that ``seed`` decides."""
    cameras, points, cam_idx, pt_idx, obs = _draw(config, device)
    nc, npt = cameras.shape[0], points.shape[0]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cam_order = torch.randperm(nc, generator=g, device=device)  # new label -> old
    pt_order = torch.randperm(npt, generator=g, device=device)
    cam_label = torch.empty_like(cam_order)
    cam_label[cam_order] = torch.arange(nc, device=device)  # old label -> new
    pt_label = torch.empty_like(pt_order)
    pt_label[pt_order] = torch.arange(npt, device=device)
    new_cam, new_pt = cam_label[cam_idx], pt_label[pt_idx]
    rows = torch.argsort(new_pt * nc + new_cam)
    return BalScene(
        cameras=cameras[cam_order].cpu().numpy(),
        points=points[pt_order].cpu().numpy(),
        camera_index=new_cam[rows].to(torch.int32).cpu().numpy(),
        point_index=new_pt[rows].to(torch.int32).cpu().numpy(),
        observations=obs[rows].cpu().numpy(),
    )


def build_problem(scene: BalScene):
    """The program's Problem of the scene, as ``bundle_adjuster.cc``
    builds it: cameras and points as two parameter block arrays, points
    eliminated first, one Snavely residual block an observation. Returns
    ``(problem, {"cameras": handle, "points": handle})``."""
    from skeres_tpu_torch.core.problem import Problem
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error

    problem = Problem()
    cameras = problem.add_parameter_block_array(scene.cameras, name="cameras")
    points = problem.add_parameter_block_array(scene.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(cameras, 1)
    problem.add_residual_blocks(
        snavely_reprojection_error, None,
        [(cameras, scene.camera_index), (points, scene.point_index)],
        data=scene.observations, name="snavely",
    )
    return problem, {"cameras": cameras, "points": points}


def make_reference(scene: BalScene, device):
    """The plain reference of this scene kind (``reference/bal_lm.py``)."""
    from benchmark.reference.bal_lm import BalLM

    return BalLM(scene.camera_index, scene.point_index, scene.observations,
                 scene.cameras.shape[0], scene.points.shape[0], device)
