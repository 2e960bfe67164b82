"""BAL (Bundle Adjustment in the Large) dataset IO.

PyTorch counterpart of ``skeres_tpu/io/bal.py``: the BAL text parsers
(native for a plain file, Python for a compressed one), the
reference's Normalize()/Perturb() preprocessing, and the synthetic BAL
scene generator. The generator draws from the same numpy RNG stream in the
same order as the JAX package's, so one seed gives one scene in both
packages; its rotations and projections are computed here in float64 on
the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "BalProblem", "load_bal", "parse_bal_text", "synthetic_bal", "build_bal_problem",
    "build_split_bal_problem",
]


@dataclasses.dataclass
class BalProblem:
    cameras: np.ndarray  # (num_cameras, 9) float64
    points: np.ndarray  # (num_points, 3) float64
    camera_index: np.ndarray  # (num_obs,) int32
    point_index: np.ndarray  # (num_obs,) int32
    observations: np.ndarray  # (num_obs, 2) float64

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]

    def normalize(self, median_distance: float = 100.0) -> None:
        """Center the reconstruction at the point-cloud median and rescale
        so the median absolute deviation is ``median_distance``."""
        from skeres_tpu_torch.ops import rotation as rot

        median = np.median(self.points, axis=0)
        dev = np.sum(np.abs(self.points - median), axis=1)
        scale = median_distance / np.median(dev)

        self.points = scale * (self.points - median)

        # camera center c = -R' t  =>  t = -R c; transform c like a point
        aa = torch.from_numpy(self.cameras[:, 0:3].copy())
        t = torch.from_numpy(self.cameras[:, 3:6].copy())
        c = -rot.angle_axis_rotate_point(-aa, t)
        c = scale * (c.numpy() - median)
        t_new = -rot.angle_axis_rotate_point(aa, torch.from_numpy(c))
        self.cameras[:, 3:6] = t_new.numpy()

    def perturb(
        self,
        rotation_sigma: float = 0.0,
        translation_sigma: float = 0.0,
        point_sigma: float = 0.0,
        seed: int = 38401,
    ) -> None:
        rng = np.random.default_rng(seed)
        if point_sigma > 0:
            self.points += rng.normal(0, point_sigma, self.points.shape)
        if translation_sigma > 0:
            self.cameras[:, 3:6] += rng.normal(
                0, translation_sigma, (self.num_cameras, 3)
            )
        if rotation_sigma > 0:
            self.cameras[:, 0:3] += rng.normal(
                0, rotation_sigma, (self.num_cameras, 3)
            )


def load_bal(path: str) -> BalProblem:
    """Parse a BAL text file: a plain ``.txt`` by the native parser
    (``native/bal_native.py``), a ``.bz2`` or ``.gz`` by the Python parser
    (:func:`parse_bal_text`). A native build or parse error raises (the
    JAX package parses in Python instead)."""
    if path.endswith((".bz2", ".gz")):
        return parse_bal_text(path)
    from skeres_tpu_torch.native import bal_native

    return BalProblem(*bal_native.load(path))


def write_bal(path, bal: BalProblem) -> str:
    """Write ``bal`` as BAL text (compressed where ``path`` ends in ``.bz2``
    or ``.gz``): the header, one observation a line, then one number a line,
    each float with 17 significant digits, so that parsing it gives the same
    arrays bit for bit. Returns the path."""
    path = str(path)
    lines = [f"{bal.num_cameras} {bal.num_points} {bal.num_observations}"]
    lines += [f"{c} {p} {o[0]:.16e} {o[1]:.16e}"
              for c, p, o in zip(bal.camera_index, bal.point_index, bal.observations)]
    lines += [f"{v:.16e}" for v in np.concatenate([bal.cameras.ravel(), bal.points.ravel()])]
    if path.endswith(".bz2"):
        import bz2

        opener = bz2.open
    elif path.endswith(".gz"):
        import gzip

        opener = gzip.open
    else:
        opener = open
    with opener(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return path


def parse_bal_text(path: str) -> BalProblem:
    """Parse a BAL text file (.txt, .txt.bz2 or .txt.gz) in Python."""
    if path.endswith(".bz2"):
        import bz2

        opener = bz2.open
    elif path.endswith(".gz"):
        import gzip

        opener = gzip.open
    else:
        opener = open
    with opener(path, "rt") as f:
        nums = np.array(f.read().split(), dtype=np.float64)
    nc, npnt, nobs = int(nums[0]), int(nums[1]), int(nums[2])
    k = 3
    obs = nums[k : k + 4 * nobs].reshape(nobs, 4)
    k += 4 * nobs
    cameras = nums[k : k + 9 * nc].reshape(nc, 9)
    k += 9 * nc
    points = nums[k : k + 3 * npnt].reshape(npnt, 3)
    return BalProblem(
        cameras=np.ascontiguousarray(cameras),
        points=np.ascontiguousarray(points),
        camera_index=obs[:, 0].astype(np.int32),
        point_index=obs[:, 1].astype(np.int32),
        observations=np.ascontiguousarray(obs[:, 2:4]),
    )


def synthetic_bal(
    num_cameras: int = 16,
    num_points: int = 500,
    observations_per_point: int = 4,
    pixel_noise: float = 0.5,
    seed: int = 7,
    perturb_rotation: float = 0.03,
    perturb_translation: float = 0.2,
    perturb_point: float = 0.3,
) -> BalProblem:
    """A BAL-style synthetic scene: cameras on a ring looking at a point
    cloud near the origin, ground-truth projections plus pixel noise, then
    a perturbed initial estimate (so the solver has real work)."""
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error
    from skeres_tpu_torch.ops import rotation as rot

    rng = np.random.default_rng(seed)

    points = rng.normal(0.0, 2.0, size=(num_points, 3))
    radius = 12.0
    cameras = np.zeros((num_cameras, 9))
    theta = 2.0 * np.pi * np.arange(num_cameras) / num_cameras
    c = np.stack(
        [radius * np.cos(theta), radius * np.sin(theta), np.full_like(theta, 3.0)],
        axis=1,
    )
    # camera looks at the origin along its -z axis (BAL convention)
    z = c / np.linalg.norm(c, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    r_mat = np.stack([x, y, z], axis=1)  # (n, 3, 3) world -> camera
    cameras[:, 0:3] = rot.rotation_matrix_to_angle_axis(
        torch.from_numpy(r_mat)
    ).numpy()
    cameras[:, 3:6] = -np.einsum("nij,nj->ni", r_mat, c)
    cameras[:, 6] = 500.0 + rng.normal(0, 10, num_cameras)  # focal
    cameras[:, 7] = -1e-7
    cameras[:, 8] = 1e-13

    # each point is seen by a few consecutive cameras
    k = min(observations_per_point, num_cameras)
    start = rng.integers(0, num_cameras, size=num_points)
    cam_idx = (
        (start[:, None] + np.arange(k)[None, :]) % num_cameras
    ).reshape(-1).astype(np.int32)
    pt_idx = np.repeat(np.arange(num_points, dtype=np.int32), k)

    zero = torch.zeros(2, dtype=torch.float64)
    proj = torch.func.vmap(
        lambda cam, pnt: snavely_reprojection_error((cam, pnt), zero)
    )(torch.from_numpy(cameras[cam_idx]), torch.from_numpy(points[pt_idx]))
    observations = proj.numpy() + rng.normal(
        0.0, pixel_noise, size=(len(cam_idx), 2)
    )

    prob = BalProblem(
        cameras=cameras,
        points=points.copy(),
        camera_index=cam_idx,
        point_index=pt_idx,
        observations=observations,
    )
    prob.perturb(
        rotation_sigma=perturb_rotation,
        translation_sigma=perturb_translation,
        point_sigma=perturb_point,
        seed=seed + 1,
    )
    return prob


def build_bal_problem(bal: BalProblem, loss=None, use_schur_ordering: bool = True):
    """Build a Problem from a BalProblem (counterpart of the reference's
    ``bundle_adjuster.cc`` BuildProblem). Returns (problem, cameras, points)."""
    from skeres_tpu_torch.core.problem import Problem
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error

    problem = Problem()
    cameras = problem.add_parameter_block_array(bal.cameras, name="cameras")
    points = problem.add_parameter_block_array(bal.points, name="points")
    if use_schur_ordering:
        problem.set_schur_elimination_group(points, 0)
        problem.set_schur_elimination_group(cameras, 1)
    problem.add_residual_blocks(
        snavely_reprojection_error,
        loss,
        [(cameras, bal.camera_index), (points, bal.point_index)],
        data=bal.observations,
        name="snavely",
    )
    return problem, cameras, points


def build_split_bal_problem(bal: BalProblem, loss=None):
    """The problem of :func:`build_bal_problem` with each camera split into
    a pose block (angle-axis and translation, 6) and an intrinsics block
    (focal length, k1, k2, 3): each row touches (pose, intrinsics, point),
    and S has two retained groups. The same least-squares problem, with
    S's columns permuted. Returns (problem, poses, intrinsics, points)."""
    from skeres_tpu_torch.core.problem import Problem
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error_split

    problem = Problem()
    poses = problem.add_parameter_block_array(bal.cameras[:, :6], name="poses")
    intrinsics = problem.add_parameter_block_array(bal.cameras[:, 6:], name="intrinsics")
    points = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(poses, 1)
    problem.set_schur_elimination_group(intrinsics, 1)
    problem.add_residual_blocks(
        snavely_reprojection_error_split,
        loss,
        [(poses, bal.camera_index), (intrinsics, bal.camera_index), (points, bal.point_index)],
        data=bal.observations,
        name="snavely_split",
    )
    return problem, poses, intrinsics, points
