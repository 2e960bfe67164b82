"""``bal_synthetic``'s scene at a camera count far past venice's, with the
plain reference that sums by owner a block at a time
(``reference/bal_lm_blocked.py``): the generator of configurations whose
reference would not fit the card otherwise (BAL Final's 28,987,644
observations).

The ring, the points, the noise, the perturbations, the draws and their
order, and the order the run's seed gives the problem in are
``bal_synthetic``'s. One thing differs: a track's cameras are spread
along the ring. The j-th camera of a track stands ``floor(j * stride)``
ring places past its start, ``stride = max(1, num_cameras /
track_spacing_cameras)``, so that a track spans the arc it spans on a
ring of ``track_spacing_cameras`` cameras and keeps that ring's
parallax. (On a ring of 13,682 cameras of venice's radius, consecutive
cameras stand 5.5 mm apart: a track of 7 of them sees its point from
angles about 1.4 px apart against 0.5 px of noise, and the solve has
little to work on.) Where the stride is 1, as on a ring of at most
``track_spacing_cameras`` cameras, the scene is ``bal_synthetic``'s,
draw for draw.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.snavely import project
from benchmark.scenes.bal_synthetic import BalScene, _ring_cameras, build_problem

__all__ = ["BalScene", "build_problem", "generate", "make_reference"]


def track_stride(config: dict) -> float:
    """Ring places between a track's consecutive cameras."""
    return max(1.0, config["num_cameras"] / config["assumed"]["track_spacing_cameras"])


def _draw(config: dict, device):
    """The scene of ``config``, in ring and point order, from its
    ``scene_seed``: (cameras, points, camera index, point index,
    observations), all on ``device``."""
    a = config["assumed"]
    nc, npt = config["num_cameras"], config["num_points"]
    tracks = {int(k): v for k, v in config["track_lengths"].items()}
    stride = track_stride(config)
    if sum(tracks.values()) != npt or math.floor((max(tracks) - 1) * stride) >= nc:
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
    offset = torch.floor(slot.to(f64) * stride).to(torch.int64)
    cam_idx = (start[pt_idx] + offset) % nc

    obs = project(cameras[cam_idx], points[pt_idx])
    obs += a["pixel_noise"] * torch.randn(obs.shape, generator=g, device=device, dtype=f64)

    points += a["perturb_point"] * torch.randn(points.shape, generator=g, device=device, dtype=f64)
    cameras[:, 3:6] += a["perturb_translation"] * torch.randn(
        (nc, 3), generator=g, device=device, dtype=f64)
    cameras[:, 0:3] += a["perturb_rotation"] * torch.randn(
        (nc, 3), generator=g, device=device, dtype=f64)
    return cameras, points, cam_idx, pt_idx, obs


def generate(config: dict, seed: int, device) -> BalScene:
    """The problem of ``config`` in the order that ``seed`` decides, as
    ``bal_synthetic.generate`` orders it."""
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


def make_reference(scene: BalScene, device):
    """The plain reference of this scene kind, blocked."""
    from benchmark.reference.bal_lm_blocked import BalLMBlocked

    return BalLMBlocked(scene.camera_index, scene.point_index, scene.observations,
                        scene.cameras.shape[0], scene.points.shape[0], device)
