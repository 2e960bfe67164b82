"""A BAL-style scene of a community photo collection: landmarks ("sites")
photographed by very different numbers of cameras, with the plain
reference of CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL under visibility
clustering (``reference/bal_lm_cluster.py``): the generator of
configurations whose visibility is not one ring.

Every size below is the configuration's ``assumed``:

- sites: ``num_sites`` landmarks ``site_spacing`` apart on a street (the x
  axis, centered on the origin). Site k of the size order holds ``min_site_cameras`` plus a share
  of the rest proportional to ``1 / (k + 1) ** site_exponent`` (a Zipf
  law: a few sites with most of the cameras, a long tail of small ones),
  the shares rounded by largest remainder so that they sum to
  ``num_cameras``; where each size stands on the street is drawn from the
  scene seed;
- cameras: each site's on an arc of radius ``ring_radius`` at height
  ``ring_height`` around the site, from ``arc_degrees[0]`` to
  ``arc_degrees[1]`` (the street side), evenly, each looking at the site;
  focal ``focal_mean + normal(0, focal_sigma)``, distortion k1, k2;
- points: a site's points are ``normal(0, point_sigma)`` about it, as many
  per site as its share of the cameras; a share ``bridge_share`` of all
  points stand halfway between two neighbouring sites, each seen by the
  third quarter of the left site's arc (past its middle: a landmark's
  central views catch the next one at their edge) and by the first quarter
  of the right site's arc, which looks back across it (half the track
  each, the left site's half the larger, each from a uniform start in its
  quarter with a stride of its own in ``[1, max(1, n / (2
  track_spacing_cameras))]``): these tie the sites' cameras into one
  graph, whose degree-2 forest still breaks at the sites;
- tracks: lengths 6 and 7 in the counts that give the published points and
  observations exactly, drawn to the points by the scene seed. A track's
  cameras are spaced along its arc as in ``bal_synthetic_blocked``: the
  j-th ``floor(j * stride)`` places past its first, here with a stride of
  its own drawn uniform in ``[1, max(1, n / track_spacing_cameras)]`` for a
  site of n cameras, so that nearby cameras share the most points and a
  large site's tracks still span a part of its arc;
- noise and start: pixel noise ``pixel_noise``; the start moves each point
  by ``normal(0, perturb_point)``, turns each camera about its own center
  by ``normal(0, perturb_rotation)`` on its angle-axis (the street runs
  hundreds of units from the origin, where a turn of the angle-axis alone
  would carry a camera across it), then moves its translation by
  ``normal(0, perturb_translation)``.

The run's seed relabels the cameras and the points by random permutations
and lists the observations point by point, as ``bal_synthetic`` does:
every seed asks for the same solve in another order, and camera order says
nothing of which cameras see the same points.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.snavely import angle_axis_rotate, project, rotation_matrix_to_angle_axis
from benchmark.scenes.bal_synthetic import BalScene, build_problem

__all__ = ["BalScene", "build_problem", "generate", "make_reference", "site_cameras"]


def _largest_remainder(total: int, weights: np.ndarray) -> np.ndarray:
    """Whole shares of ``total`` proportional to ``weights``, summing to it
    (the largest remainders, then the lower index, take the rest)."""
    share = total * weights / weights.sum()
    out = np.floor(share).astype(np.int64)
    rest = total - int(out.sum())
    order = np.lexsort((np.arange(len(share)), -(share - out)))
    out[order[:rest]] += 1
    return out


def site_cameras(config: dict) -> np.ndarray:
    """The cameras of each site, in size order (largest first)."""
    a = config["assumed"]
    k, low = a["num_sites"], a["min_site_cameras"]
    weights = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** a["site_exponent"]
    return low + _largest_remainder(config["num_cameras"] - k * low, weights)


def _look_at(centers: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Angle-axis and translation (n, 6) of cameras at ``centers`` each
    looking at its target along its -z axis."""
    z = centers - targets
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    r = np.stack([x, y, z], axis=1)  # world -> camera
    return np.concatenate([rotation_matrix_to_angle_axis(r), -np.einsum("nij,nj->ni", r, centers)],
                          axis=1)


def _draw(config: dict, device):
    """The scene of ``config`` in street and arc order, from its
    ``scene_seed``: (cameras, points, camera index, point index,
    observations), all on ``device``."""
    a = config["assumed"]
    nc, npt = config["num_cameras"], config["num_points"]
    tracks = {int(k): v for k, v in config["track_lengths"].items()}
    n_of = site_cameras(config)
    num_sites = len(n_of)
    if (sum(tracks.values()) != npt or n_of.min() <= max(tracks) or num_sites < 2
            or a["track_spacing_cameras"] < max(tracks)):
        raise ValueError(f"track lengths {tracks} do not fit {npt} points, {num_sites} sites of "
                         f"{n_of.min()} cameras or more and track_spacing_cameras "
                         f"{a['track_spacing_cameras']}")
    f64, i64 = torch.float64, torch.int64
    g = torch.Generator(device=device)
    g.manual_seed(a["scene_seed"])

    # the sites on the street, and each one's cameras along its arc
    n_of = n_of[torch.randperm(num_sites, generator=g, device=device).cpu().numpy()]
    first_cam = np.concatenate([[0], np.cumsum(n_of)[:-1]])
    site_xyz = np.zeros((num_sites, 3))
    site_xyz[:, 0] = a["site_spacing"] * (np.arange(num_sites) - 0.5 * (num_sites - 1))
    lo, hi = np.radians(a["arc_degrees"])
    theta = np.concatenate([np.linspace(lo, hi, n) for n in n_of])
    site_of_cam = np.repeat(np.arange(num_sites), n_of)
    centers = site_xyz[site_of_cam] + np.stack(
        [a["ring_radius"] * np.cos(theta), a["ring_radius"] * np.sin(theta),
         np.full_like(theta, a["ring_height"])], axis=1)
    cameras = torch.zeros((nc, 9), dtype=f64, device=device)
    cameras[:, 0:6] = torch.from_numpy(_look_at(centers, site_xyz[site_of_cam])).to(device)
    cameras[:, 6] = a["focal_mean"] + a["focal_sigma"] * torch.randn(
        nc, generator=g, device=device, dtype=f64)
    cameras[:, 7] = a["k1"]
    cameras[:, 8] = a["k2"]

    # points: each site's share, then the bridges between neighbours
    n_bridge = int(round(a["bridge_share"] * npt))
    per_site = _largest_remainder(npt - n_bridge, n_of.astype(np.float64))
    lengths = torch.cat([torch.full((n,), k, dtype=i64, device=device)
                         for k, n in sorted(tracks.items())])
    lengths = lengths[torch.randperm(npt, generator=g, device=device)]
    site_t = torch.as_tensor(np.repeat(np.arange(num_sites), per_site), device=device)
    left = torch.randint(0, num_sites - 1, (n_bridge,), generator=g, device=device)
    max_stride = torch.as_tensor(np.maximum(1.0, n_of / a["track_spacing_cameras"]),
                                 device=device)
    n_t = torch.as_tensor(n_of, device=device)
    first_t = torch.as_tensor(first_cam, device=device)
    xyz_t = torch.as_tensor(site_xyz, device=device)
    u = torch.rand((npt, 3), generator=g, device=device, dtype=f64)

    pt_idx = torch.repeat_interleave(torch.arange(npt, device=device), lengths)
    slot = torch.arange(pt_idx.numel(), device=device) - (torch.cumsum(lengths, 0) - lengths)[pt_idx]
    n_site = npt - n_bridge
    # a site point: from a uniform start that keeps its track on the arc
    s = site_t[pt_idx.clamp(max=n_site - 1)]
    stride = 1.0 + (max_stride[s] - 1.0) * u[pt_idx, 0]
    span = torch.floor((lengths[pt_idx] - 1).to(f64) * stride).to(i64)
    start = torch.floor(u[pt_idx, 1] * (n_t[s] - span).to(f64)).to(i64)
    cam_site = first_t[s] + start + torch.floor(slot.to(f64) * stride).to(i64)
    # a bridge: the first half from the third quarter of the left site's
    # arc (past its middle, looking toward the right site), the rest from
    # the first quarter of the right site's (looking back across it), each
    # half from a uniform start that keeps it in its quarter
    b = (pt_idx - n_site).clamp(min=0, max=max(n_bridge - 1, 0))
    sl = left[b] if n_bridge else torch.zeros_like(b)
    sr = sl + 1
    half = (lengths[pt_idx] + 1) // 2
    on_left = slot < half
    s_side = torch.where(on_left, sl, sr)
    j = torch.where(on_left, slot, slot - half)
    part = torch.where(on_left, half, lengths[pt_idx] - half)
    stride_b = 1.0 + (max_stride[s_side] / 2.0 - 1.0).clamp(min=0.0) * u[pt_idx, 0]
    span_b = torch.floor((part - 1).to(f64) * stride_b).to(i64)
    room = (n_t[s_side] // 4 - span_b).clamp(min=1)
    start_b = torch.floor(torch.where(on_left, u[pt_idx, 1], u[pt_idx, 2]) * room.to(f64)).to(i64)
    start_b = start_b + torch.where(on_left, n_t[sl] // 2, 0)
    cam_bridge = first_t[s_side] + start_b + torch.floor(j.to(f64) * stride_b).to(i64)
    cam_idx = torch.where(pt_idx < n_site, cam_site, cam_bridge)

    points = torch.randn((npt, 3), generator=g, device=device, dtype=f64) * a["point_sigma"]
    points[:n_site] += xyz_t[site_t]
    points[n_site:] += 0.5 * (xyz_t[left] + xyz_t[left + 1])

    obs = project(cameras[cam_idx], points[pt_idx])
    obs += a["pixel_noise"] * torch.randn(obs.shape, generator=g, device=device, dtype=f64)

    # the start: a camera turns about its own center (far from the origin a
    # turn of its angle-axis alone would carry the camera across the street)
    points += a["perturb_point"] * torch.randn(points.shape, generator=g, device=device, dtype=f64)
    cameras[:, 0:3] += a["perturb_rotation"] * torch.randn(
        (nc, 3), generator=g, device=device, dtype=f64)
    cameras[:, 3:6] = -angle_axis_rotate(cameras[:, 0:3], torch.from_numpy(centers).to(device))
    cameras[:, 3:6] += a["perturb_translation"] * torch.randn(
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
    """The plain reference of this scene kind: the blocked reference with
    the cluster preconditioners under visibility clustering."""
    from benchmark.reference.bal_lm_cluster import BalLMCluster

    return BalLMCluster(scene.camera_index, scene.point_index, scene.observations,
                        scene.cameras.shape[0], scene.points.shape[0], device)
