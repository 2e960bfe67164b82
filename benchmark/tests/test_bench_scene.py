"""The scene generator: the published BAL counts, exactly, from the seed."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import BENCH, load_module

CONFIGS = ("bal-ladybug-49", "bal-venice-1778")
PUBLISHED = {  # cameras, points, observations, {track length: points}
    "bal-ladybug-49": (49, 7776, 31843, {4: 7037, 5: 739}),
    "bal-venice-1778": (1778, 993923, 5001946, {5: 961592, 6: 32331}),
}


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_published_counts(name):
    cfg = _config(name)
    scene = load_module("scenes", cfg["generator"]).generate(cfg, 2_147_483_659, "cpu")
    nc, npt, nobs, tracks = PUBLISHED[name]
    assert scene.cameras.shape == (nc, 9) and scene.points.shape == (npt, 3)
    assert scene.observations.shape == (nobs, 2) and scene.num_observations == nobs
    assert scene.camera_index.dtype == np.int32 and scene.point_index.dtype == np.int32
    per_point = np.bincount(scene.point_index, minlength=npt)
    assert dict(zip(*np.unique(per_point, return_counts=True))) == tracks
    # listed point by point, each point's cameras increasing and distinct
    assert np.all(np.diff(scene.point_index) >= 0)
    same_point = scene.point_index[1:] == scene.point_index[:-1]
    assert np.all(np.diff(scene.camera_index)[same_point] > 0)
    assert np.isfinite(scene.observations).all() and scene.cameras.dtype == np.float64


def test_tracks_are_consecutive_ring_cameras():
    """Before the seed's relabelling, a track is consecutive cameras of the ring."""
    cfg = _config("bal-ladybug-49")
    _, _, cam_idx, pt_idx, _ = load_module("scenes", cfg["generator"])._draw(cfg, "cpu")
    cam_idx, pt_idx = cam_idx.numpy(), pt_idx.numpy()
    same_point = pt_idx[1:] == pt_idx[:-1]
    assert np.all(((cam_idx[1:] - cam_idx[:-1]) % cfg["num_cameras"])[same_point] == 1)


def test_seed_decides_the_order():
    """One seed gives the same arrays; another seed the same problem in
    another order."""
    cfg = _config("bal-ladybug-49")
    gen = load_module("scenes", cfg["generator"]).generate
    a, b, c = gen(cfg, 11, "cpu"), gen(cfg, 11, "cpu"), gen(cfg, 2_147_483_659, "cpu")
    for field in ("cameras", "points", "camera_index", "point_index", "observations"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    assert not np.array_equal(a.observations, c.observations)
    for x, y in ((a.observations, c.observations), (a.points, c.points),
                 (a.cameras, c.cameras)):
        assert np.array_equal(x[np.lexsort(x.T)], y[np.lexsort(y.T)])


def test_snavely_projection_matches_the_program():
    """The benchmark's own projection against the program's residual, on
    the same rows (a test-only comparison: the harness never imports the
    program's model into the reference)."""
    from benchmark.reference.snavely import project
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error

    cfg = _config("bal-ladybug-49")
    scene = load_module("scenes", cfg["generator"]).generate(cfg, 5, "cpu")
    cams = torch.from_numpy(scene.cameras[scene.camera_index[:500]])
    pts = torch.from_numpy(scene.points[scene.point_index[:500]])
    zero = torch.zeros(2, dtype=torch.float64)
    want = torch.func.vmap(lambda c, p: snavely_reprojection_error((c, p), zero))(cams, pts)
    assert torch.allclose(project(cams, pts), want, rtol=1e-13, atol=1e-10)
