"""The cell ``final13682.iterative-schur`` on the CPU: its files, a dry run
at a 16-camera cut of its configuration (the same ring, tracks of 6 and
7), its scene's spread tracks, the blocked reference against ``BalLM``,
and the counts of ``s_product_roofline``."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.bal_lm import BalLM
from benchmark.roofline import bound_seconds
from benchmark.roofline_implicit import s_product_counts
from benchmark.tests.test_bench_dryrun import CARD_ONLY

CELL = "final13682.iterative-schur"
CUT = {"num_cameras": 16, "num_points": 120, "num_observations": 780,
       "track_lengths": {"6": 60, "7": 60}}


def test_cell_and_config_files():
    """Both files parse; the counts are BAL Final's, uncut."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        benchmark = json.load(f)
    entry = next(w for w in benchmark["workloads"] if w["name"] == CELL)
    config_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])
    cell = harness.load_cell(CELL)
    config = cell["config_data"]
    assert entry["chips"] == 1 and config_entry["reduced"] == config["reduced"] == []
    assert config_entry["file"] == f"benchmark/configs/{config['name']}.json"
    tracks = {int(k): v for k, v in config["track_lengths"].items()}
    assert sum(tracks.values()) == config["num_points"] == 4_456_117
    assert sum(k * v for k, v in tracks.items()) == config["num_observations"] == 28_987_644
    options = harness.solver_options(cell, "cpu", cell["dtype"])
    assert options.is_valid()[0] and options.max_num_iterations == 50
    assert options.evaluation_chunk_size == 1_048_576 and not options.use_device_loop
    assert cell["path_accepted_steps"] == 4 and cell["warmup_max_num_iterations"] == 2
    assert harness.load_module("scenes", config["generator"]).make_reference


@pytest.mark.parametrize("trace", [False, True])
def test_dry_run(trace):
    r = harness.run_cell(CELL, 4_294_967_311, 0.2, trace, device="cpu", config_overrides=CUT,
                         log=lambda msg: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        e2e, per_layer = harness._selected(json.load(f), CELL)
    want = {m["name"] for m in (per_layer if trace else e2e)
            if m["source"] != "device_trace" and m["name"].split(".")[0] not in CARD_ONLY}
    assert set(r["metrics"]) == want


def test_scene_spreads_tracks():
    """Where the stride is 1 the scene is ``bal_synthetic``'s, draw for
    draw; on a longer ring each track's j-th camera stands floor(j *
    stride) ring places past its first, with every other draw unchanged."""
    from benchmark.scenes import bal_synthetic, bal_synthetic_blocked as blocked

    config = {**harness.load_cell(CELL)["config_data"], **CUT}
    assert blocked.track_stride(config) == 1.0
    a, b = bal_synthetic.generate(config, 77, "cpu"), blocked.generate(config, 77, "cpu")
    for key in ("cameras", "points", "camera_index", "point_index", "observations"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))

    long_ring = dict(config, num_cameras=200,
                     assumed=dict(config["assumed"], track_spacing_cameras=16))
    stride = blocked.track_stride(long_ring)
    assert stride == 12.5
    cams, pts, cam_idx, pt_idx, obs = blocked._draw(long_ring, "cpu")
    ring = bal_synthetic._draw(long_ring, "cpu")
    np.testing.assert_array_equal(pt_idx, ring[3])
    np.testing.assert_array_equal(cams, ring[0])
    first = {}
    for row, (p, c) in enumerate(zip(pt_idx.tolist(), cam_idx.tolist())):
        j = row - first.setdefault(p, row)
        assert c == (cam_idx[first[p]].item() + int(j * stride)) % 200
    with pytest.raises(ValueError, match="do not fit"):
        blocked._draw(dict(config, num_cameras=30,
                           assumed=dict(config["assumed"], track_spacing_cameras=4)), "cpu")


def _scene():
    cell = harness.load_cell(CELL)
    config = {**cell["config_data"], **CUT}
    mod = harness.load_module("scenes", config["generator"])
    return cell, mod, mod.generate(config, 31_415_926_535, "cpu")


def test_blocked_reference_against_bal_lm(monkeypatch):
    """The same sums by owner (to 1e-12) at blocks of a few owners, and the
    same accepted path."""
    from benchmark.reference import bal_lm_blocked

    monkeypatch.setattr(bal_lm_blocked, "ROWS_PER_BLOCK", 50)  # several blocks of owners
    cell, mod, sc = _scene()
    blocked = mod.make_reference(sc, "cpu")
    plain = BalLM(sc.camera_index, sc.point_index, sc.observations, 16, 120, "cpu")
    cams = torch.as_tensor(sc.cameras)
    pts = torch.as_tensor(sc.points)
    lin_b = blocked._prepare(*blocked.linearize(cams, pts))
    lin_p = plain._prepare(*plain.linearize(cams, pts))
    for key, ref in lin_p.items():
        np.testing.assert_allclose(lin_b[key], ref, rtol=1e-12, atol=1e-12 * float(ref.abs().max()))
    out_b = blocked.solve(sc.cameras, sc.points, cell["options"], max_accepted=4)
    out_p = plain.solve(sc.cameras, sc.points, cell["options"], max_accepted=4)
    assert len(out_b["accepted_costs"]) == len(out_p["accepted_costs"]) == 5
    np.testing.assert_allclose(out_b["accepted_costs"], out_p["accepted_costs"], rtol=1e-12)
    assert out_b["linear_iterations"] == out_p["linear_iterations"]
    with pytest.raises(ValueError, match="SCHUR_JACOBI"):
        blocked.damped_step(lin_b, 1e-4, dict(cell["options"], linear_solver_type="DENSE_SCHUR"))


class _Solver:
    """The attributes ``s_product_counts`` reads of a SchurSolver."""

    def __init__(self, padded):
        self.e_batches = [0]
        self.batch_info = [dict(ret_slots=[(0, 0, 0, 9)])]
        self.sorted_info = {0: {}} if padded else {}


@pytest.mark.parametrize("padded", [True, False])
def test_s_product_counts(padded):
    """A hand-sized product: 10 rows of (2, 12), 4 points, 3 cameras."""
    jac = torch.zeros((10, 2, 12), dtype=torch.float64)
    asm = dict(per_batch=[(None, jac, jac[:, :, 9:])], cinv=torch.zeros((4, 3, 3)))
    c = s_product_counts(_Solver(padded), asm, torch.zeros(27, dtype=torch.float64))
    # C^-1, v, d_f and the result, then both passes' (2, 12) rows
    floats = 36 + 3 * 27 + 2 * 10 * 2 * 12
    index = 10 * 2 + 10 * (1 if padded else 2)
    assert c["bytes"] == 8 * floats + 8 * index
    assert c["flops"] == 2 * (4 * 9 + 10 * 2 * 12 + 10 * 2 * (18 + 3))
    assert c["peak"] == 34e12


def test_s_product_counts_at_final():
    """BAL Final in float64: about 12.2 GB and 3.6 ms a product."""
    rows, points, cams = 28_987_644, 4_456_117, 13_682
    jac = torch.empty((rows, 2, 12), dtype=torch.float64, device="meta")
    cinv = torch.empty((points, 3, 3), dtype=torch.float64, device="meta")
    v = torch.empty((9 * cams,), dtype=torch.float64, device="meta")
    c = s_product_counts(_Solver(True), dict(per_batch=[(None, jac, jac[:, :, 9:])], cinv=cinv), v)
    assert c["bytes"] == pytest.approx(12.15e9, rel=1e-3)
    assert bound_seconds(c["bytes"], c["flops"], c["peak"]) == pytest.approx(3.627e-3, rel=1e-3)


def test_reader_without_the_entry():
    """The reader finds nothing to read in a run with no call of its entry."""
    reader = harness.load_reader("s_product_roofline")
    assert reader.ENTRY == ("skeres_tpu_torch.core.schur", "implicit_s_product")
    assert reader.read(dict(calls={}, trace={"busy_s": 1.0})) is None
    assert reader.read(dict(calls={"implicit_s_product": [{"device_s": 1.0}]}, trace=None)) is None
