"""The cell ``final4585.cluster-tridiagonal`` on the CPU: its files, its
scene's counts and tracks at the published size, a dry run (untraced and
traced) at a 120-camera cut of its configuration, both new readers
(``cluster_factor_ms``, ``cluster_apply_roofline``), and the counts of the
apply's roofline."""

import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.roofline import bound_seconds
from benchmark.roofline_cluster import cluster_apply_counts
from benchmark.tests.test_bench_dryrun import CARD_ONLY

CELL = "final4585.cluster-tridiagonal"
CUT = {"num_cameras": 120, "num_points": 1500, "num_observations": 9500,
       "track_lengths": {"6": 1000, "7": 500},
       "assumed_update": {"num_sites": 4, "min_site_cameras": 14}}


def _config(cut=True):
    config = dict(harness.load_cell(CELL)["config_data"])
    if cut:
        update = CUT["assumed_update"]
        config.update({k: v for k, v in CUT.items() if k != "assumed_update"})
        config["assumed"] = {**config["assumed"], **update}
    return config


def test_cell_and_config_files():
    """Both files parse; the counts are BAL Final-4585's, uncut; the
    options are the Final cell's but for the preconditioner and the
    clustering."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        benchmark = json.load(f)
    entry = next(w for w in benchmark["workloads"] if w["name"] == CELL)
    config_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])
    cell = harness.load_cell(CELL)
    config = cell["config_data"]
    assert entry["chips"] == 1 and config_entry["reduced"] == config["reduced"] == []
    assert config_entry["file"] == f"benchmark/configs/{config['name']}.json"
    assert config["num_cameras"] == 4_585
    tracks = {int(k): v for k, v in config["track_lengths"].items()}
    assert tracks == {6: 146_949, 7: 1_177_633}
    assert sum(tracks.values()) == config["num_points"] == 1_324_582
    assert sum(k * v for k, v in tracks.items()) == config["num_observations"] == 9_125_125
    final = harness.load_cell("final13682.iterative-schur")
    changed = {k for k in set(cell["options"]) | set(final["options"])
               if cell["options"].get(k) != final["options"].get(k)}
    assert changed == {"preconditioner_type", "visibility_clustering_type"}
    assert (cell["checks"].keys(), cell["path_accepted_steps"], cell["dtype"]) == (
        final["checks"].keys(), 4, "float64")
    options = harness.solver_options(cell, "cpu", cell["dtype"])
    assert options.visibility_clustering_type.value == "CANONICAL_VIEWS"
    assert options.preconditioner_type.value == "CLUSTER_TRIDIAGONAL"
    # every size the generator reads is stated
    for key in ("scene_seed", "num_sites", "min_site_cameras", "site_exponent", "site_spacing",
                "ring_radius", "ring_height", "arc_degrees", "point_sigma", "bridge_share",
                "track_spacing_cameras", "pixel_noise", "perturb_rotation",
                "perturb_translation", "perturb_point"):
        assert key in config["assumed"], key


def test_scene_counts_and_tracks():
    """At the published size: every camera and point observed, each point
    by 6 or 7 distinct cameras in the published counts; the sites' cameras
    sum to 4,585, the largest site 24 times the smallest's."""
    from benchmark.scenes import bal_synthetic_sites as sites

    config = _config(cut=False)
    n_of = sites.site_cameras(config)
    assert n_of.sum() == 4_585 and n_of.max() >= 20 * n_of.min() and len(n_of) == 40
    _, _, cam, pt, _ = sites._draw(config, "cpu")
    assert len(cam) == 9_125_125
    lengths = torch.bincount(pt, minlength=1_324_582)
    assert torch.equal(torch.bincount(lengths), torch.tensor([0, 0, 0, 0, 0, 0, 146_949,
                                                              1_177_633]))
    assert torch.bincount(cam, minlength=4_585).min() > 0
    key = torch.unique(pt * 4_585 + cam)
    assert len(key) == len(cam)  # no camera twice in a track


def test_seed_relabels_the_same_scene():
    """Two seeds give one problem in two orders: the same sorted
    observations."""
    config = _config()
    mod = harness.load_module("scenes", config["generator"])
    a, b = mod.generate(config, 5, "cpu"), mod.generate(config, 6, "cpu")
    assert not np.array_equal(a.camera_index, b.camera_index)
    for sc in (a, b):
        assert np.all(np.diff(sc.point_index) >= 0)
    np.testing.assert_array_equal(np.sort(a.observations, axis=0), np.sort(b.observations, axis=0))
    np.testing.assert_array_equal(np.sort(a.cameras, axis=0), np.sort(b.cameras, axis=0))


@pytest.mark.parametrize("trace", [False, True])
def test_dry_run(trace):
    """The cell at the cut: correct; untraced its end-to-end metrics, traced
    its per-layer metrics that a CPU run can read, and both new entries
    wrapped and called (one factor a damped solve, an apply a PCG step and
    one more a solve)."""
    logs = []
    config = _config()
    overrides = {k: config[k] for k in ("num_cameras", "num_points", "num_observations",
                                        "track_lengths", "assumed")}
    r = harness.run_cell(CELL, 4_294_967_311, 0.2, trace, device="cpu",
                         config_overrides=overrides, log=logs.append)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        e2e, per_layer = harness._selected(json.load(f), CELL)
    want = {m["name"] for m in (per_layer if trace else e2e)
            if m["source"] != "device_trace" and m["name"].split(".")[0] not in CARD_ONLY}
    assert set(r["metrics"]) == want
    if trace:
        lines = {e: next(m for m in logs if m.startswith(f"[bench] trace: {e} "))
                 for e in ("cluster_preconditioner", "apply_cluster_preconditioner")}
        calls = {e: int(line.split()[3]) for e, line in lines.items()}
        assert calls["apply_cluster_preconditioner"] > calls["cluster_preconditioner"] > 0


def test_readers():
    """Each reader from the calls' device time; nothing to read untraced,
    without calls, or where no call launched on the device."""
    factor = harness.load_reader("cluster_factor_ms")
    apply = harness.load_reader("cluster_apply_roofline")
    assert factor.ENTRY == ("skeres_tpu_torch.core.schur", "cluster_preconditioner")
    assert apply.ENTRY == ("skeres_tpu_torch.core.schur", "apply_cluster_preconditioner")
    calls = {"cluster_preconditioner": [{"device_s": 0.004}, {"device_s": 0.006},
                                        {"device_s": 0.0}],
             "apply_cluster_preconditioner": [dict(bytes=3.35e9, flops=0.0, peak=34e12,
                                                   device_s=0.002)]}
    rec = dict(calls=calls, trace={"busy_s": 1.0})
    assert factor.read(rec) == pytest.approx(5.0)
    assert apply.read(rec) == pytest.approx(50.0)
    for reader in (factor, apply):
        assert reader.read(dict(calls=calls, trace=None)) is None
        assert reader.read(dict(calls={}, trace={"busy_s": 1.0})) is None
    assert factor.read(dict(calls={"cluster_preconditioner": [{"device_s": 0.0}]},
                            trace={})) is None


def _solver(sizes, chains):
    return types.SimpleNamespace(f_size=9, visibility=types.SimpleNamespace(
        sizes=np.array(sizes), chains=chains))


def test_apply_counts():
    """A hand-sized apply: clusters of 2, 3 and 1 cameras, the first two a
    chain; then clusters at the cell's scale."""
    v = torch.zeros(54, dtype=torch.float64)
    c = cluster_apply_counts(_solver([2, 3, 1], [[0, 1], [2]]), None, v)
    diag, band = 18 * 18 + 27 * 27 + 9 * 9, 18 * 27
    assert c["bytes"] == 8 * (diag + band + 2 * 54)
    assert c["flops"] == 2 * diag + 4 * band and c["peak"] == 34e12
    # 179 clusters of 25 cameras in 20 chains: the blocks dominate
    sizes = [25] * 179
    chains = [list(range(k * 9, min(k * 9 + 9, 179))) for k in range(20)]
    v = torch.empty(9 * 4_475, dtype=torch.float64, device="meta")
    c = cluster_apply_counts(_solver(sizes, chains), None, v)
    blocks = 179 * 225 ** 2 + 159 * 225 ** 2
    assert c["bytes"] == 8 * (blocks + 2 * 9 * 4_475)
    assert bound_seconds(c["bytes"], c["flops"], c["peak"]) == pytest.approx(
        c["bytes"] / 3.35e12)
