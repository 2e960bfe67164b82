"""The kernels' operation and byte counts against the figures PERF.md
gives for float32 (PR 2-11), and their float64 counterparts."""

import pytest

from benchmark import roofline

N_VENICE = 9 * 1778  # S of venice-1778: 16,002 rows


def test_k2_counts():
    f32 = roofline.k2_counts(N_VENICE, 512, 4)
    f64 = roofline.k2_counts(N_VENICE, 512, 8)
    assert f32["flops"] == pytest.approx(1.366e12, rel=1e-3)  # n^3 / 3
    assert f32["bytes"] == pytest.approx(1.57e9, rel=2e-3)
    assert f64["flops"] == f32["flops"] and f64["bytes"] == 2 * f32["bytes"]
    bound = roofline.bound_seconds(f64["bytes"], f64["flops"], f64["peak"])
    assert bound == pytest.approx(20.4e-3, rel=2e-3)  # operations over 67 TFLOP/s


def test_k3_counts():
    # the venice shape of PRs 2-11: 1M points, 5 slots, 10 pairs, all valid, (f, e) = (9, 3)
    f32 = roofline.k3_counts(1_000_000, 5_000_000, 10_000_000, 10_000_000, 9, 3, 4)
    f64 = roofline.k3_counts(1_000_000, 5_000_000, 10_000_000, 10_000_000, 9, 3, 8)
    assert f32["bytes"] == pytest.approx(3.836e9, rel=1e-3)
    masks = 2 * 10_000_000  # valid and swap, one byte each, whatever the dtype
    assert f64["bytes"] - masks == 2 * (f32["bytes"] - masks)
    assert f64["peak"] == 34e12 and f32["peak"] == 67e12


def test_k3_counts_venice():
    """venice-1778 in float64: 32,331 points in 6 slots (15 pairs), 961,592
    in 5 of their 6 (10 of 15 pairs valid): the valid work, about 7.7 GB
    and 2.3 ms, not the padded grid's 11.05 GB."""
    six, five = 32_331, 961_592
    c = roofline.k3_counts(six + five, 6 * six + 5 * five, 15 * six + 10 * five,
                           15 * (six + five), 9, 3, 8)
    assert 6 * six + 5 * five == 5_001_946  # the observations
    assert c["bytes"] == pytest.approx(7.722e9, rel=1e-3)
    assert roofline.bound_seconds(c["bytes"], c["flops"], c["peak"]) == pytest.approx(2.305e-3,
                                                                                       rel=1e-3)


def test_k3_reader_counts_the_valid_mask():
    """The reader counts a call from its own mask: padded slots and invalid
    pairs add nothing, and its tensors agree with the counts by hand."""
    import torch

    from benchmark.harness import load_reader

    k3 = load_reader("k3_roofline")
    iu, ju = torch.triu_indices(6, 6, 1)  # the 15 pairs of 6 slots
    pair_kl = torch.stack([iu, ju]).to(torch.int32)
    observed = torch.tensor([6, 5, 5, 2, 1])  # slots 0 .. m-1 of each point are observed
    valid = (ju[None, :] < observed[:, None])  # both slots of a pair observed
    grid = torch.zeros((5, 6 * 27), dtype=torch.float64)
    got = k3.counts(dict(grid=grid, valid=valid, pair_kl=pair_kl, f=9, e=3))
    slots, pairs = 6 + 5 + 5 + 2, 15 + 10 + 10 + 1
    want = roofline.k3_counts(4, slots, pairs, 5 * 15, 9, 3, 8)  # the one-slot point uses none
    assert {k: float(v) for k, v in got.items()} == pytest.approx(want)


def test_k1_counts():
    f64 = roofline.k1_counts(441, 8)
    assert f64["bytes"] == pytest.approx(3.89e6, rel=1e-3)
    bound = roofline.bound_seconds(f64["bytes"], f64["flops"], f64["peak"])
    assert bound == pytest.approx(1.16e-6, rel=1e-2)  # the bytes bound it


def test_share_leaves_out_what_did_not_run():
    call = dict(roofline.k2_counts(1024, 512, 8), device_s=0.0)
    assert roofline.roofline_share([call]) is None
    timed = dict(call, device_s=1.0)
    least = roofline.bound_seconds(call["bytes"], call["flops"], call["peak"])
    assert roofline.roofline_share([call, timed]) == pytest.approx(100.0 * least)


def test_k3_counted_in_a_traced_run(monkeypatch):
    """A traced CPU run on the explicit S (dense W switched off at this
    tiny size) counts each K3 call from its mask: the observations as
    slots, the valid pairs of 4- and 3-long tracks, no padding."""
    import json

    from benchmark import harness
    from benchmark.tests.conftest import TINY

    monkeypatch.setattr("skeres_tpu_torch.core.schur.DENSE_W_LIMIT_BYTES", 0)
    lines = []
    harness.run_cell("venice1778.dense-schur", 7, 0.1, True, device="cpu", config_overrides=TINY,
                     log=lines.append)
    line = next(x for x in lines if x.startswith("[bench] trace: pair_products"))
    calls = int(line.split()[3])
    last = json.loads(line.split("the last ", 1)[1])
    points, tracks = TINY["num_points"], {int(k): v for k, v in TINY["track_lengths"].items()}
    want = roofline.k3_counts(points, TINY["num_observations"],
                              sum(n * k * (k - 1) // 2 for k, n in tracks.items()),
                              points * 6, 9, 3, 8)  # 4 slots a point: 6 pairs
    assert calls >= 1 and last["bytes"] == pytest.approx(want["bytes"])
    assert last["flops"] == pytest.approx(want["flops"])
