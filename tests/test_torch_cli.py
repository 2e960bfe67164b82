"""The port's command-line tools (``skeres_tpu_torch.cli``) with
``--device cpu`` against the JAX package's (``skeres_tpu.cli``) on the same
inputs: the bundle adjuster's final cost and its final PLY point cloud, the
2-D and 3-D pose graphs' solutions, and the tool list of
``python -m skeres_tpu_torch.cli``."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from skeres_tpu.cli import bundle_adjuster as jba
from skeres_tpu.cli import pose_graph_2d as jpg2
from skeres_tpu.cli import pose_graph_3d as jpg3
from skeres_tpu_torch.cli import bundle_adjuster, pose_graph_2d, pose_graph_3d

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_square_g2o(directory) -> str:
    """A 2-D square loop of four poses, exact relative measurements (1, 0,
    pi/2) along it and identity information, initial poses perturbed from
    the square; returns the file's path."""
    path = pathlib.Path(directory) / "square.g2o"
    init = [(0.0, 0.0, 0.0), (1.1, -0.1, 1.4), (0.9, 1.2, 3.0), (-0.1, 0.9, -1.4)]
    lines = [f"VERTEX_SE2 {i} {x} {y} {t}" for i, (x, y, t) in enumerate(init)]
    lines += [f"EDGE_SE2 {i} {(i + 1) % 4} 1.0 0.0 {np.pi / 2} 1 0 0 1 0 1" for i in range(4)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _final_cost(report: str) -> float:
    return float(re.search(r"^Final\s+(\S+)", report, re.M).group(1))


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def test_bundle_adjuster_matches_jax(tmp_path, monkeypatch, capsys):
    """A synthetic scene of 6 cameras and 80 points, 10 steps, robustified:
    the final cost as the report prints it (7 digits) equal, and the final
    PLY clouds equal to 1e-9 (vertex by vertex)."""
    argv = ["--num_cameras", "6", "--num_points", "80", "--max_iterations", "10", "--robustify"]
    _run_jax(jba, argv + ["--final_ply", str(tmp_path / "j.ply")], monkeypatch)
    jcost = _final_cost(capsys.readouterr().out)
    summary = bundle_adjuster.main(argv + ["--final_ply", str(tmp_path / "t.ply"),
                                           "--device", "cpu"])
    assert _final_cost(capsys.readouterr().out) == jcost
    np.testing.assert_allclose(summary.final_cost, jcost, rtol=1e-6)
    j, t = ((tmp_path / n).read_text().splitlines() for n in ("j.ply", "t.ply"))
    assert t[:10] == j[:10] and len(t) == len(j) == 10 + 6 + 80
    np.testing.assert_allclose(np.loadtxt(t[10:]), np.loadtxt(j[10:]), rtol=0, atol=1e-9)


def test_pose_graph_2d_matches_jax(tmp_path, monkeypatch):
    """The square loop: the port's solution equals the JAX CLI's to 1e-8 and
    recovers the square."""
    g2o = write_square_g2o(tmp_path)
    _run_jax(jpg2, ["--input", g2o, "--output", str(tmp_path / "j.txt")], monkeypatch)
    summary = pose_graph_2d.main(["--input", g2o, "--output", str(tmp_path / "t.txt"),
                                  "--device", "cpu"])
    t, j = np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt")
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(t[:, :2], [[0, 0], [1, 0], [1, 1], [0, 1]], atol=1e-6)
    assert summary.final_cost < 1e-12


def test_pose_graph_3d_matches_jax(tmp_path, monkeypatch, capsys):
    """A synthetic sphere of 60 poses, 10 steps with
    ``--linear_solver DENSE_NORMAL_CHOLESKY`` (the default CGNR's iterates
    drift between the two packages' summation orders, as in
    test_torch_pose_graph.py): the final cost as the report prints it (7
    digits) and the poses to 1e-8."""
    argv = ["--num_poses", "60", "--max_iterations", "10", "--linear_solver",
            "DENSE_NORMAL_CHOLESKY"]
    _run_jax(jpg3, argv + ["--output", str(tmp_path / "j.txt")], monkeypatch)
    jcost = _final_cost(capsys.readouterr().out)
    summary = pose_graph_3d.main(argv + ["--output", str(tmp_path / "t.txt"), "--device", "cpu"])
    np.testing.assert_allclose(summary.final_cost, jcost, rtol=1e-6)  # the report's 7 digits
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt"),
                               rtol=0, atol=1e-8)


def test_cli_lists_the_tools():
    out = subprocess.run([sys.executable, "-m", "skeres_tpu_torch.cli"], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    for tool in ("bundle_adjuster", "pose_graph_2d", "pose_graph_3d"):
        assert f"skeres_tpu_torch.cli.{tool}" in out.stdout


def test_default_device_is_the_card(tmp_path):
    """Without ``--device`` a tool asks for the card: with none it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pose_graph_2d.main(["--input", write_square_g2o(tmp_path)])
