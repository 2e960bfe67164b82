"""The examples of ``examples_torch/`` on the CPU (``device="cpu"`` or
``--device cpu``): the seven cases of ``tests/test_examples.py`` with their
assertions, one case for each of the other six scripts, and, where the
result is deterministic, the JAX example's result on the same inputs:
``sampled_function``'s x, the ellipse's costs, ``robot_pose_mle``'s and
``denoising``'s errors, Rosenbrock's, ``curve_fitting``'s, ``powell``'s and
``helloworld``'s solutions and the MGH and NIST verdicts."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_solution(monkeypatch, module, argv=()):
    """Runs the JAX example ``module``'s ``main`` with ``argv`` and returns
    the solved problem's parameter values, group by group (those mains
    print their result and return nothing)."""
    import skeres_tpu as st

    problems = []
    solve = st.solve

    def recording_solve(options, problem):
        problems.append(problem)
        return solve(options, problem)

    monkeypatch.setattr(st, "solve", recording_solve)
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()
    (problem,) = problems
    return np.concatenate([g.values.ravel() for g in problem._groups])


def test_sampled_function_finds_interior_minimum_as_jax():
    from examples.sampled_function import main as jmain
    from examples_torch.sampled_function import main

    x = main(device="cpu")
    assert abs(x - 4.5) < 1e-3
    np.testing.assert_allclose(x, jmain(), rtol=1e-10)


def test_robot_pose_mle_beats_dead_reckoning_as_jax(monkeypatch):
    from examples.robot_pose_mle import main as jmain
    from examples_torch.robot_pose_mle import main

    rmse_dead, rmse_mle = main(["--device", "cpu"])
    # range readings are 10x tighter than odometry: the MLE must beat
    # dead reckoning by a wide margin (reference: robot_pose_mle.cc)
    assert rmse_mle < 0.3 * rmse_dead
    monkeypatch.setattr(sys, "argv", ["robot_pose_mle"])
    np.testing.assert_allclose((rmse_dead, rmse_mle), jmain(), rtol=1e-8)


def test_denoising_reduces_noise_preserves_edges(monkeypatch):
    from examples.denoising import main as jmain
    from examples_torch.denoising import main

    err_noisy, err_restored = main(["--side", "32", "--device", "cpu"])
    assert err_restored < 0.7 * err_noisy
    monkeypatch.setattr(sys, "argv", ["denoising", "--side", "32"])
    np.testing.assert_allclose((err_noisy, err_restored), jmain(), rtol=1e-8)


def test_ellipse_approximation_converges_as_jax():
    """DENSE_SCHUR with three slots a row (vertex, vertex, preimage): S by
    the column probe. Every step's cost equals the JAX example's to rtol
    1e-8 (no preimage meets the clamp's bounds exactly, where
    ``torch.clamp`` and ``jnp.clip`` differ in the gradient they pass)."""
    from examples.ellipse_approximation import main as jmain
    from examples_torch.ellipse_approximation import main
    from skeres_tpu_torch.core.types import TerminationType

    summary = main(num_points=60, num_segments=10, device="cpu")
    assert summary.termination_type == TerminationType.CONVERGENCE
    # the piecewise-linear fit lands near the noisy ellipse samples
    assert summary.final_cost < 0.1 * summary.initial_cost
    assert summary.schur_complement_path.startswith("column-probe")
    js = jmain(num_points=60, num_segments=10)
    assert len(summary.iterations) == len(js.iterations)
    np.testing.assert_allclose([i.cost for i in summary.iterations],
                               [i.cost for i in js.iterations], rtol=1e-8)


def test_rosenbrock_gradient_problem_example_as_jax():
    from examples.rosenbrock import main as jmain
    from examples_torch.rosenbrock import main

    summary, solution = main(device="cpu")
    assert summary.final_cost < 1e-10
    np.testing.assert_allclose(solution, [1.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(solution, jmain()[1], rtol=1e-8)


def test_mgh_scoreboard_example_as_jax(monkeypatch):
    from examples.more_garbow_hillstrom import main as jmain
    from examples_torch.more_garbow_hillstrom import main

    ok, total = main(["--problem", "5", "--device", "cpu"])
    assert (ok, total) == (1, 1)
    monkeypatch.setattr(sys, "argv", ["more_garbow_hillstrom", "--problem", "5"])
    assert jmain() == (ok, total)


def test_nist_scoreboard_example_as_jax(monkeypatch):
    from examples.nist import main as jmain
    from examples_torch.nist import main

    successes, total = main(["--difficulty", "lower", "--device", "cpu"])
    # lower-difficulty ladder: every embedded (problem, start) certifies
    assert successes == total
    monkeypatch.setattr(sys, "argv", ["nist", "--difficulty", "lower"])
    assert jmain() == (successes, total)


def test_helloworld(monkeypatch):
    from examples import helloworld as jexample
    from examples_torch.helloworld import main

    summary, x = main(device="cpu")
    assert abs(x - 10.0) < 1e-6 and summary.final_cost < 1e-12
    np.testing.assert_allclose([x], _jax_solution(monkeypatch, jexample), rtol=1e-8)


@pytest.mark.parametrize("robustify", [False, True])
def test_curve_fitting(robustify, monkeypatch):
    """Near the generating m = 0.3, c = 0.1, with or without outliers (the
    CauchyLoss keeps the 8 outliers from pulling the fit), and (m, c) equal
    to the JAX example's."""
    from examples import curve_fitting as jexample
    from examples_torch.curve_fitting import main

    flags = ["--robustify"] if robustify else []
    summary, (m, c) = main(["--device", "cpu"] + flags)
    assert summary.termination_type.name == "CONVERGENCE"
    assert abs(m - 0.3) < 0.03 and abs(c - 0.1) < 0.1
    np.testing.assert_allclose((m, c), _jax_solution(monkeypatch, jexample, flags),
                               rtol=1e-8)


def test_powell(monkeypatch):
    from examples import powell as jexample
    from examples_torch.powell import main

    summary, x = main(["--device", "cpu"])
    assert summary.final_cost < 1e-12 and max(abs(v) for v in x) < 1e-3
    np.testing.assert_allclose(x, _jax_solution(monkeypatch, jexample), rtol=1e-8)


def test_bundle_adjuster_shim(capsys):
    from examples_torch.bundle_adjuster import main

    summary = main(["--num_cameras", "4", "--num_points", "40", "--max_iterations", "5",
                    "--device", "cpu"])
    assert summary.final_cost < summary.initial_cost
    assert "BAL problem: 4 cameras, 40 points" in capsys.readouterr().out


@pytest.mark.parametrize("dim", [2, 3])
def test_pose_graph_shims(dim, tmp_path):
    from examples_torch.pose_graph_2d import main as main2
    from examples_torch.pose_graph_3d import main as main3
    from test_torch_cli import write_square_g2o

    if dim == 2:
        summary = main2(["--input", write_square_g2o(tmp_path), "--device", "cpu"])
    else:
        summary = main3(["--num_poses", "40", "--max_iterations", "10", "--device", "cpu"])
    assert summary.final_cost < summary.initial_cost
