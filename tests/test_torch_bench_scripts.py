"""The port's measuring scripts (``tools_torch/bench*.py``) with ``--device
cpu --dtype float64`` at small sizes, against the JAX package's solves with
their counterparts' exact options on the same numpy-made scenes: the final
cost to rtol 1e-8 and the same number of LM steps, and a last line with the
counterpart's JSON keys (``extra.backend`` as ``extra.device``). Without a
card and without ``--device``, every script raises before it builds a
scene. The JAX scripts' ``main()`` is never called (it updates the live JAX
config and writes ``.jax_cache``); their options are rebuilt here, each
citing its lines."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu.ops.rotation as jrot
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.problem import Problem as JProblem
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.core.types import PreconditionerType as JPreconditionerType
from skeres_tpu.io import bal as jbal
from skeres_tpu.io import g2o as jg2o
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.io import g2o as tg2o
from tools_torch import bench_common, bench_scaling, bench_sphere, bench_two_signature

RTOL = 1e-8
CPU = ["--device", "cpu", "--dtype", "float64"]
SCRIPTS = {"bench_sphere": bench_sphere, "bench_two_signature": bench_two_signature,
           "bench_scaling": bench_scaling}
# each script's flags at a small size
SMALL = {
    # 60 poses: one loop closure (a 50-pose sphere has none, so its odometry
    # start is already the solution, at a cost of 1e-24). CGNR's iterates
    # drift apart between the packages on the way (5.7e-5 at most, ROADMAP
    # note f) and meet again at the 30th step
    "bench_sphere": ["--num_poses", "60"],
    "bench_two_signature": ["--num_cameras", "6", "--num_points", "300"],
    "bench_scaling": ["--points", "400", "--cameras", "8", "--shards", "1", "2"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(name, *flags):
    module = SCRIPTS[name]
    return module.run(module.parse_args([*SMALL[name], *flags, *CPU]))


def _jax_bal(bal):
    return jbal.BalProblem(bal.cameras, bal.points, bal.camera_index, bal.point_index,
                           bal.observations)


def _keys(out, metric, extra):
    assert out["metric"] == metric
    assert {"metric", "value", "unit", "extra"} <= set(out)
    assert set(extra) <= set(out["extra"]), set(extra) - set(out["extra"])
    assert out["extra"]["device"] == "cpu" and "backend" not in out["extra"]
    json.loads(json.dumps(out))


def _steps(s):
    return s.num_successful_steps + s.num_unsuccessful_steps


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_without_a_card_the_default_device_raises(name, monkeypatch):
    """No ``--device``: the script resolves ``cuda``, finds no card and
    raises before any scene is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    module = SCRIPTS[name]
    built = []
    monkeypatch.setattr(tbal, "synthetic_bal", lambda *a, **k: built.append(a))
    monkeypatch.setattr(tg2o, "synthetic_sphere", lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run(module.parse_args(SMALL[name]))
    assert not built


def test_bench_sphere_matches_jax():
    """``tools/bench_sphere.py:47-56``: CGNR, every tolerance 0."""
    out = _run("bench_sphere")
    args = bench_sphere.parse_args([*SMALL["bench_sphere"], *CPU])
    graph = tg2o.synthetic_sphere(num_poses=args.num_poses)
    jgraph = jg2o.PoseGraph3D(graph.poses, graph.ids, graph.edges, graph.t_ab, graph.q_ab,
                              graph.sqrt_information)
    ref = st.solve(JOptions(linear_solver_type=JLinearSolverType.CGNR,
                            max_num_iterations=args.iters, function_tolerance=0.0,
                            gradient_tolerance=0.0, parameter_tolerance=0.0),
                   jg2o.build_pose_graph_problem(jgraph)[0])
    assert out["extra"]["steps"] == _steps(ref)
    np.testing.assert_allclose(out["extra"]["initial_chi2"], 2 * ref.initial_cost, rtol=RTOL)
    np.testing.assert_allclose(out["extra"]["final_chi2"], 2 * ref.final_cost, rtol=RTOL)
    assert out["extra"]["final_chi2"] < 0.5 * out["extra"]["initial_chi2"]
    _keys(out, "sphere_pose_graph_lm_steps_per_sec",
          ("poses", "edges", "steps", "minimizer_seconds", "initial_chi2", "final_chi2",
           "termination"))
    assert out["extra"]["edges"] == len(graph.edges)


def _jax_two_signature(bal, name):
    """``make_plain``, ``make_prior`` and ``make_split`` of
    ``tools/bench_two_signature.py:72-131``."""
    if name == "plain":
        return jbal.build_bal_problem(bal)[0]
    if name == "prior":
        problem, cameras, _ = jbal.build_bal_problem(bal)

        def camera_prior(params, data):
            (cam,) = params
            return 0.1 * (cam - data)

        problem.add_residual_blocks(
            camera_prior, None, [(cameras, np.arange(bal.num_cameras, dtype=np.int32))],
            data=bal.cameras.copy(), name="camera_prior")
        return problem
    problem = JProblem()
    poses = problem.add_parameter_block_array(bal.cameras[:, :6].copy(), name="poses")
    intr = problem.add_parameter_block_array(bal.cameras[:, 6:].copy(), name="intrinsics")
    points = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(poses, 1)
    problem.set_schur_elimination_group(intr, 1)

    def split_reproj(params, observation):
        pose, k, point = params
        p = jrot.angle_axis_rotate_point(pose[0:3], point) + pose[3:6]
        xp = -p[0] / p[2]
        yp = -p[1] / p[2]
        r2 = xp * xp + yp * yp
        distortion = 1.0 + r2 * (k[1] + k[2] * r2)
        return jnp.stack([k[0] * distortion * xp - observation[0],
                          k[0] * distortion * yp - observation[1]])

    problem.add_residual_blocks(
        split_reproj, None,
        [(poses, bal.camera_index), (intr, bal.camera_index), (points, bal.point_index)],
        data=bal.observations, name="split_snavely")
    return problem


@pytest.mark.parametrize("variant", ["plain", "prior", "split"])
def test_bench_two_signature_matches_jax(variant, capsys):
    """Each variant alone, ITERATIVE_SCHUR with SCHUR_JACOBI
    (``tools/bench_two_signature.py:136-144``)."""
    out = _run("bench_two_signature", "--variants", variant)
    args = bench_two_signature.parse_args([*SMALL["bench_two_signature"], *CPU])
    bal = _jax_bal(tbal.synthetic_bal(args.num_cameras, args.num_points, args.obs_per_point))
    ref = st.solve(JOptions(linear_solver_type=JLinearSolverType.ITERATIVE_SCHUR,
                            preconditioner_type=JPreconditionerType.SCHUR_JACOBI,
                            max_num_iterations=args.iters, evaluation_chunk_size=args.chunk,
                            function_tolerance=0.0, gradient_tolerance=0.0,
                            parameter_tolerance=0.0),
                   _jax_two_signature(bal, variant))
    lines = capsys.readouterr().out.splitlines()
    solve = json.loads(next(ln for ln in lines if ln.startswith("[bench_two_signature] solve"))
                       .split(" ", 2)[2])
    assert solve["steps"] == _steps(ref) == 6
    np.testing.assert_allclose(solve["initial_cost"], ref.initial_cost, rtol=RTOL)
    result = out["extra"]["results"][variant]
    np.testing.assert_allclose(result["final_cost"], ref.final_cost, rtol=RTOL)
    assert set(result) == {"sec_per_step", "linear_solver_sec", "final_cost", "wall_incl_compile"}
    assert out["metric"] == "two_signature_step_time"
    assert set(out["extra"]) == {"results", "vs_plain", "device"}
    assert any(ln.startswith(f"[bench_two_signature] {variant} camera_padded_layout: batch 0: off")
               for ln in lines)


def test_bench_scaling_rows_match_the_unsharded_jax_solve():
    """Every row (1 shard in the process, 2 gloo ranks on the CPU) against
    the unsharded JAX solve of ``tools/bench_scaling.py:78-89``."""
    out = _run("bench_scaling")
    args = bench_scaling.parse_args([*SMALL["bench_scaling"], *CPU])
    bal = _jax_bal(tbal.synthetic_bal(args.cameras, args.points, args.obs_per_point))
    ref = st.solve(JOptions(linear_solver_type=JLinearSolverType.ITERATIVE_SCHUR,
                            max_num_iterations=args.iters, function_tolerance=0.0,
                            gradient_tolerance=0.0, parameter_tolerance=0.0),
                   jbal.build_bal_problem(bal)[0])
    strong, weak = out["strong"], out["weak"]
    assert [row["shards"] for row in strong["extra"]["rows"]] == [1, 2]
    for row in strong["extra"]["rows"]:
        assert row["steps"] == _steps(ref) == 6
        np.testing.assert_allclose(row["final_cost"], ref.final_cost, rtol=RTOL)
    _keys(strong, "strong_scaling_step_time_ratio", ("rows", "obs", "physical_cpus"))
    _keys(weak, "weak_scaling_step_time_ratio",
          ("small_sec_per_step", "sharded_sec_per_step", "small_obs"))
    assert weak["extra"]["small_obs"] == 200 * 4 and strong["extra"]["obs"] == 400 * 4


def test_main_prints_the_result_last(capsys):
    """``main()``: the JSON result is the last line, after the device and
    the solve lines."""
    bench_sphere.main([*SMALL["bench_sphere"], "--iters", "2", *CPU])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["metric"] == "sphere_pose_graph_lm_steps_per_sec" and out["extra"]["steps"] == 2
    assert lines[0] == 'device: "cpu"'
    assert any(ln.startswith("[bench_sphere] solve {") for ln in lines[:-1])
    assert bench_common.device_info(torch.device("cpu")) == "cpu"
