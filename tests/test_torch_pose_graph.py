"""The port's pose graphs (BASELINE config 3) against the JAX package's,
float64 on the CPU: the SE(2) and SE(3) residuals and their Jacobians on
random poses, g2o files written here loaded by both, the synthetic
sphere, a 200-pose sphere trajectory, the square loop converging to its
ground truth, and the gradient check on a small sphere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.io import g2o as jg2o
from skeres_tpu.models import pose_graph as jpg
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.gradient_checker import check_program_gradients
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType, TerminationType
from skeres_tpu_torch.io import g2o as tg2o
from skeres_tpu_torch.models import pose_graph as tpg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_edge(dim, seed):
    """Two random poses and a measurement (quaternions unit, xyzw)."""
    rng = np.random.default_rng(seed)
    if dim == 2:
        poses = [np.concatenate([rng.normal(size=2), rng.uniform(-np.pi, np.pi, 1)])
                 for _ in range(2)]
        L = np.triu(rng.normal(size=(3, 3))) + 3.0 * np.eye(3)
        data = dict(t_ab=rng.normal(size=2), yaw_ab=np.asarray(rng.uniform(-3.0, 3.0)),
                    sqrt_information=L)
    else:
        def quat():
            q = rng.normal(size=4)
            return q / np.linalg.norm(q)

        poses = [np.concatenate([rng.normal(size=3), quat()]) for _ in range(2)]
        L = np.triu(rng.normal(size=(6, 6))) + 3.0 * np.eye(6)
        data = dict(t_ab=rng.normal(size=3), q_ab=quat(), sqrt_information=L)
    return poses, data


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dim", [2, 3])
def test_residual_and_tangent_jacobian_match_jax(dim, seed):
    """The residual on random poses to rtol 1e-12, and its Jacobian through
    the SE(d) manifold's plus at the tangent origin (what the evaluator
    differentiates) to rtol 1e-10."""
    poses, data = _random_edge(dim, seed)
    jfn, tfn = (jpg.pose_graph_2d_error, tpg.pose_graph_2d_error) if dim == 2 else \
        (jpg.pose_graph_3d_error, tpg.pose_graph_3d_error)
    jm, tm = (jpg.se2_manifold(), tpg.se2_manifold()) if dim == 2 else \
        (jpg.se3_manifold(), tpg.se3_manifold())
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    td = {k: torch.as_tensor(v) for k, v in data.items()}
    jx = [jnp.asarray(p) for p in poses]
    tx = [torch.as_tensor(p) for p in poses]
    np.testing.assert_allclose(tfn(tuple(tx), td).numpy(), np.asarray(jfn(tuple(jx), jd)),
                               rtol=1e-12, atol=1e-14)
    t = jm.tangent_size

    def jf(delta):
        return jfn((jm.plus(jx[0], delta[:t]), jm.plus(jx[1], delta[t:])), jd)

    def tf(delta):
        return tfn((tm.plus(tx[0], delta[:t]), tm.plus(tx[1], delta[t:])), td)

    jj = np.asarray(jax.jacfwd(jf)(jnp.zeros(2 * t)))
    tj = torch.func.jacfwd(tf)(torch.zeros(2 * t, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(tj, jj, rtol=1e-10, atol=1e-12)


def test_angle_normalize_under_vmap_and_grad():
    """AngleManifold.normalize wraps to [-pi, pi) and passes the gradient
    through, batched under torch.func.vmap."""
    a = torch.tensor([-7.0, -np.pi, 0.3, np.pi, 9.5], dtype=torch.float64)
    out = torch.func.vmap(stt.AngleManifold.normalize)(a)
    np.testing.assert_allclose(out.numpy(), np.asarray(st.AngleManifold.normalize(
        jnp.asarray(a.numpy()))), rtol=0, atol=1e-15)
    g = torch.func.vmap(torch.func.grad(lambda x: stt.AngleManifold.normalize(x) ** 2))(a)
    np.testing.assert_allclose(g.numpy(), 2.0 * out.numpy(), rtol=1e-15)


def _square_loop():
    """tests/test_pose_graph.py's square loop: 4 poses, odometry and one
    loop closure, noisy start."""
    gt = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, np.pi / 2], [1.0, 1.0, np.pi],
                   [0.0, 1.0, -np.pi / 2]])
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int32)

    def rel(a, b):
        d = gt[b, :2] - gt[a, :2]
        c, s = np.cos(gt[a, 2]), np.sin(gt[a, 2])
        dyaw = gt[b, 2] - gt[a, 2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(dyaw), np.cos(dyaw))])

    meas = np.stack([rel(a, b) for a, b in edges])
    sqrt_info = np.broadcast_to(np.eye(3) * 10.0, (4, 3, 3)).copy()
    rng = np.random.default_rng(0)
    noisy = gt.copy()
    noisy[1:, :2] += rng.normal(0, 0.2, (3, 2))
    noisy[1:, 2] += rng.normal(0, 0.15, 3)
    return gt, dict(poses=noisy, ids=np.arange(4), edges=edges, measurements=meas,
                    sqrt_information=sqrt_info)


def _numbers(values) -> str:
    return " ".join(f"{v:.17g}" for v in values)


def _write_g2o_2d(path, g):
    iu = np.triu_indices(3)
    with open(path, "w") as f:
        for i, p in enumerate(g["poses"]):
            f.write(f"VERTEX_SE2 {i} {_numbers(p)}\n")
        for (a, b), m, L in zip(g["edges"], g["measurements"], g["sqrt_information"]):
            f.write(f"EDGE_SE2 {a} {b} {_numbers(np.concatenate([m, (L.T @ L)[iu]]))}\n")


def _write_g2o_3d(path, g):
    iu = np.triu_indices(6)
    with open(path, "w") as f:
        # vertices out of order: the loader sorts by id
        for i in reversed(range(len(g.poses))):
            f.write(f"VERTEX_SE3:QUAT {i} {_numbers(g.poses[i])}\n")
        for (a, b), t, q, L in zip(g.edges, g.t_ab, g.q_ab, g.sqrt_information):
            f.write(f"EDGE_SE3:QUAT {a} {b} {_numbers(np.concatenate([t, q, (L.T @ L)[iu]]))}\n")


def _assert_same_graph(a, b):
    assert type(a).__name__ == type(b).__name__
    for name in ("poses", "ids", "edges", "measurements", "t_ab", "q_ab", "sqrt_information"):
        if hasattr(a, name):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_g2o_files_load_as_in_jax(tmp_path):
    _, g = _square_loop()
    _write_g2o_2d(tmp_path / "square.g2o", g)
    _assert_same_graph(tg2o.load_g2o(str(tmp_path / "square.g2o")),
                       jg2o.load_g2o(str(tmp_path / "square.g2o")))
    sphere = jg2o.synthetic_sphere(num_poses=20, loops_every=7)
    _write_g2o_3d(tmp_path / "sphere.g2o", sphere)
    loaded = tg2o.load_g2o(str(tmp_path / "sphere.g2o"))
    _assert_same_graph(loaded, jg2o.load_g2o(str(tmp_path / "sphere.g2o")))
    np.testing.assert_allclose(loaded.poses, sphere.poses, rtol=1e-12)
    (tmp_path / "empty.g2o").write_text("VERTEX_XY 0 1.0 2.0\n")
    with pytest.raises(ValueError, match="no supported g2o records"):
        tg2o.load_g2o(str(tmp_path / "empty.g2o"))


@pytest.mark.parametrize("kw", [dict(num_poses=2500), dict(num_poses=200, loops_every=15, seed=3)])
def test_synthetic_sphere_equals_jax(kw):
    t, j = tg2o.synthetic_sphere(**kw), jg2o.synthetic_sphere(**kw)
    _assert_same_graph(t, j)
    if kw["num_poses"] == 2500:  # sphere2500's size: 2499 odometry edges, 49 closures
        assert t.poses.shape == (2500, 7) and t.edges.shape == (2548, 2)


@pytest.fixture(scope="module")
def sphere200():
    return jg2o.synthetic_sphere(num_poses=200, loops_every=15)


@pytest.mark.parametrize("solver,rtol", [("DENSE_NORMAL_CHOLESKY", 1e-8),
                                         ("SPARSE_NORMAL_CHOLESKY", 1e-3)])
def test_sphere_trajectory_matches_jax(sphere200, solver, rtol):
    """A 200-pose sphere, 10 LM steps: the same decisions and costs to rtol
    1e-8, and the same poses. SPARSE_NORMAL_CHOLESKY routes to CGNR in both
    packages: from the fourth step its PCG takes 134-500 iterations a
    solve, and the two summation orders' iterates drift apart, to 3.6e-4 in
    the costs (ROADMAP Queue 3 note f; the card's phase 17 holds CGNR to
    1e-3 too). The quaternions stay unit and pose 0 stays where it was."""
    kw = dict(max_num_iterations=10, run_full_iteration_budget=True)
    jprob, jposes = jg2o.build_pose_graph_problem(sphere200)
    js = st.solve(JOptions(linear_solver_type=JLinearSolverType[solver], **kw), jprob)
    tprob, tposes = tg2o.build_pose_graph_problem(sphere200)
    ts = stt.solve(SolverOptions(linear_solver_type=LinearSolverType[solver], device="cpu", **kw),
                   tprob)
    assert ts.linear_solver_type_used.value == js.linear_solver_type_used.value
    assert len(ts.iterations) == len(js.iterations) == 11
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol)
    assert ts.final_cost < 0.5 * ts.initial_cost
    if solver == "DENSE_NORMAL_CHOLESKY":
        np.testing.assert_allclose(tposes.values, np.asarray(jposes.values), rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(tposes.values[:, 3:], axis=1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(tposes.values[0], sphere200.poses[0])


def test_square_loop_converges_to_ground_truth():
    gt, g = _square_loop()
    problem, poses = tg2o.build_pose_graph_problem(tg2o.PoseGraph2D(**g))
    s = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
                                max_num_iterations=50, device="cpu"), problem)
    assert s.termination_type == TerminationType.CONVERGENCE, s.message
    np.testing.assert_allclose(poses.values[:, :2], gt[:, :2], atol=1e-6)
    dyaw = np.arctan2(np.sin(poses.values[:, 2] - gt[:, 2]), np.cos(poses.values[:, 2] - gt[:, 2]))
    np.testing.assert_allclose(dyaw, 0.0, atol=1e-6)


def test_sphere_gradient_check_passes():
    problem, _ = tg2o.build_pose_graph_problem(tg2o.synthetic_sphere(num_poses=12, loops_every=5))
    program = problem.compile()
    ok, msg = check_program_gradients(program, Evaluator(program, device="cpu"))
    assert ok, msg
