"""The port's ``obs`` mesh on torch.distributed (``parallel/``, the sharded
evaluator, reductions and explicit S, every solver under a mesh) against
the JAX package on ``Mesh(jax.devices()[:4], ("obs",))`` and against the
port's own single-device run. float64 on the CPU.

This file is also its own worker: ``python tests/test_torch_mesh.py --rank
r --world n --store PATH --out DIR`` is one gloo rank that imports torch
and the port only, runs every case on the mesh and writes its results to
``DIR/rank<r>.npz``. The ranks are spawned once for the module (a
file store in ``tmp_path``, so that xdist workers never race for a port),
and the tests compare what they wrote. The scene is
``tests/test_sharding.py``'s (6 cameras, 50 points, 3 observations a
point: 150 rows, split 38/38/38/36 over 4 ranks)."""

import argparse
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

N_RANKS = 4
SCENE = (6, 50, 3)
# a scene whose rows are not grouped by point: its rows shuffled, so
# most of its 200 points straddle a shard boundary
SHUFFLED_SCENE = (6, 200, 3)

# every solve of the worker: options by enum name, the same in both packages
_COMMON = dict(max_num_iterations=10, initial_trust_region_radius=1.0)
SOLVES = {
    "dense_schur": dict(linear_solver_type="DENSE_SCHUR"),
    "iterative_explicit": dict(linear_solver_type="ITERATIVE_SCHUR",
                               preconditioner_type="SCHUR_JACOBI",
                               use_explicit_schur_complement=True),
    "iterative_implicit": dict(linear_solver_type="ITERATIVE_SCHUR",
                               preconditioner_type="SCHUR_JACOBI"),
    "power_series": dict(linear_solver_type="ITERATIVE_SCHUR",
                         preconditioner_type="POWER_SERIES_EXPANSION"),
    "cluster_jacobi": dict(linear_solver_type="ITERATIVE_SCHUR",
                           preconditioner_type="CLUSTER_JACOBI", cluster_jacobi_size=2),
    "cluster_tridiagonal": dict(linear_solver_type="ITERATIVE_SCHUR",
                                preconditioner_type="CLUSTER_TRIDIAGONAL",
                                cluster_jacobi_size=2),
    "device_loop": dict(linear_solver_type="DENSE_SCHUR", use_device_loop=True,
                        device_loop_chunk_iterations=5),
    "dense_qr": dict(linear_solver_type="DENSE_QR"),
    "dense_qr_device_loop": dict(linear_solver_type="DENSE_QR", use_device_loop=True,
                                 device_loop_chunk_iterations=5),
    "dense_normal_cholesky": dict(linear_solver_type="DENSE_NORMAL_CHOLESKY"),
    # CGNR's PCG on this gauge-free scene's normal equations ends a step
    # apart between summation orders from step 6 on, even between the two
    # packages on one device (ROADMAP Queue 3 note f): its first 5 steps
    "cgnr": dict(linear_solver_type="CGNR", max_num_iterations=5),
    "dogleg": dict(linear_solver_type="DENSE_SCHUR", trust_region_strategy_type="DOGLEG"),
    "subspace_dogleg": dict(linear_solver_type="DENSE_SCHUR",
                            trust_region_strategy_type="DOGLEG",
                            dogleg_type="SUBSPACE_DOGLEG"),
    "inner_iterations": dict(linear_solver_type="DENSE_SCHUR", use_inner_iterations=True),
    "line_search": dict(minimizer_type="LINE_SEARCH", line_search_direction_type="LBFGS",
                        max_num_iterations=20),
}
# the row fields of a Summary that the comparisons read
ROW_FIELDS = ("cost", "trust_region_radius", "step_norm", "gradient_max_norm",
              "linear_solver_iterations", "step_is_valid", "step_is_successful")


def _options_kw(types_module, kw):
    """``kw`` with each enum given by its name turned into the package's
    own enum."""
    enums = dict(linear_solver_type="LinearSolverType",
                 preconditioner_type="PreconditionerType",
                 trust_region_strategy_type="TrustRegionStrategyType",
                 dogleg_type="DoglegType", minimizer_type="MinimizerType",
                 line_search_direction_type="LineSearchDirectionType")
    out = dict(_COMMON)
    for k, v in kw.items():
        out[k] = getattr(getattr(types_module, enums[k]), v) if k in enums else v
    return out


def _summary_arrays(prefix, summary, cams, pts):
    rows = np.array([[float(getattr(it, f)) for f in ROW_FIELDS] for it in summary.iterations])
    return {
        f"{prefix}/rows": rows,
        f"{prefix}/cams": np.asarray(cams, dtype=np.float64),
        f"{prefix}/pts": np.asarray(pts, dtype=np.float64),
        f"{prefix}/final_cost": np.float64(summary.final_cost),
        f"{prefix}/termination": np.array(summary.termination_type.value),
        f"{prefix}/path": np.array(str(summary.schur_complement_path)),
        f"{prefix}/num_devices": np.int64(summary.num_devices),
    }


def _shuffled(bal):
    """``bal`` with its observation rows in a fixed random order."""
    perm = np.random.default_rng(0).permutation(bal.num_observations)
    for name in ("camera_index", "point_index", "observations"):
        setattr(bal, name, getattr(bal, name)[perm])
    return bal


# -- the worker: one rank (torch and the port only) ------------------------------------


def _worker(rank, world, store, out):
    import torch.distributed as dist

    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core import types as ttypes
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.io import bal as tbal
    from skeres_tpu_torch.parallel import initialize_distributed, make_obs_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo", device_type="cpu")
    mesh = make_obs_mesh(device_type="cpu")
    res = {}

    # the sharded evaluation and reductions
    problem, _, _ = tbal.build_bal_problem(tbal.synthetic_bal(*SCENE))
    program = problem.compile()
    ev = Evaluator(program, "cpu", torch.float64, mesh=mesh)
    state = program.initial_state("cpu", torch.float64)
    cost, blocks = ev.blocks(state)
    g, diag = ev.gradient_and_diag(blocks)
    jd, rd = ev.jacobian_dense(blocks)
    res.update({"eval/cost": cost.numpy(), "eval/cost_only": ev.cost(state).numpy(),
                "eval/g": g.numpy(), "eval/diag": diag.numpy(),
                "eval/jtj": ev.jtj_dense(blocks).numpy(), "eval/jd": jd.numpy(),
                "eval/rd": rd.numpy(), "eval/rows": np.array(ev.row_range[0])})

    # the sharded explicit S and its right-hand side
    schur = SchurSolver(ev, iterative=False)
    plan = schur.explicit_plan
    d = lm_diagonal(diag, 1e-4, 1e-6, 1e32)
    asm = schur._assemble(schur.prepare(schur.solver_data(blocks)), g, d)
    res.update({"explicit/s": schur._dense_s_explicit(asm).numpy(),
                "explicit/rhs": schur._schur_rhs(asm).numpy(),
                "explicit/n_straddle": np.int64(plan.n_straddle),
                "explicit/path": np.array(schur.schur_path)})
    res.update({f"explicit/points_{s}": p for s, p in enumerate(plan.shard_points)})

    # every solver and minimizer through stt.solve
    for name, kw in SOLVES.items():
        problem, cams, pts = tbal.build_bal_problem(tbal.synthetic_bal(*SCENE))
        summary = stt.solve(stt.SolverOptions(device="cpu", mesh=mesh,
                                              **_options_kw(ttypes, kw)), problem)
        res.update(_summary_arrays(name, summary, cams.values, pts.values))

    # rows not grouped by point: the straddle limit rejects the explicit plan
    problem, cams, pts = tbal.build_bal_problem(_shuffled(tbal.synthetic_bal(*SHUFFLED_SCENE)))
    ev = Evaluator(problem.compile(), "cpu", torch.float64, mesh=mesh)
    res["shuffled/reason"] = np.array(str(SchurSolver(ev).explicit_reject_reason))
    summary = stt.solve(stt.SolverOptions(device="cpu", mesh=mesh, **_options_kw(
        ttypes, dict(linear_solver_type="DENSE_SCHUR"))), problem)
    res.update(_summary_arrays("shuffled", summary, cams.values, pts.values))

    # a world smaller than the mesh asked for
    try:
        make_obs_mesh(world + 1, device_type="cpu")
        res["too_big/error"] = np.array("")
    except ValueError as exc:
        res["too_big/error"] = np.array(str(exc))

    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _worker(a.rank, a.world, a.store, a.out)
    sys.exit(0)


# -- the tests (pytest process: both packages) -------------------------------------------

import jax  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import skeres_tpu as st  # noqa: E402
import skeres_tpu_torch as stt  # noqa: E402
from skeres_tpu.core import types as jtypes  # noqa: E402
from skeres_tpu.core.options import SolverOptions as JOptions  # noqa: E402
from skeres_tpu.io import bal as jbal  # noqa: E402
from skeres_tpu_torch.core import types as ttypes  # noqa: E402
from skeres_tpu_torch.io import bal as tbal  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: the ranks spawned once, every case in one
    spawn."""
    tmp = tmp_path_factory.mktemp("mesh")
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(N_RANKS),
         "--store", str(tmp / "store"), "--out", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root))
        for r in range(N_RANKS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)]


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:N_RANKS]), axis_names=("obs",))


def _jax_solve(kw, mesh=None, **extra):
    problem, cams, pts = jbal.build_bal_problem(jbal.synthetic_bal(*SCENE))
    s = st.solve(JOptions(mesh=mesh, **_options_kw(jtypes, kw), **extra), problem)
    return _summary_arrays("jax", s, cams.values, pts.values)


def _port_solve(kw):
    problem, cams, pts = tbal.build_bal_problem(tbal.synthetic_bal(*SCENE))
    s = stt.solve(stt.SolverOptions(device="cpu", **_options_kw(ttypes, kw)), problem)
    return _summary_arrays("port", s, cams.values, pts.values)


def _assert_same_run(mine, name, ref, rtol):
    """Rank 0's run ``name`` against a reference run: the same decisions
    and PCG counts, costs and radii at ``rtol`` a step, the solution at
    100 ``rtol``."""
    a, b = mine[f"{name}/rows"], ref[[k for k in ref if k.endswith("/rows")][0]]
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a[:, 4:], b[:, 4:])
    np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=rtol)
    for key in ("cams", "pts"):
        ref_key = [k for k in ref if k.endswith(f"/{key}")][0]
        np.testing.assert_allclose(mine[f"{name}/{key}"], ref[ref_key], rtol=100 * rtol,
                                   atol=1e-9)
    assert str(mine[f"{name}/termination"]) == str(ref[[k for k in ref
                                                          if k.endswith("/termination")][0]])


def test_every_rank_returns_rank_zeros_results_bit_for_bit(ranks):
    """Every rank's Summary rows, solution and reduced values equal rank
    0's, bit for bit; only the rank's own rows differ."""
    own = {"eval/rows"}
    for r in range(1, N_RANKS):
        assert ranks[r].keys() == ranks[0].keys()
        for k, v in ranks[0].items():
            if k not in own:
                np.testing.assert_array_equal(ranks[r][k], v, err_msg=f"rank {r}: {k}")
    assert [tuple(x["eval/rows"]) for x in ranks] == [(0, 38), (38, 76), (76, 114), (114, 150)]


def test_sharded_cost_gradient_diag_match_jax_mesh_and_one_device(ranks, jmesh):
    from skeres_tpu.core.evaluator import Evaluator as JEvaluator
    from skeres_tpu_torch.core.evaluator import Evaluator

    mine = ranks[0]
    program = jbal.build_bal_problem(jbal.synthetic_bal(*SCENE))[0].compile()
    ev = JEvaluator(program, mesh=jmesh)
    state = ev.prepare_state(program.initial_state(ev.dtype))
    cost, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)
    np.testing.assert_allclose(mine["eval/cost"], float(cost), rtol=1e-12)
    np.testing.assert_allclose(mine["eval/cost_only"], float(cost), rtol=1e-12)
    np.testing.assert_allclose(mine["eval/g"], np.asarray(g), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(mine["eval/diag"], np.asarray(diag), rtol=1e-12)

    tprogram = tbal.build_bal_problem(tbal.synthetic_bal(*SCENE))[0].compile()
    one = Evaluator(tprogram, "cpu", torch.float64)
    c1, b1 = one.blocks(tprogram.initial_state("cpu", torch.float64))
    g1, d1 = one.gradient_and_diag(b1)
    jd1, rd1 = one.jacobian_dense(b1)
    np.testing.assert_allclose(mine["eval/cost"], float(c1), rtol=1e-12)
    np.testing.assert_allclose(mine["eval/g"], g1.numpy(), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(mine["eval/diag"], d1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(mine["eval/jtj"], one.jtj_dense(b1).numpy(), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_array_equal(mine["eval/jd"], jd1.numpy())  # gathered, not summed
    np.testing.assert_array_equal(mine["eval/rd"], rd1.numpy())


def test_sharded_explicit_s_matches_jax_plan(ranks, jmesh):
    """S and its rhs against the JAX package's sharded explicit S (1e-10),
    and the straddle count and per-shard point lists of its
    ``_plan_sharded``."""
    from skeres_tpu.core.evaluator import Evaluator as JEvaluator
    from skeres_tpu.core.linear_solvers import lm_diagonal
    from skeres_tpu.core.schur import SchurSolver as JSchurSolver

    mine = ranks[0]
    program = jbal.build_bal_problem(jbal.synthetic_bal(*SCENE))[0].compile()
    ev = JEvaluator(program, mesh=jmesh)
    state = ev.prepare_state(program.initial_state(ev.dtype))
    cost, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)
    schur = JSchurSolver(ev, iterative=False)
    plan = schur.explicit_plan
    assert plan.mesh is not None
    data = schur.solver_data(blocks)
    d = lm_diagonal(diag, 1e-4, 1e-6, 1e32)

    def f(dd):
        asm = schur._assemble(data, g, dd)
        return schur._dense_s_explicit(asm), schur._schur_rhs(asm)

    s, rhs = jax.jit(f)(d)
    np.testing.assert_allclose(mine["explicit/s"], np.asarray(s), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(s)).max())
    np.testing.assert_allclose(mine["explicit/rhs"], np.asarray(rhs), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(rhs)).max())
    assert int(mine["explicit/n_straddle"]) == plan.n_straddle > 0
    assert str(mine["explicit/path"]) == schur.schur_path == "explicit"
    # the JAX plan's per-shard points: the grid rows whose first slot is a row
    src = np.asarray(plan.shard_grid_src).reshape(N_RANKS, plan.p_max, plan.kp)
    local_pt = np.asarray(plan.shard_local_pt)
    for s_ in range(N_RANKS):
        real = src[s_, :, 0] < plan.bs
        np.testing.assert_array_equal(mine[f"explicit/points_{s_}"], local_pt[s_][real])


@pytest.mark.parametrize("name,rtol", [("dense_schur", 1e-10), ("iterative_explicit", 1e-8)])
def test_schur_trajectories_match_jax_mesh_solve(ranks, jmesh, name, rtol):
    """DENSE_SCHUR (the explicit path under a mesh, as the JAX package's)
    and ITERATIVE_SCHUR on the explicit S, step by step against the JAX
    package's solve on its mesh and the port's single-device solve."""
    mine = ranks[0]
    assert str(mine[f"{name}/path"]) == "explicit"
    assert int(mine[f"{name}/num_devices"]) == N_RANKS
    _assert_same_run(mine, name, _jax_solve(SOLVES[name], jmesh), rtol)
    _assert_same_run(mine, name, _port_solve(SOLVES[name]), rtol)


def test_implicit_iterative_schur_matches_jax_mesh_solve(ranks, jmesh):
    """ITERATIVE_SCHUR with the implicit S against the JAX package's mesh
    solve at ``jacobian_sort_threshold=1``, which the port accepts and does
    not read (ROADMAP Queue 3, note d). On this 4-shard scene the JAX
    package's sharded camera-padded layout stays off at the default waste
    gate; opened (``jacobian_pad_waste`` 3 or more) its trajectory parts
    from the JAX package's own generic path (ROADMAP Queue 1, slice 8)."""
    mine = ranks[0]
    ref = _jax_solve(SOLVES["iterative_implicit"], jmesh, jacobian_sort_threshold=1)
    _assert_same_run(mine, "iterative_implicit", ref, 1e-8)
    _assert_same_run(mine, "iterative_implicit", _port_solve(SOLVES["iterative_implicit"]), 1e-8)


@pytest.mark.parametrize("name,rtol", [
    ("device_loop", 1e-10),
    ("dense_qr", 1e-8),
    ("dense_qr_device_loop", 1e-8),
    ("dense_normal_cholesky", 1e-8),
    ("cgnr", 1e-3),
    ("power_series", 1e-8),
    ("cluster_jacobi", 1e-8),
    ("dogleg", 1e-8),
    ("subspace_dogleg", 1e-8),
    ("inner_iterations", 1e-8),
    ("line_search", 1e-8),
])
def test_solver_under_mesh_matches_jax_and_one_device(ranks, name, rtol):
    """Each solver and minimizer under the mesh against the JAX package's
    solve and the port's single-device solve, at the tolerances of
    tests/test_torch_solve.py (CGNR's PCG drifts between summation orders,
    ROADMAP Queue 3 note f)."""
    mine = ranks[0]
    _assert_same_run(mine, name, _jax_solve(SOLVES[name]), rtol)
    _assert_same_run(mine, name, _port_solve(SOLVES[name]), rtol)


def test_cluster_tridiagonal_under_mesh_keeps_the_band(ranks):
    """CLUSTER_TRIDIAGONAL under the mesh equals the port's single-device
    run: the sharded plan keeps the band pairs, which the JAX package's
    sharded plan drops (ROADMAP Queue 3)."""
    _assert_same_run(ranks[0], "cluster_tridiagonal", _port_solve(SOLVES["cluster_tridiagonal"]),
                     1e-8)


def test_rows_not_grouped_by_point_hit_the_straddle_limit_like_jax(ranks, jmesh):
    """Shuffled rows: most points straddle a boundary, the explicit plan is
    rejected with the JAX package's reason, and DENSE_SCHUR takes the
    dense-W path (W reduced over the ranks), as the JAX package does."""
    from skeres_tpu.core.evaluator import Evaluator as JEvaluator
    from skeres_tpu.core.schur import SchurSolver as JSchurSolver

    mine = ranks[0]
    jprob, _, _ = jbal.build_bal_problem(_shuffled(jbal.synthetic_bal(*SHUFFLED_SCENE)))
    jschur = JSchurSolver(JEvaluator(jprob.compile(), mesh=jmesh))
    assert str(mine["shuffled/reason"]) == jschur.explicit_reject_reason
    assert "straddling" in str(mine["shuffled/reason"])
    assert str(mine["shuffled/path"]) == jschur.schur_path == "dense-W"
    tprob, cams, pts = tbal.build_bal_problem(_shuffled(tbal.synthetic_bal(*SHUFFLED_SCENE)))
    one = stt.solve(stt.SolverOptions(device="cpu", **_options_kw(
        ttypes, dict(linear_solver_type="DENSE_SCHUR"))), tprob)
    _assert_same_run(mine, "shuffled", _summary_arrays("one", one, cams.values, pts.values), 1e-10)


def test_world_smaller_than_the_mesh_raises(ranks):
    assert str(ranks[0]["too_big/error"]) == f"requested {N_RANKS + 1} devices, found {N_RANKS}"


def test_dryrun_multichip_on_four_cpu_ranks(monkeypatch):
    """The counterpart of tests/test_sharding.py::test_graft_dryrun_multichip:
    one sharded explicit-S LM step of the JAX entry's scene on 4 gloo
    ranks; every rank reports the same costs, and the step equals the
    port's single-device step."""
    from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.core.summary import Summary
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.parallel.dryrun import SCENE as DRY, dryrun_multichip

    reports = dryrun_multichip(N_RANKS)
    assert [r["rank"] for r in reports] == list(range(N_RANKS))
    for r in reports:
        assert r["n_straddle"] > 0 and r["path"] == "explicit" and r["s_rows"] == 1800
        assert (r["cost"], r["new_cost"]) == (reports[0]["cost"], reports[0]["new_cost"])
        assert r["new_cost"] < r["cost"]
    assert sum(r["rows"][1] - r["rows"][0] for r in reports) == 200_015

    from skeres_tpu_torch.core import schur as schur_mod

    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)  # the explicit path, as the ranks'
    program = tbal.build_bal_problem(tbal.synthetic_bal(**DRY))[0].compile()
    ev = Evaluator(program, "cpu", torch.float64)
    options = stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu")
    m = TrustRegionMinimizer(ev, options, Summary(), LinearSolverType.DENSE_SCHUR,
                             schur_solver=SchurSolver(ev))
    state = program.initial_state("cpu", torch.float64)
    cost, g, diag, data, scale, _, _ = m.linearize(state)
    new = m.solve_step(state, data, g, diag, scale, 1e4, torch.zeros((), dtype=torch.float64))[0]
    np.testing.assert_allclose(reports[0]["cost"], float(cost), rtol=1e-12)
    np.testing.assert_allclose(reports[0]["new_cost"], float(m.try_step(new)[0]), rtol=1e-10)
