"""The port on a 16-camera cut of the benchmark's ``bal-final-13682``
configuration (the same ring, tracks of 6 and 7, float64 on the CPU):
its ITERATIVE_SCHUR + SCHUR_JACOBI solve with chunked evaluation on the
camera-padded layout against the blocked plain reference
(``benchmark/reference/bal_lm_blocked.py``); the module-level implicit S
product that PCG reaches through ``SchurSolver._s_matvec``; evaluation in
chunks against one pass; and the SCHUR_JACOBI blocks taken a block of
cameras at a time against one pass."""

import math

import numpy as np
import pytest
import torch

import skeres_tpu_torch as stt
from benchmark import harness
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.schur import SchurSolver, implicit_s_product
from skeres_tpu_torch.ops import s_product as sp

CELL = "final13682.iterative-schur"
CUT = {"num_cameras": 16, "num_points": 120, "num_observations": 780,
       "track_lengths": {"6": 60, "7": 60}}
SEED = 2_718_281_828_459
CHUNK = 97  # rows an evaluation chunk: 9 chunks, the last short
PADDED = dict(jacobian_sort_threshold=1, jacobian_pad_waste=100.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene():
    cell = harness.load_cell(CELL)
    config = {**cell["config_data"], **CUT}
    mod = harness.load_module("scenes", config["generator"])
    return cell, mod, mod.generate(config, SEED, "cpu")


def _options(cell, **overrides):
    return harness.solver_options(cell, "cpu", "float64", evaluation_chunk_size=CHUNK,
                                  **PADDED, **overrides)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_solve_against_the_blocked_reference(scene):
    """The cell's options, 9 chunks a linearization, the layout on: the
    start and 4 accepted costs within 1e-10 of the reference's, the final
    cost within 1e-12 of the reference's cost at the final parameters."""
    cell, mod, sc = scene
    problem, handles = mod.build_problem(sc)
    s = stt.solve(_options(cell), problem)
    assert s.camera_padded_layout.startswith("batch 0: 16 x ")
    assert s.schur_complement_path.startswith("implicit")
    assert s.num_evaluation_chunks == math.ceil(780 / CHUNK) * s.num_jacobian_evaluations
    accepted = [it.cost for it in s.iterations if it.step_is_successful]
    reference = mod.make_reference(sc, "cpu")
    ref = reference.solve(sc.cameras, sc.points, cell["options"],
                          max_accepted=cell["path_accepted_steps"])
    assert len(ref["accepted_costs"]) == 5 and len(accepted) >= 5
    for a, b in zip(accepted[:5], ref["accepted_costs"]):
        assert _rel(a, b) <= 1e-10
    final = reference.cost(handles["cameras"].values, handles["points"].values)
    assert _rel(s.final_cost, final) <= 1e-12


def _linearized(sc, mod, chunk, **solver_kw):
    """A SchurSolver on the scene, its first linearization prepared as the
    minimizer prepares it, and a per-mu state."""
    program = mod.build_problem(sc)[0].compile()
    ev = Evaluator(program, "cpu", torch.float64, chunk_size=chunk)
    solver = SchurSolver(ev, iterative=True, sort_threshold=1, pad_waste=100.0, **solver_kw)
    state = program.initial_state("cpu", torch.float64)
    cost, blocks = ev.blocks(state)
    g, diag, cam_raw = solver.gradient_and_diag(blocks)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    prep = solver.prepare(solver.scale_data(solver.solver_data(blocks), scale), cam_raw=cam_raw,
                          scale=scale)
    d = lm_diagonal(diag * scale * scale, 1e-4, 1e-6, 1e32)
    return solver, ev, blocks, cost, g, diag, prep, solver._assemble(prep, g * scale, d)


def test_module_s_product(scene, monkeypatch):
    """``implicit_s_product`` is what ``_s_matvec`` returns, equal to the
    row-order block product ``_s_matmat`` to 1e-13, and PCG reaches it
    through the module's name, so that a wrapper of that name sees every
    product of a damped solve."""
    _, mod, sc = scene
    solver, _, _, _, g, diag, prep, asm = _linearized(sc, mod, CHUNK)
    v = torch.linspace(-1.0, 2.0, solver.num_f, dtype=torch.float64)
    sv = implicit_s_product(solver, asm, v)
    assert torch.equal(solver._s_matvec(asm, v), sv)
    block = solver._s_matmat(asm, v[:, None])[:, 0]
    assert float(torch.linalg.vector_norm(sv - block) / torch.linalg.vector_norm(block)) <= 1e-13
    calls = []

    def counting(*args):
        calls.append(1)
        return implicit_s_product(*args)

    monkeypatch.setattr(schur_mod, "implicit_s_product", counting)
    _, iterations, _ = solver.solve_damped(prep, g, diag, 1e-4, 1e-6, 1e32)
    assert int(iterations) >= 1 and len(calls) == int(iterations)


def test_chunked_evaluation_on_the_padded_layout(scene):
    """Evaluation in 9 chunks against one pass: the residuals, Jacobian
    rows, cost, gradient, diagonal and placed rows bit for bit; the
    prepared products within 1e-14."""
    _, mod, sc = scene
    one = _linearized(sc, mod, None)
    chunked = _linearized(sc, mod, CHUNK)
    assert one[1].num_evaluation_chunks == 1 and chunked[1].num_evaluation_chunks == 9
    (b1,), (b2,) = one[2], chunked[2]
    assert torch.equal(b1.r, b2.r) and torch.equal(b1.jac, b2.jac)
    assert b2.jac.is_contiguous() and b1.jac.is_contiguous()
    for k in (3, 4, 5):  # cost, g, diag
        assert torch.equal(one[k], chunked[k])
    assert torch.equal(one[6]["cam"][0], chunked[6]["cam"][0])
    v = torch.linspace(-1.0, 2.0, one[0].num_f, dtype=torch.float64)
    a, b = implicit_s_product(one[0], one[7], v), implicit_s_product(chunked[0], chunked[7], v)
    assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a)) <= 1e-14


@pytest.mark.parametrize("cameras_a_pass", [1, 5])
def test_padded_blocks_by_camera_blocks(scene, monkeypatch, cameras_a_pass):
    """The SCHUR_JACOBI blocks of the padded batch taken ``cameras_a_pass``
    cameras at a time against one pass, within 1e-14, and so the damped
    solve's step."""
    _, mod, sc = scene
    solver, _, _, _, g, diag, prep, asm = _linearized(sc, mod, CHUNK)
    whole = solver._schur_jacobi_blocks(asm)[0]
    step_whole = solver.solve_damped(prep, g, diag, 1e-4, 1e-6, 1e32)[0]
    K = solver.sorted_info[0]["K"]
    monkeypatch.setattr(sp, "PADDED_BLOCK_BYTES", cameras_a_pass * K * 81 * 8)
    parts = solver._schur_jacobi_blocks(asm)[0]
    assert float(torch.max(torch.abs(parts - whole)) / torch.max(torch.abs(whole))) <= 1e-14
    step = solver.solve_damped(prep, g, diag, 1e-4, 1e-6, 1e32)[0]
    assert float(torch.linalg.vector_norm(step - step_whole)
                 / torch.linalg.vector_norm(step_whole)) <= 1e-12


def test_no_index_map_for_the_observation_batch(scene):
    """The retained-index map of ``_add_other_batches`` is built for the
    batches it scatters into S, not for the observation batch."""
    _, mod, sc = scene
    program = mod.build_problem(sc)[0].compile()
    ev = Evaluator(program, "cpu", torch.float64)
    for iterative in (False, True):
        solver = SchurSolver(ev, iterative=iterative)
        assert solver.e_batch == 0 and "fidx" not in solver.batch_info[0]


def test_the_cell_file_and_its_cut(scene):
    """The cell reads the configuration at its published counts, uncut,
    with Ceres's 50 LM steps; the 16-camera cut keeps the ring's tracks."""
    cell, _, sc = scene
    config = cell["config_data"]
    counts = {int(k): v for k, v in config["track_lengths"].items()}
    assert (config["num_cameras"], config["num_points"], config["num_observations"]) == (
        13682, 4456117, 28987644)
    assert sum(counts.values()) == config["num_points"]
    assert sum(k * v for k, v in counts.items()) == config["num_observations"]
    assert config["reduced"] == []
    options = harness.solver_options(cell, "cpu", cell["dtype"])
    assert (options.max_num_iterations, options.evaluation_chunk_size) == (50, 1 << 20)
    assert math.ceil(config["num_observations"] / options.evaluation_chunk_size) == 28
    assert sc.observations.shape == (780, 2)
    assert np.array_equal(np.bincount(np.bincount(sc.point_index)), [0] * 6 + [60, 60])
    assert cell["checks"] == {"path_gap": 1e-9, "final_cost_gap": 1e-11}
