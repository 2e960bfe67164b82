"""Visibility clustering in the port (``core/visibility.py``) and the
cluster preconditioners on its clusters (``core/schur.py``
``cluster_preconditioner`` / ``apply_cluster_preconditioner``), on small
cuts of the benchmark's ``bal-final-4585`` site scene with its cameras
relabelled by the seed, float64 on the CPU:

- the clusters, the forest and the chains against the plain reference's
  (``benchmark/reference/visibility.py``), up to cluster labels, for both
  clustering types;
- the slot sizes;
- the apply against the dense inverse of S kept on the forest's blocks
  (the clusters and the blocks between neighbours on a chain);
- a solve's start, 4 accepted steps and final cost against the plain
  reference (``benchmark/reference/bal_lm_cluster.py``), and that the
  reference on index-range clusters fails the cell's ``path_gap``;
- fewer PCG iterations on visibility clusters than on index ranges;
- the option's enum from a cell file or a string, the refusals, and the
  spans and counters of a profiled solve.
"""

import functools
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import skeres_tpu_torch as stt
from benchmark import harness
from benchmark.reference import visibility as ref_vis
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core import visibility as vis
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.types import PreconditionerType as P
from skeres_tpu_torch.core.types import VisibilityClusteringType as V

CELL = "final4585.cluster-tridiagonal"
CUT = {"num_cameras": 120, "num_points": 1500, "num_observations": 9500,
       "track_lengths": {"6": 1000, "7": 500}}
ASSUMED = {"num_sites": 4, "min_site_cameras": 14, "track_spacing_cameras": 24}
# the cell's bridges tie this cut's sites into one chain; without them each
# site is a chain of its own (and a component of the camera graph)
APART = {**ASSUMED, "bridge_share": 0.0}
SEEDS = [2_718_281_828_459, 3_141_592_653_589]
MU = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scene(seed, apart=False):
    cell = harness.load_cell(CELL)
    config = {**cell["config_data"], **CUT}
    config["assumed"] = {**config["assumed"], **(APART if apart else ASSUMED)}
    mod = harness.load_module("scenes", config["generator"])
    return cell, mod, mod.generate(config, seed, "cpu")


def _indices(sc):
    return (torch.as_tensor(sc.camera_index).long(), torch.as_tensor(sc.point_index).long())


def _camera_sets(cluster, chains):
    """The chains as tuples of camera sets, each read from its lower end;
    and the clusters as a set of camera sets."""
    cluster = np.asarray(cluster)
    sets = {k: frozenset(np.nonzero(cluster == k)[0].tolist()) for k in range(cluster.max() + 1)}
    seqs = [tuple(sets[k] for k in chain) for chain in chains]
    key = lambda s: sorted(min(c) for c in s)  # noqa: E731
    seqs = sorted((min(s, s[::-1], key=lambda q: [min(c) for c in q]) for s in seqs), key=key)
    return set(sets.values()), seqs


@pytest.mark.parametrize("seed,apart", [(SEEDS[0], False), (SEEDS[1], True)])
@pytest.mark.parametrize("kind", ["CANONICAL_VIEWS", "SINGLE_LINKAGE"])
def test_clusters_and_chains_match_the_reference(kind, seed, apart):
    """The same partition of the cameras, the same chains (the forest's
    paths) up to labels and direction; clusters numbered chain by chain."""
    _, _, sc = _scene(seed, apart)
    cam, pt = _indices(sc)
    nc, npt = CUT["num_cameras"], CUT["num_points"]
    got = vis.plan_visibility(cam, pt, nc, npt, kind, chains=True)
    want = ref_vis.clusters_and_chains(cam, pt, nc, kind, chains=True)
    assert _camera_sets(got.cluster_of.numpy(), got.chains) == _camera_sets(*want)
    flat = [c for chain in got.chains for c in chain]
    assert flat == list(range(got.num_clusters))
    assert got.chain_of.tolist() == [k for k, ch in enumerate(got.chains) for _ in ch]
    assert list(got.sizes) == np.bincount(got.cluster_of.numpy()).tolist()
    if kind == "CANONICAL_VIEWS":
        # clusters of views, not of camera numbers; apart, a chain a site
        assert len(got.chains) == (ASSUMED["num_sites"] if apart else 1)
        assert got.num_centers == got.num_clusters and got.longest_chain > 1
        spans = [np.ptp(np.nonzero(got.cluster_of.numpy() == k)[0]) + 1
                 for k in range(got.num_clusters)]
        assert max(spans) > 2 * got.sizes.max()


def test_single_clusters_without_chains():
    """CLUSTER_JACOBI asks for no forest: every cluster a chain of its own."""
    _, _, sc = _scene(SEEDS[0])
    got = vis.plan_visibility(*_indices(sc), CUT["num_cameras"], CUT["num_points"],
                              "CANONICAL_VIEWS", chains=False)
    assert got.longest_chain == 1 and len(got.chains) == got.num_clusters


@pytest.mark.parametrize("sizes", [[5], [3, 3, 4], [1, 1, 1, 100], [1, 2, 3, 50, 60, 200],
                                   list(range(1, 30)), [7, 8, 9, 40, 41, 41, 150, 151]])
def test_slot_sizes_are_few_and_pad_under_twice(sizes):
    """Each cluster in the smallest slot that holds it; the padded rows
    under twice the real ones; no fewer slot sizes could do (every choice
    of one fewer from the cluster sizes pads twice or more)."""
    slots = vis.slot_sizes(sizes)
    chosen = sorted(set(slots.tolist()))
    assert (slots >= sizes).all() and slots.sum() < 2 * sum(sizes)
    assert all(s == min(c for c in chosen if c >= n) for s, n in zip(slots, sizes))
    distinct = sorted(set(sizes))
    for fewer in itertools.combinations(distinct[:-1], max(len(chosen) - 2, 0)):
        if len(chosen) == 1:
            break
        pick = sorted(fewer) + [distinct[-1]]
        assert sum(min(c for c in pick if c >= n) for n in sizes) >= 2 * sum(sizes)


def _solver(seed, pad_limit, monkeypatch, apart=False, **kw):
    """A SchurSolver on the scene with its first linearization and a
    per-mu state, as ``test_torch_cluster_precond.py`` builds them."""
    _, mod, sc = _scene(seed, apart)
    monkeypatch.setattr(vis, "PAD_LIMIT", pad_limit)
    problem, _ = mod.build_problem(sc)
    ev = Evaluator(problem.compile(), device="cpu")
    _, blocks = ev.blocks(ev.program.initial_state("cpu", torch.float64))
    g, diag = ev.gradient_and_diag(blocks)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    g, diag = g * scale, diag * scale**2

    def make(**skw):
        s = SchurSolver(ev, **skw)
        data = s.prepare(s.scale_data(s.solver_data(blocks), scale))
        return s, s._assemble(data, g, lm_diagonal(diag, MU, 1e-6, 1e32)), data, g, diag

    return make(**kw), make


@pytest.mark.parametrize("pad_limit", [2.0, 1.0])
@pytest.mark.parametrize("name", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_apply_is_the_inverse_of_the_forest_blocks(name, pad_limit, monkeypatch):
    """The apply equals the dense inverse of S kept where two cameras share
    a cluster or (CLUSTER_TRIDIAGONAL) lie in neighbouring clusters of one
    chain, to 1e-12 of the solution's norm; a chain a site, so each step
    runs on several chains; with ``PAD_LIMIT`` 1 every cluster size is a
    slot size of its own, so the steps mix slot sizes."""
    (t, tasm, *_), make = _solver(SEEDS[0], pad_limit, monkeypatch, apart=True, iterative=True,
                                 preconditioner=P[name], visibility_clustering=V.CANONICAL_VIEWS)
    dense, dasm, *_ = make()
    s = dense._dense_s(dasm)
    cl, chain = t.visibility.cluster_of, t.visibility.chain_of
    k = cl[torch.arange(CUT["num_cameras"]).repeat_interleave(9)]
    keep = k[:, None] == k[None, :]
    if name == "CLUSTER_TRIDIAGONAL":
        keep |= ((k[:, None] - k[None, :]).abs() == 1) & (chain[k][:, None] == chain[k][None, :])
        steps = t.cluster_layout.steps
        # a step runs several chains, or mixes slot sizes at one position
        assert (max(len(st.cur) for st in steps) > 1 if pad_limit == 2.0
                else len(steps) > t.visibility.longest_chain - 1)
    if pad_limit == 1.0:
        assert len(t.visibility.slot_sizes) > 1 and t.visibility.padded_share == 0.0
    m = torch.where(keep, s, 0.0)
    v = torch.tensor(np.random.default_rng(5).standard_normal(t.num_f))
    want = torch.linalg.solve(m, v)
    factors = schur_mod.cluster_preconditioner(t, tasm)
    got = schur_mod.apply_cluster_preconditioner(t, factors, v)
    assert factors["band_scale"] == 1.0
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-12
    plain = schur_mod.dense_cluster_solve(t, tasm, v)
    assert float(torch.linalg.norm(plain - want) / torch.linalg.norm(want)) <= 1e-12


def test_a_failed_pivot_halves_the_band(monkeypatch):
    """Where a pivot fails rung 0 (here the first one, told so), S kept on
    the forest's blocks is taken as not positive definite and the factor is
    made again, by the whole ladder, with the band halved (Ceres's retry,
    positive definite by Kushal and Agarwal's Lemma 1); the apply is then
    the inverse of that matrix."""
    (t, tasm, *_), _ = _solver(SEEDS[0], 2.0, monkeypatch, apart=True, iterative=True,
                              preconditioner=P.CLUSTER_TRIDIAGONAL,
                              visibility_clustering=V.CANONICAL_VIEWS)
    real, calls = t._robust_linv_rung0, []

    def first_fails(mats, dmax, ladder=True):
        linv, ok = real(mats, dmax, ladder)
        calls.append(len(calls))
        return linv, ok & (len(calls) > 1)

    monkeypatch.setattr(t, "_robust_linv_rung0", first_fails)
    factors = schur_mod.cluster_preconditioner(t, tasm)
    assert factors["band_scale"] == 0.5
    v = torch.tensor(np.random.default_rng(6).standard_normal(t.num_f))
    got = schur_mod.apply_cluster_preconditioner(t, factors, v)
    want = schur_mod.dense_cluster_solve(t, tasm, v, band_scale=0.5)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-12


def _rel(a, b):
    return abs(a - b) / abs(b)


def _solve(seed, **overrides):
    cell, mod, sc = _scene(seed)
    problem, handles = mod.build_problem(sc)
    options = harness.solver_options(cell, "cpu", "float64", evaluation_chunk_size=1000,
                                     jacobian_sort_threshold=1, jacobian_pad_waste=100.0,
                                     **overrides)
    return stt.solve(options, problem), handles


@pytest.fixture(scope="module")
def cell_solve():
    """The cell's options on the scene (evaluation in 10 chunks, the
    camera-padded layout on)."""
    return _solve(SEEDS[1])


def test_solve_against_the_cluster_reference(cell_solve):
    """The start and 4 accepted costs within 1e-10 of the reference's (the
    two factors' rounding; 1.6e-13 when this test was written), the final
    cost within 1e-12 of the reference's cost at the final parameters."""
    s, handles = cell_solve
    cell, mod, sc = _scene(SEEDS[1])
    assert s.preconditioner_type_used == P.CLUSTER_TRIDIAGONAL
    assert s.camera_padded_layout.startswith("batch 0: 120 x ")
    accepted = [it.cost for it in s.iterations if it.step_is_successful]
    reference = mod.make_reference(sc, "cpu")
    ref = reference.solve(sc.cameras, sc.points, cell["options"],
                          max_accepted=cell["path_accepted_steps"])
    assert len(ref["accepted_costs"]) == 5 and len(accepted) >= 5
    for a, b in zip(accepted[:5], ref["accepted_costs"]):
        assert _rel(a, b) <= 1e-10
    final = reference.cost(handles["cameras"].values, handles["points"].values)
    assert _rel(s.final_cost, final) <= 1e-12


def test_index_range_reference_fails_the_path_check(cell_solve):
    """The fault the check exists for: a reference whose clusters are
    index ranges (the option unset) parts from the program's path by far
    more than the cell's ``path_gap`` limit."""
    s, _ = cell_solve
    cell, mod, sc = _scene(SEEDS[1])
    opts = {k: v for k, v in cell["options"].items() if k != "visibility_clustering_type"}
    reference = mod.make_reference(sc, "cpu")
    ref = reference.solve(sc.cameras, sc.points, {**opts, "cluster_jacobi_size": 12},
                          max_accepted=cell["path_accepted_steps"])
    solve = dict(accepted_costs=[it.cost for it in s.iterations if it.step_is_successful])
    gap = harness.compare([solve], ref, reference, ["path_gap"], cell["path_accepted_steps"])
    assert gap["path_gap"] > 100 * cell["checks"]["path_gap"]


def test_spans_and_counters_of_a_profiled_solve():
    """A 3-step solve under a profiler: the plan's three spans inside
    ``skeres.plan.cluster``, one ``skeres.schur.cluster_factor`` a damped
    solve and one ``skeres.schur.cluster_apply`` a preconditioner
    application (PCG's first and one an iteration), both inside
    ``skeres.schur.pcg``; the counters count the same."""
    before = (schur_mod.cluster_preconditioner.factors, schur_mod.cluster_preconditioner.applies)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s, _ = _solve(SEEDS[1], max_num_iterations=3)
    factors = schur_mod.cluster_preconditioner.factors - before[0]
    applies = schur_mod.cluster_preconditioner.applies - before[1]
    spans = [e for e in prof.events() if e.name.startswith("skeres.")]

    def enclosing(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith("skeres."):
            e = e.cpu_parent
        return e.name

    named = {}
    for e in spans:
        named.setdefault(e.name, []).append(e)
    for part in ("visibility", "views", "forest"):
        assert [enclosing(e) for e in named[f"skeres.plan.cluster.{part}"]] == ["skeres.plan.cluster"]
    iterations = sum(it.linear_solver_iterations for it in s.iterations[1:])
    assert len(named["skeres.schur.cluster_factor"]) == factors == s.num_linear_solves
    assert len(named["skeres.schur.cluster_apply"]) == applies == iterations + s.num_linear_solves
    assert {enclosing(e) for e in named["skeres.schur.cluster_factor"]
            + named["skeres.schur.cluster_apply"]} == {"skeres.schur.pcg"}


def test_visibility_clusters_need_fewer_pcg_iterations(monkeypatch):
    """One damped solve to eta 1e-6 on the relabelled scene: CLUSTER_TRIDIAGONAL
    on visibility clusters needs fewer PCG iterations than on index ranges
    of about the same size, and than SCHUR_JACOBI."""
    (t, _, data, g, diag), make = _solver(SEEDS[0], 2.0, monkeypatch, iterative=True,
                                          preconditioner=P.CLUSTER_TRIDIAGONAL, eta=1e-6,
                                          visibility_clustering=V.CANONICAL_VIEWS)
    size = int(round(float(np.mean(t.visibility.sizes))))

    def iterations(solver, data_):
        return int(solver.solve_damped(data_, g, diag, MU, 1e-6, 1e32)[1])

    steps = {"visibility": iterations(t, data)}
    ranges, _, rdata, _, _ = make(iterative=True, preconditioner=P.CLUSTER_TRIDIAGONAL, eta=1e-6,
                                  cluster_size=size)
    jacobi, _, jdata, _, _ = make(iterative=True, preconditioner=P.SCHUR_JACOBI, eta=1e-6)
    steps["ranges"], steps["schur_jacobi"] = iterations(ranges, rdata), iterations(jacobi, jdata)
    assert steps["visibility"] < steps["ranges"] and steps["visibility"] < steps["schur_jacobi"]


def test_the_option_from_a_cell_file_or_a_string():
    """The cell file's string arrives as the enum (``harness.solver_options``
    converts only enum defaults: ``SolverOptions`` takes the name itself)."""
    options = harness.solver_options(harness.load_cell(CELL), "cpu", "float64")
    assert options.visibility_clustering_type is V.CANONICAL_VIEWS
    assert options.preconditioner_type is P.CLUSTER_TRIDIAGONAL
    assert SolverOptions(visibility_clustering_type="SINGLE_LINKAGE").visibility_clustering_type \
        is V.SINGLE_LINKAGE
    assert SolverOptions().visibility_clustering_type is None
    with pytest.raises(KeyError):
        SolverOptions(visibility_clustering_type="CANONICAL")


def test_refused_under_the_device_loop_and_a_mesh():
    """Each refusal names what is missing."""
    with pytest.raises(NotImplementedError, match="use_device_loop"):
        _solve(SEEDS[0], use_device_loop=True)
    _, mod, sc = _scene(SEEDS[0])
    ev = Evaluator(mod.build_problem(sc)[0].compile(), device="cpu")
    ev.mesh = object()  # what the cluster plan checks first
    with pytest.raises(NotImplementedError, match="mesh"):
        SchurSolver(ev, iterative=True, preconditioner=P.CLUSTER_TRIDIAGONAL,
                    visibility_clustering=V.CANONICAL_VIEWS)
