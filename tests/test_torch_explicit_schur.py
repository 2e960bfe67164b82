"""The port's ExplicitSchurPlan (core/explicit_schur.py) against the JAX
package's plan and against the brute-force oracle of
tests/test_explicit_schur.py, on the same numpy inputs: random problems
with non-uniform observation counts (a gathered grid) and uniform ones (a
reshape grid). float64 on the CPU, where K3 takes its plain version; the
unique-pair table and the dense off-diagonal to rtol 1e-10 (sums of a few
products in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.core import explicit_schur as jes
from skeres_tpu.core.explicit_schur import ExplicitSchurPlan as JPlan
from skeres_tpu.core.explicit_schur import _hierarchical_sum_plan as j_sum_plan
from skeres_tpu_torch.core import explicit_schur as tes
from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan

F, E = 5, 3  # deliberately not the BAL 9/3
TOL = dict(rtol=1e-10, atol=1e-12)


def _random_case(seed, num_points=37, num_cameras=11, uniform=False, shuffled=False):
    """Point-sorted rows with 1-6 observations per point (as
    tests/test_explicit_schur.py builds them), or with ``shuffled`` the
    same rows in a random order, float64."""
    rng = np.random.default_rng(seed)
    counts = np.full(num_points, 4) if uniform else rng.integers(1, 7, size=num_points)
    pt_idx = np.repeat(np.arange(num_points), counts)
    if shuffled:
        pt_idx = rng.permutation(pt_idx)
    cam_idx = rng.integers(0, num_cameras, size=len(pt_idx))
    a_flat = rng.normal(size=(len(pt_idx), F * E))
    cinv = rng.normal(size=(num_points, E, E))
    cinv = cinv + np.swapaxes(cinv, 1, 2)  # symmetric like C^-1
    return pt_idx, cam_idx, a_flat, cinv, num_cameras, num_points


def _oracle_offdiag(pt_idx, cam_idx, a_flat, cinv, nc):
    """Dense (nc*F, nc*F) off-diagonal correction, brute force."""
    n = len(pt_idx)
    a = a_flat.reshape(n, F, E)
    y = np.einsum("rfe,reg->rfg", a, cinv[pt_idx])
    out = np.zeros((nc * F, nc * F))
    for p in np.unique(pt_idx):
        rows = np.nonzero(pt_idx == p)[0]
        for i, r in enumerate(rows):
            for s in rows[i + 1 :]:
                ca, cb = cam_idx[r], cam_idx[s]
                t = y[r] @ a[s].T
                out[ca * F : ca * F + F, cb * F : cb * F + F] += t
                out[cb * F : cb * F + F, ca * F : ca * F + F] += t.T
    return out


def _plans(case, tensors=False, **kw):
    """The JAX plan and the port's, the port's from CPU tensors with
    ``tensors`` (as the solver passes the evaluator's), else from the
    arrays."""
    pt, cam, _, _, nc, npts = case
    args = dict(num_cameras=nc, num_points=npts, f_size=F, e_size=E, pad_waste=100.0, **kw)
    idx = dict(cam_idx=cam, pt_idx=pt)
    t_idx = {k: torch.from_numpy(v) for k, v in idx.items()} if tensors else idx
    return JPlan(**idx, **args), ExplicitSchurPlan(**t_idx, **args, device="cpu")


def _assert_same_plan(tplan, jplan):
    """Every index array of the two plans equal element for element."""
    if jplan.grid_is_reshape:  # the JAX plan's grid is the rows in order
        np.testing.assert_array_equal(tplan.grid_src.numpy(), np.arange(len(tplan.grid_src)))
    else:
        np.testing.assert_array_equal(tplan.grid_src.numpy(), np.asarray(jplan.grid_src))
    np.testing.assert_array_equal(tplan.swap_mask.numpy(), np.asarray(jplan.swap_mask))
    np.testing.assert_array_equal(tplan.pair_valid.numpy(), np.asarray(jplan.pair_valid))
    assert tplan.n_uniq == jplan.n_uniq
    assert len(tplan.levels) == len(jplan.levels)
    for lv, jlv in zip(tplan.levels, jplan.levels):
        assert (lv.n_dest, lv.cap) == (jlv.n_dest, jlv.cap)
        np.testing.assert_array_equal(lv.src.numpy(), np.asarray(jlv.src))
    np.testing.assert_array_equal(tplan.pos2u_combined.numpy(), np.asarray(jplan.pos2u_combined))
    np.testing.assert_array_equal(tplan.diag_pair_idx.numpy(), np.asarray(jplan.diag_pair_idx))


def _jax_uniq_dense(plan, a_flat, cinv):
    def f(a, c):
        uniq = plan.correction_offdiag(plan.build_grid(a), c)
        return uniq, plan.dense_s_offdiag(uniq)

    uniq, dense = jax.jit(f)(jnp.asarray(a_flat), jnp.asarray(cinv.reshape(-1, E * E)))
    return np.asarray(uniq), np.asarray(dense)


def _torch_uniq_dense(plan, a_flat, cinv):
    grid = plan.build_grid(torch.from_numpy(a_flat))
    uniq = plan.correction_offdiag(grid, torch.from_numpy(cinv.reshape(-1, E * E)))
    return uniq.numpy(), plan.dense_s_offdiag(uniq).numpy()


@pytest.mark.parametrize("seed,uniform,shuffled,tensors", [
    (0, False, False, False), (3, False, False, False), (5, True, False, False),
    (0, False, False, True), (5, True, False, True), (8, False, True, True),
    (9, True, True, True)])
def test_plan_matches_jax_and_oracle(seed, uniform, shuffled, tensors):
    """The plan's index arrays equal the JAX package's numpy plan element
    for element, from arrays or from CPU tensors; the JAX grid is a reshape
    only where the rows are point-sorted and uniform, and the port's
    gather then reads the rows in order."""
    case = _random_case(seed, uniform=uniform, shuffled=shuffled)
    pt, cam, a, cinv, nc, _ = case
    jplan, tplan = _plans(case, tensors=tensors)
    assert jplan.grid_is_reshape == (uniform and not shuffled)
    assert (tplan.kp, tplan.npairs, tplan.n_uniq) == (jplan.kp, jplan.npairs, jplan.n_uniq)
    _assert_same_plan(tplan, jplan)
    j_uniq, j_dense = _jax_uniq_dense(jplan, a, cinv)
    t_uniq, t_dense = _torch_uniq_dense(tplan, a, cinv)
    np.testing.assert_allclose(t_uniq, j_uniq, **TOL)
    np.testing.assert_allclose(t_dense, j_dense, **TOL)
    np.testing.assert_allclose(t_dense, _oracle_offdiag(pt, cam, a, cinv, nc), **TOL)


def test_small_chunk_budget_leaves_the_table_unchanged():
    """K3's plain version streams points in byte-budgeted chunks; a tiny
    budget (256-point chunks of a 4000-point problem) gives the same
    table as one chunk."""
    case = _random_case(7, num_points=4000, num_cameras=40)
    _, _, a, cinv, _, _ = case
    tables = []
    for budget in (1 << 10, 1 << 30):
        _, plan = _plans(case, chunk_value_budget=budget)
        tables.append((plan.chunk_points, _torch_uniq_dense(plan, a, cinv)[0]))
    (small, t_small), (big, t_big) = tables
    assert small == 256 < 4000 < big
    np.testing.assert_allclose(t_small, t_big, rtol=1e-13, atol=1e-13)


def test_dense_s_full_folds_the_diagonal_blocks_in():
    case = _random_case(3)
    _, _, a, cinv, nc, _ = case
    jplan, tplan = _plans(case)
    diag = np.random.default_rng(1).normal(size=(nc, F * F))
    _, t_off = _torch_uniq_dense(tplan, a, cinv)
    uniq = tplan.correction_offdiag(
        tplan.build_grid(torch.from_numpy(a)), torch.from_numpy(cinv.reshape(-1, E * E))
    )
    full = tplan.dense_s_full(uniq, torch.from_numpy(diag)).numpy()
    want = jax.jit(jplan.dense_s_full)(jnp.asarray(uniq.numpy()), jnp.asarray(diag))
    np.testing.assert_allclose(full, np.asarray(want), **TOL)
    blocks = np.zeros_like(full)
    for c in range(nc):
        blocks[c * F : c * F + F, c * F : c * F + F] = diag[c].reshape(F, F)
    np.testing.assert_allclose(full, t_off + blocks, **TOL)


@pytest.mark.parametrize("ids_kind,adaptive", [
    ("skewed", False), ("skewed", True), ("even median", True)])
def test_hierarchical_sum_plan_and_apply_match_jax(ids_kind, adaptive):
    """Every level's ``src``, ``n_dest`` and ``cap`` equal the JAX
    package's numpy plan. "even median": 4 groups of 1, 2, 5 and 9 rows,
    whose median numpy takes as (2 + 5) / 2, so the adaptive first cap is
    4 (``torch.median``'s lower middle value, 2, would make it 2)."""
    rng = np.random.default_rng(2)
    if ids_kind == "skewed":
        ids = rng.integers(0, 9, size=500) ** 2  # skewed fan-in
    else:
        ids = rng.permutation(np.repeat(np.arange(4) * 7, [1, 2, 5, 9]))
    rows = rng.permutation(700)[: len(ids)]
    levels, uniq = tes._hierarchical_sum_plan(torch.from_numpy(ids), torch.from_numpy(rows), 700,
                                              cap=4, adaptive=adaptive)
    j_levels, j_uniq = j_sum_plan(ids, rows, 700, cap=4, adaptive=adaptive)
    np.testing.assert_array_equal(uniq.numpy(), j_uniq)
    assert len(levels) == len(j_levels) > 1
    for (s, n, c), (js, jn, jc) in zip(levels, j_levels):
        np.testing.assert_array_equal(s.numpy(), js)
        assert (n, c) == (jn, jc)
    if ids_kind == "even median":
        assert levels[0][2] == 4
    values = rng.normal(size=(700, 3))
    got = tes._apply_hierarchical_sum(tes._freeze_levels(levels, "cpu"), torch.from_numpy(values))
    want = np.stack([values[rows[ids == u]].sum(axis=0) for u in uniq.numpy()])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tensors", [False, True], ids=["arrays", "tensors"])
def test_gates_raise_like_jax(tensors):
    """The skew gate and the level-0 waste check raise ValueError (the
    solver reports it as the gate's reason) where the JAX package's do,
    from arrays or CPU tensors: the waste check from 1 << 20 padded rows
    on, on a plan of unique ids (fan-in 1: 32 padded rows each at a fixed
    cap of 32, 2 at the adaptive cap) built by both packages."""
    as_in = torch.from_numpy if tensors else (lambda a: a)
    pt = np.concatenate([np.zeros(40, np.int64), np.arange(1, 41)])
    cam = np.arange(80) % 7
    kw = dict(num_cameras=7, num_points=41, f_size=F, e_size=E)
    with pytest.raises(ValueError, match="skew") as jerr:
        JPlan(cam_idx=cam, pt_idx=pt, **kw)
    with pytest.raises(ValueError, match=str(jerr.value)):
        ExplicitSchurPlan(cam_idx=as_in(cam), pt_idx=as_in(pt), **kw, device="cpu")
    levels = [(np.zeros(1 << 21), 1 << 16, 32)]
    with pytest.raises(ValueError, match="fan-in too low"):
        tes._check_level0_waste(levels, 1000)
    tes._check_level0_waste(levels, 1 << 20)
    for n_ids, adaptive, raises in ((1 << 15, False, True), ((1 << 15) - 1, False, False),
                                    (1 << 15, True, False)):
        ids = np.arange(n_ids, dtype=np.int64)
        j_levels, _ = j_sum_plan(ids, ids, n_ids, cap=32, adaptive=adaptive)
        levels, _ = tes._hierarchical_sum_plan(torch.from_numpy(ids), torch.from_numpy(ids),
                                               n_ids, cap=32, adaptive=adaptive)
        for mod, lv in ((jes, j_levels), (tes, levels)):
            if raises:
                with pytest.raises(ValueError, match="fan-in too low"):
                    mod._check_level0_waste(lv, n_ids)
            else:
                mod._check_level0_waste(lv, n_ids)
