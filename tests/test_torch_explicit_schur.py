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

from skeres_tpu.core.explicit_schur import ExplicitSchurPlan as JPlan
from skeres_tpu.core.explicit_schur import _hierarchical_sum_plan as j_sum_plan
from skeres_tpu_torch.core import explicit_schur as tes
from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan

F, E = 5, 3  # deliberately not the BAL 9/3
TOL = dict(rtol=1e-10, atol=1e-12)


def _random_case(seed, num_points=37, num_cameras=11, uniform=False):
    """Point-sorted rows with 1-6 observations per point (as
    tests/test_explicit_schur.py builds them), float64."""
    rng = np.random.default_rng(seed)
    counts = np.full(num_points, 4) if uniform else rng.integers(1, 7, size=num_points)
    pt_idx = np.repeat(np.arange(num_points), counts)
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


def _plans(case, **kw):
    pt, cam, _, _, nc, npts = case
    args = dict(cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
                f_size=F, e_size=E, pad_waste=100.0, **kw)
    return JPlan(**args), ExplicitSchurPlan(**args, device="cpu")


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


@pytest.mark.parametrize("seed,uniform", [(0, False), (3, False), (5, True)])
def test_plan_matches_jax_and_oracle(seed, uniform):
    case = _random_case(seed, uniform=uniform)
    pt, cam, a, cinv, nc, _ = case
    jplan, tplan = _plans(case)
    assert tplan.grid_is_reshape == jplan.grid_is_reshape == uniform
    assert (tplan.kp, tplan.npairs, tplan.n_uniq) == (jplan.kp, jplan.npairs, jplan.n_uniq)
    assert [(l.n_dest, l.cap) for l in tplan.levels] == [(l.n_dest, l.cap) for l in jplan.levels]
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


@pytest.mark.parametrize("adaptive", [False, True])
def test_hierarchical_sum_plan_and_apply_match_jax(adaptive):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 9, size=500) ** 2  # skewed fan-in
    rows = rng.permutation(700)[:500]
    levels, uniq = tes._hierarchical_sum_plan(ids, rows, 700, cap=4, adaptive=adaptive)
    j_levels, j_uniq = j_sum_plan(ids, rows, 700, cap=4, adaptive=adaptive)
    np.testing.assert_array_equal(uniq, j_uniq)
    assert len(levels) == len(j_levels) > 1
    for (s, n, c), (js, jn, jc) in zip(levels, j_levels):
        np.testing.assert_array_equal(s, js)
        assert (n, c) == (jn, jc)
    values = rng.normal(size=(700, 3))
    got = tes._apply_hierarchical_sum(tes._freeze_levels(levels, "cpu"), torch.from_numpy(values))
    want = np.stack([values[rows[ids == u]].sum(axis=0) for u in uniq])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_gates_raise_like_jax():
    """The skew gate and the level-0 waste check raise ValueError (the
    solver reports it as the gate's reason)."""
    pt = np.concatenate([np.zeros(40, np.int64), np.arange(1, 41)])
    cam = np.arange(80) % 7
    kw = dict(cam_idx=cam, pt_idx=pt, num_cameras=7, num_points=41, f_size=F, e_size=E)
    with pytest.raises(ValueError, match="skew") as jerr:
        JPlan(**kw)
    with pytest.raises(ValueError, match=str(jerr.value)):
        ExplicitSchurPlan(**kw, device="cpu")
    levels = [(np.zeros(1 << 21), 1 << 16, 32)]
    with pytest.raises(ValueError, match="fan-in too low"):
        tes._check_level0_waste(levels, 1000)
    tes._check_level0_waste(levels, 1 << 20)
