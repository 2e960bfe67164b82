"""The cluster side of the port: ``ExplicitSchurPlan`` with ``cluster_of``
and ``cluster_band`` against the JAX package's plan, the cluster matrices
and the band against the same blocks read off dense S, the two
preconditioners applied to a vector against the JAX package's, the boost
ladder, and the downgrades. float64 on the CPU, ``synthetic_bal(16, 500,
4)`` with cluster size 4 (4 clusters) unless a test says otherwise.

Tolerances: rtol 1e-10 with an atol of 1e-12 of the largest entry (sums of
a few hundred float64 terms in another order); a preconditioner's output
passes through a factorization of matrices with condition number ~1e4, so
it is held to 1e-10 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.explicit_schur import ExplicitSchurPlan as JPlan
from skeres_tpu.core.linear_solvers import lm_diagonal as jlm_diagonal
from skeres_tpu.core.schur import SchurSolver as JSchur
from skeres_tpu.core.types import PreconditionerType as JP
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import explicit_schur as plan_mod
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.types import PreconditionerType as P
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers run side by side on a few cores: one thread each for
    the small problems here, or the workers' thread pools fight over the
    cores (a DENSE_QR case took minutes that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

MU = 1e-4
CS = 4


def _close(a, b, rtol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-12 * max(np.abs(b).max(), 1e-300))


class _Scene:
    def __init__(self, scene=(16, 500, 4)):
        self.bal = bal = jbal.synthetic_bal(*scene)
        jprogram = jbal.build_bal_problem(bal)[0].compile()
        self.jev = JEvaluator(jprogram)
        _, self.jblocks = jax.jit(self.jev.blocks)(jprogram.initial_state(self.jev.dtype))
        jg, jdiag = jax.jit(self.jev.gradient_and_diag)(self.jblocks)
        self.jscale = 1.0 / (1.0 + jnp.sqrt(jdiag))
        self.jg, self.jdiag = jg * self.jscale, jdiag * self.jscale**2
        self.tev = Evaluator(tbal.build_bal_problem(bal)[0].compile(), device="cpu")
        _, self.tblocks = self.tev.blocks(self.tev.program.initial_state("cpu", torch.float64))
        tg, tdiag = self.tev.gradient_and_diag(self.tblocks)
        self.tscale = 1.0 / (1.0 + torch.sqrt(tdiag))
        self.tg, self.tdiag = tg * self.tscale, tdiag * self.tscale**2

    def jax(self, mu=MU, **kw):
        schur = JSchur(self.jev, **kw)
        data = schur.prepare(schur.scale_data(schur.solver_data(self.jblocks), self.jscale))
        return schur, schur._assemble(data, self.jg, jlm_diagonal(self.jdiag, mu, 1e-6, 1e32))

    def port(self, mu=MU, **kw):
        schur = SchurSolver(self.tev, **kw)
        self.data = schur.prepare(schur.scale_data(schur.solver_data(self.tblocks), self.tscale))
        return schur, schur._assemble(self.data, self.tg, lm_diagonal(self.tdiag, mu, 1e-6, 1e32))

    def solve(self, **kw):
        """(solver, dx, PCG steps) of one damped solve of the port."""
        schur, _ = self.port(**kw)
        dx, it, _ = schur.solve_damped(self.data, self.tg, self.tdiag, MU, 1e-6, 1e32)
        return schur, dx, int(it)


@pytest.fixture(scope="module")
def scene():
    return _Scene()


@pytest.mark.parametrize("band", [False, True])
def test_cluster_plan_structure_matches_jax(scene, band):
    """Pair validity, the unique pairs, and the cluster and band maps, index
    for index (the two plans number unique pairs alike)."""
    bal = scene.bal
    kw = dict(cam_idx=bal.camera_index.astype(np.int64), pt_idx=bal.point_index.astype(np.int64),
              num_cameras=16, num_points=500, f_size=9, e_size=3,
              cluster_of=np.arange(16) // CS, cluster_band=band)
    jplan = JPlan(**kw)
    tplan = ExplicitSchurPlan(device="cpu", **kw)
    full = ExplicitSchurPlan(device="cpu", **{**kw, "cluster_of": None, "cluster_band": False})
    assert (tplan.n_uniq, tplan.n_clusters, tplan.cluster_slot_size) == (
        jplan.n_uniq, jplan.n_clusters, jplan.cluster_slot_size) == (jplan.n_uniq, 4, CS)
    assert 0 < tplan.n_uniq < full.n_uniq  # pairs across clusters are dropped
    np.testing.assert_array_equal(tplan.pair_valid.numpy(), np.asarray(jplan.pair_valid))
    np.testing.assert_array_equal(tplan.swap_mask.numpy(), np.asarray(jplan.swap_mask))
    np.testing.assert_array_equal(tplan.cluster_cam_of, jplan.cluster_cam_of)
    np.testing.assert_array_equal(tplan.cluster_map_u.numpy(), np.asarray(jplan.cluster_map_u))
    np.testing.assert_array_equal(tplan.cluster_map_l.numpy(), np.asarray(jplan.cluster_map_l))
    if band:
        np.testing.assert_array_equal(tplan.band_map_u.numpy(), np.asarray(jplan.band_map_u))
        np.testing.assert_array_equal(tplan.band_map_l.numpy(), np.asarray(jplan.band_map_l))
    else:
        assert tplan.band_map_u is None and jplan.band_map_u is None
        with pytest.raises(ValueError, match="cluster_band"):
            tplan.cluster_band_offdiag(torch.zeros(tplan.n_uniq, 81, dtype=torch.float64))


def test_ragged_clusters_pad_their_slots():
    """18 cameras in clusters of 4: the last cluster has 2 cameras and 2
    padded slots, whose rows and columns are zero in the off-diagonal
    matrices and take the identity in the preconditioner's."""
    sc = _Scene((18, 300, 4))
    tschur, tasm = sc.port(iterative=True, preconditioner=P.CLUSTER_JACOBI, cluster_size=CS)
    jschur, jasm = sc.jax(iterative=True, preconditioner=JP.CLUSTER_JACOBI, cluster_size=CS)
    plan = tschur.cluster_plan
    assert (plan.n_clusters, plan.cluster_slot_size) == (5, CS)
    assert (plan.cluster_cam_of[-1] == [16, 17, -1, -1]).all()
    mats, _, dmax = tschur._cluster_mats(tasm)
    jmats = jax.jit(lambda a: jschur._cluster_mats(a)[0])(jasm)
    _close(mats.numpy(), jmats)
    pad = mats[-1, 18:, :]
    assert torch.equal(pad[:, 18:], torch.eye(18, dtype=torch.float64)) and not pad[:, :18].any()
    v = np.random.default_rng(2).standard_normal(tschur.num_f)
    got = tschur._cluster_jacobi_precond(tasm)(torch.tensor(v)).numpy()
    want = np.asarray(jax.jit(lambda a, x: jschur._cluster_jacobi_precond(a)(x))(jasm, jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def _dense_s(scene):
    dense, dasm = scene.port()
    return dense._dense_s(dasm)


def test_cluster_matrices_are_the_diagonal_blocks_of_dense_s(scene):
    """Each cluster matrix equals the (cs*f) x (cs*f) block of dense S on
    its cameras, entry for entry: a transposed or misplaced f x f block
    shows here."""
    tschur, tasm = scene.port(iterative=True, preconditioner=P.CLUSTER_JACOBI, cluster_size=CS)
    mats, _, dmax = tschur._cluster_mats(tasm)
    s = _dense_s(scene)
    w = CS * 9
    for c in range(4):
        _close(mats[c].numpy(), s[c * w : (c + 1) * w, c * w : (c + 1) * w].numpy())
    _close(dmax[:, 0].numpy(), [float(torch.diagonal(mats[c]).max()) for c in range(4)])
    jschur, jasm = scene.jax(iterative=True, preconditioner=JP.CLUSTER_JACOBI, cluster_size=CS)
    _close(mats.numpy(), jax.jit(lambda a: jschur._cluster_mats(a)[0])(jasm))


def test_band_matrices_are_the_off_diagonal_blocks_of_dense_s(scene):
    """band[c] = S[cluster c rows, cluster c+1 columns]; S is not symmetric
    block by block, so an f x f block read in the wrong orientation fails."""
    tschur, tasm = scene.port(iterative=True, preconditioner=P.CLUSTER_TRIDIAGONAL,
                              cluster_size=CS)
    mats, uniq, _ = tschur._cluster_mats(tasm)
    band = -tschur.cluster_plan.cluster_band_offdiag(uniq)
    s = _dense_s(scene)
    w = CS * 9
    assert band.shape == (3, w, w) and band.abs().max() > 0
    for c in range(3):
        block = s[c * w : (c + 1) * w, (c + 1) * w : (c + 2) * w]
        _close(band[c].numpy(), block.numpy())
        assert not np.allclose(block.numpy(), block.numpy().T)
        _close(mats[c].numpy(), s[c * w : (c + 1) * w, c * w : (c + 1) * w].numpy())
    jschur, jasm = scene.jax(iterative=True, preconditioner=JP.CLUSTER_TRIDIAGONAL,
                             cluster_size=CS)
    jband = jax.jit(
        lambda a: -jschur.cluster_plan.cluster_band_offdiag(jschur._cluster_mats(a)[1]))(jasm)
    _close(band.numpy(), jband)


@pytest.mark.parametrize("name", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_preconditioner_applied_to_a_vector_matches_jax(scene, name):
    tschur, tasm = scene.port(iterative=True, preconditioner=P[name], cluster_size=CS)
    jschur, jasm = scene.jax(iterative=True, preconditioner=JP[name], cluster_size=CS)
    make = "_cluster_jacobi_precond" if name == "CLUSTER_JACOBI" else "_cluster_tridiag_precond"
    v = np.random.default_rng(9).standard_normal(tschur.num_f)
    got = getattr(tschur, make)(tasm)(torch.tensor(v)).numpy()
    want = np.asarray(jax.jit(lambda a, x: getattr(jschur, make)(a)(x))(jasm, jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_cluster_jacobi_is_the_inverse_of_the_block_diagonal(scene):
    """With the true matrices factoring at rung 0 (float64, damped), the
    preconditioner applies the exact inverse of S's cluster block diagonal."""
    tschur, tasm = scene.port(iterative=True, preconditioner=P.CLUSTER_JACOBI, cluster_size=CS)
    s = _dense_s(scene)
    w = CS * 9
    v = torch.tensor(np.random.default_rng(1).standard_normal(tschur.num_f))
    want = torch.cat([torch.linalg.solve(s[c * w : (c + 1) * w, c * w : (c + 1) * w],
                                         v[c * w : (c + 1) * w]) for c in range(4)])
    got = tschur._cluster_jacobi_precond(tasm)(v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-9 * float(want.abs().max()))


def test_tridiagonal_is_the_inverse_of_the_block_tridiagonal_part(scene):
    tschur, tasm = scene.port(iterative=True, preconditioner=P.CLUSTER_TRIDIAGONAL,
                              cluster_size=CS)
    s = _dense_s(scene)
    w = CS * 9
    blk = torch.arange(s.shape[0]) // w
    tri = torch.where((blk[:, None] - blk[None, :]).abs() <= 1, s, 0.0)
    v = torch.tensor(np.random.default_rng(1).standard_normal(tschur.num_f))
    got = tschur._cluster_tridiag_precond(tasm)(v)
    want = torch.linalg.solve(tri, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-8 * float(want.abs().max()))


def test_boost_ladder_accepts_by_the_factorization_residual(scene):
    """Rung 0 for a positive definite matrix; the ``cluster_boost`` rung for
    one that is indefinite by less than it; the 1e-1 rung beyond; and where
    nothing passes, the most regularized factor with its NaNs zeroed."""
    tschur, _ = scene.port(iterative=True, preconditioner=P.CLUSTER_JACOBI, cluster_size=CS,
                           cluster_boost=1e-3)
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))

    def mat(lowest):
        return q @ np.diag([lowest, 0.5, 0.6, 0.7, 0.8, 1.0]) @ q.T

    mats = torch.tensor(np.stack([mat(0.1), mat(-2e-4), mat(-5e-2), mat(-5.0)]))
    dmax = torch.diagonal(mats, dim1=1, dim2=2).amax(dim=1, keepdim=True)
    linv = tschur._robust_linv(mats, dmax)
    inv = linv.transpose(1, 2) @ linv
    eye = np.eye(6)
    for k, boost in enumerate([0.0, 1e-3, 1e-1]):
        want = np.linalg.inv(mats[k].numpy() + boost * float(dmax[k]) * eye)
        np.testing.assert_allclose(inv[k].numpy(), want, rtol=1e-8, atol=1e-10)
    assert torch.isfinite(linv[:3]).all()
    assert not torch.isfinite(linv[3]).all()  # a zeroed factor has no inverse


def test_rejected_cluster_plan_downgrades_to_schur_jacobi(scene, monkeypatch):
    """A cluster plan that cannot be built (here: the fan-in gate forced to
    fail) downgrades to SCHUR_JACOBI, and the solver says so."""
    def reject(*a, **k):
        raise ValueError("unique-pair fan-in too low")

    monkeypatch.setattr(plan_mod, "_check_level0_waste", reject)
    tschur, dx, steps = scene.solve(iterative=True, preconditioner=P.CLUSTER_JACOBI,
                                    cluster_size=CS)
    assert tschur.cluster_plan is None and tschur.preconditioner_used == P.SCHUR_JACOBI
    _, ref_dx, ref_steps = scene.solve(iterative=True, preconditioner=P.SCHUR_JACOBI)
    assert steps == ref_steps and torch.equal(dx, ref_dx)


def test_tridiagonal_on_one_cluster_downgrades_to_schur_jacobi(scene):
    tschur, _ = scene.port(iterative=True, preconditioner=P.CLUSTER_TRIDIAGONAL, cluster_size=64)
    assert tschur.cluster_plan.n_clusters == 1
    assert tschur.preconditioner_used == P.SCHUR_JACOBI
    one, _ = scene.port(iterative=True, preconditioner=P.CLUSTER_JACOBI, cluster_size=64)
    assert one.preconditioner_used == P.CLUSTER_JACOBI


def test_cluster_preconditioners_need_fewer_pcg_steps(scene):
    """As ``tests/test_schur.py:435`` holds for the JAX package: the cluster
    blocks contain SCHUR_JACOBI's, and the band adds to them."""
    steps = {}
    for name in ("SCHUR_JACOBI", "CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"):
        steps[name] = scene.solve(iterative=True, preconditioner=P[name], cluster_size=CS,
                                  eta=1e-6)[2]
    assert steps["CLUSTER_TRIDIAGONAL"] < steps["CLUSTER_JACOBI"] < steps["SCHUR_JACOBI"]
