"""K1 and K2 (ops/cholesky.py): K1's plain version, and K2's panel loop over
it, against the JAX package's Pallas kernel and blocked factor (interpret
mode, as tests/test_kernels.py runs them) and numpy, and the wrappers'
contracts. The kernels themselves against their plain versions need a
card: tests/test_torch_gpu.py."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.ops.pallas.cholesky import blocked_chol_solve as jax_blocked_solve
from skeres_tpu.ops.pallas.cholesky import blocked_cholesky_factor as jax_blocked_factor
from skeres_tpu.ops.pallas.cholesky import cholesky_inverse_factor as pallas_linv
from skeres_tpu.ops.small_inverse import batched_spd_inverse as jax_spd_inverse
from skeres_tpu_torch.ops import cholesky as k1
from skeres_tpu_torch.ops.small_inverse import batched_spd_inverse


def _spd(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


@pytest.mark.parametrize("n", [5, 37, 128, 300])
def test_plain_k1_matches_pallas_kernel_f32(n):
    """float32, atol 2e-4 as in tests/test_kernels.py (the Pallas kernel
    pads to 128 and runs blocked; both are float32 factorizations)."""
    a = _spd(n)
    want = np.asarray(pallas_linv(jnp.asarray(a, jnp.float32)))
    got = k1.cholesky_inverse_factor(torch.tensor(a, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("n", [1, 5, 37, 300])
def test_plain_k1_matches_numpy_f64(n):
    a = _spd(n)
    l, linv = k1.cholesky_both(torch.tensor(a))
    np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        linv.numpy(), np.linalg.inv(np.linalg.cholesky(a)), rtol=1e-10, atol=1e-10
    )
    b = np.random.default_rng(n + 1).standard_normal(n)
    x = k1.chol_solve(linv, torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_k1_failure_is_all_nan(dtype):
    a = torch.tensor(_spd(12), dtype=dtype)
    a[5, 5] = -1.0
    l, linv = k1.cholesky_both(a)
    assert torch.isnan(l).all() and torch.isnan(linv).all()


def test_cpu_tensor_takes_plain_version_without_building():
    """A CPU tensor never launches, never builds, and leaves the launch
    counter alone; the module imports without nvcc."""
    before = k1.cholesky_both.launches
    k1.cholesky_both(torch.tensor(_spd(9)))
    assert k1.cholesky_both.launches == before
    if not torch.cuda.is_available():
        assert k1.build_kernels.cache_info().currsize == 0
        if shutil.which("nvcc") is None:
            with pytest.raises(RuntimeError, match="nvcc"):
                k1.build_kernels()


@pytest.mark.parametrize(
    "bad,exc",
    [
        (torch.zeros(1025, 1025), ValueError),
        (torch.zeros(0, 0), ValueError),
        (torch.zeros(3, 4), ValueError),
        (torch.zeros(2, 3, 3), ValueError),
        (torch.eye(4, dtype=torch.float16), TypeError),
        (torch.eye(4, dtype=torch.float64).T[:, :3][:3], ValueError),  # strided
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        k1.cholesky_both(bad)


@pytest.mark.parametrize("e", [1, 2, 3, 5, 9])
def test_batched_spd_inverse_matches_jax(e):
    rng = np.random.default_rng(e)
    m = rng.standard_normal((64, e, e))
    a = m @ np.swapaxes(m, 1, 2) + 2 * e * np.eye(e)
    want = np.asarray(jax_spd_inverse(jnp.asarray(a)))
    got = batched_spd_inverse(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    if e > 3:  # the factor path: a block that is not PD comes out NaN
        a[0] = -np.eye(e)
        assert torch.isnan(batched_spd_inverse(torch.from_numpy(a))[0]).all()



# -- K2: the blocked factor over K1 panels ------------------------------------


@pytest.mark.parametrize("n,panel", [(300, 128), (515, 128), (384, 384)])
def test_k2_matches_pallas_blocked_f32(n, panel):
    """The port's K2 (panels through K1's plain version) against
    the JAX package's blocked factor (Pallas panels in interpret mode) at
    the same panel width, float32: L and the solve to the atol of
    tests/test_kernels.py (3e-3 and 5e-4)."""
    a = _spd(n)
    jfac = jax_blocked_factor(jnp.asarray(a, jnp.float32), panel=panel)
    fac = k1.blocked_cholesky_factor(torch.tensor(a, dtype=torch.float32), panel=panel)
    np.testing.assert_allclose(fac.l.numpy(), np.asarray(jfac.l)[:n, :n], rtol=0, atol=3e-3)
    b = np.random.default_rng(n).standard_normal(n)
    want = np.asarray(jax_blocked_solve(jfac, jnp.asarray(b, jnp.float32)))
    got = k1.blocked_chol_solve(fac, torch.tensor(b, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    np.testing.assert_allclose(got, np.linalg.solve(a, b), rtol=0, atol=5e-4)


@pytest.mark.parametrize("n,panel", [(1, 4), (7, 4), (300, 128), (1030, 256), (515, 1024)])
def test_k2_matches_numpy_f64(n, panel):
    """float64, a short last panel wherever panel does not divide n."""
    a = _spd(n)
    before = k1.cholesky_both.launches
    fac = k1.blocked_cholesky_factor(torch.tensor(a), panel=panel)
    assert k1.cholesky_both.launches == before  # no kernel on the CPU
    assert len(fac.dinv) == -(-n // panel) and fac.n == n
    np.testing.assert_allclose(fac.l.numpy(), np.linalg.cholesky(a), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        k1.blocked_cholesky_factor_reference(torch.tensor(a)).numpy(), np.linalg.cholesky(a),
        rtol=1e-10, atol=1e-10,
    )
    b = np.random.default_rng(n + 1).standard_normal(n)
    x = k1.blocked_chol_solve(fac, torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_failed_panel_poisons_every_later_output(dtype):
    """A pivot that fails in panel 2 of 4: that panel and every later one
    (their inverses and their columns of L) are non-finite, and so is
    every entry of a solve; the panels before stay finite. The plain
    version is all NaN."""
    n, panel = 200, 50
    a = torch.tensor(_spd(n), dtype=dtype)
    a[120, 120] = -1.0
    fac = k1.blocked_cholesky_factor(a, panel=panel)
    for i, vkk in enumerate(fac.dinv):
        assert bool(torch.isfinite(vkk).all()) == (i < 2)
    tril = torch.tril(torch.ones(n, n, dtype=torch.bool))
    assert not torch.isfinite(fac.l[100:, 100:][tril[100:, 100:]]).any()
    assert torch.isfinite(fac.l[:, :100]).all()
    x = k1.blocked_chol_solve(fac, torch.ones(n, dtype=dtype))
    assert not torch.isfinite(x).any()
    assert torch.isnan(k1.blocked_cholesky_factor_reference(a)).all()


@pytest.mark.parametrize(
    "bad,panel,exc",
    [
        (torch.zeros(3, 4), 4, ValueError),
        (torch.eye(4, dtype=torch.float16), 4, TypeError),
        (torch.eye(8, dtype=torch.float64).T[:, :4][:4], 4, ValueError),  # strided
        (torch.eye(8), 0, ValueError),
        (torch.eye(8), 1025, ValueError),
    ],
)
def test_k2_rejects_what_it_does_not_take(bad, panel, exc):
    with pytest.raises(exc):
        k1.blocked_cholesky_factor(bad, panel=panel)


# -- K2's trailing update: C -= tril(P P^T) -----------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [1, 32, 256])
@pytest.mark.parametrize("m", [1, 63, 130, 257])
def test_trailing_update_plain_version_matches_numpy(m, w, dtype):
    """The plain version on a strided view (row stride m + 5, as a view into
    the factor): the lower triangle within the float rounding bound of a
    w-term sum, (w + 2) eps (|C| + |P| |P|^T) elementwise; the strict upper
    triangle and everything outside the view bit-for-bit unchanged."""
    rng = np.random.default_rng(m * 1000 + w)
    big = torch.tensor(rng.standard_normal((m + 3, m + 5)), dtype=dtype)
    p = torch.tensor(rng.standard_normal((m, w)), dtype=dtype)
    before = big.clone()
    c = big[3:, 5:]
    assert c.stride() == (m + 5, 1)
    launches = k1.trailing_update_.launches
    assert k1.trailing_update_(c, p) is c
    assert k1.trailing_update_.launches == launches  # the CPU never launches
    c0, p64 = before[3:, 5:].double().numpy(), p.double().numpy()
    want = c0 - p64 @ p64.T
    eps = float(torch.finfo(dtype).eps)
    bound = (w + 2) * eps * (np.abs(c0) + np.abs(p64) @ np.abs(p64).T)
    lower = np.tril(np.ones((m, m), dtype=bool))
    err = np.abs(c.double().numpy() - want)
    assert (err[lower] <= bound[lower]).all()
    assert torch.equal(c[~torch.from_numpy(lower)], before[3:, 5:][~torch.from_numpy(lower)])
    outside = torch.ones_like(big, dtype=torch.bool)
    outside[3:, 5:] = False
    assert torch.equal(big[outside], before[outside])


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the dropped 13 bits on the int32 view, then
    clear them."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(x: np.ndarray) -> np.ndarray:
    """What a tensor core reads of a float32 operand: the low 13 mantissa
    bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_split_three_passes_keep_float32_accuracy():
    """Why the trailing update takes three TF32 passes in float32, emulating
    its split: hi = tf32(x) rounded, lo = x - hi passed whole and truncated
    by the tensor core. On a 512 x 256 P, P P^T from hi alone is off by
    ~2e-4 (normwise, against float64), beyond K2's 1e-4 bound at venice
    size; lo.hi + hi.lo + hi.hi, each product exact in float32 and summed
    in float32 as the tensor cores do, is within 1e-6, as close as a plain
    float32 product."""
    p = np.random.default_rng(0).standard_normal((512, 256)).astype(np.float32)
    hi = _tf32(p)
    lo = _tf32_truncated(p - hi)
    assert np.all(np.abs(p - hi) <= 2.0**-11 * np.abs(p))
    ref = p.astype(np.float64) @ p.astype(np.float64).T

    def rel(x):
        return np.linalg.norm(x - ref) / np.linalg.norm(ref)

    one = rel(hi @ hi.T)
    three = rel(lo @ hi.T + hi @ lo.T + hi @ hi.T)
    plain = rel(p @ p.T)
    assert one >= 1e-4
    assert three <= 1e-6
    assert three <= 2 * plain


@pytest.mark.parametrize(
    "c,p,exc",
    [
        (torch.zeros(4, 4), torch.zeros(4, 2, dtype=torch.float64), TypeError),
        (torch.zeros(4, 4, dtype=torch.float16), torch.zeros(4, 2, dtype=torch.float16), TypeError),
        (torch.zeros(4, 5), torch.zeros(4, 2), ValueError),
        (torch.zeros(4, 4), torch.zeros(3, 2), ValueError),
        (torch.zeros(4, 4), torch.zeros(4, 0), ValueError),
        (torch.zeros(4, 4).T, torch.zeros(4, 2), ValueError),  # column stride 4
    ],
)
def test_trailing_update_rejects_what_the_kernel_does_not_take(c, p, exc):
    with pytest.raises(exc):
        k1.trailing_update_(c, p)


def test_k2_on_the_cpu_launches_no_update():
    """K2's CPU path takes the update's plain version at every panel."""
    before = k1.trailing_update_.launches
    fac = k1.blocked_cholesky_factor(torch.tensor(_spd(70)), panel=16)
    assert k1.trailing_update_.launches == before
    np.testing.assert_allclose(fac.l.numpy(), np.linalg.cholesky(_spd(70)), rtol=1e-10, atol=1e-10)
