"""The port's manifolds and rotations against the JAX package's on the same
numpy inputs, float64 on the CPU, rtol 1e-12: ``plus``, ``minus``,
``plus_jacobian`` and ``minus_jacobian`` of every manifold of
``tests/test_manifolds.py`` (on one block, and ``plus`` on a batch of
blocks, the form the port's evaluator steps a group with), finite
derivatives at delta = 0, and the thirteen functions of
``ops/rotation.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeres_tpu.models import manifolds as JM
from skeres_tpu.ops import rotation as jrot
from skeres_tpu_torch.models import manifolds as TM
from skeres_tpu_torch.ops import rotation as trot

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit(v):
    return v / np.linalg.norm(v)


def _cases():
    """(name, JAX manifold, port manifold, points (n, ambient))."""
    rng = np.random.default_rng(3)
    unit4 = np.stack([_unit(rng.normal(size=4)) for _ in range(6)])
    lines = np.stack([np.concatenate([rng.normal(size=3), s * _unit(rng.normal(size=3))])
                      for s in (1.0, 1.0, 1.0, 2.5)])
    return [
        ("euclidean", JM.EuclideanManifold(4), TM.EuclideanManifold(4), rng.normal(size=(4, 4))),
        ("subset", JM.SubsetManifold(5, [1, 3]), TM.SubsetManifold(5, [1, 3]),
         rng.normal(size=(4, 5))),
        ("quaternion", JM.QuaternionManifold(), TM.QuaternionManifold(),
         np.concatenate([unit4, [[1.0, 0, 0, 0], [0.0, 1.0, 0, 0]]])),
        ("eigen_quaternion", JM.EigenQuaternionManifold(), TM.EigenQuaternionManifold(), unit4),
        ("sphere", JM.SphereManifold(4), TM.SphereManifold(4),
         np.concatenate([unit4, [[0.0, 0, 0, 1.0], [0.0, 0, 0, -1.0]]])),
        ("line", JM.LineManifold(3), TM.LineManifold(3), lines),
        ("angle", JM.AngleManifold(), TM.AngleManifold(), rng.uniform(-np.pi, np.pi, size=(4, 1))),
        ("product", JM.ProductManifold(JM.QuaternionManifold(), JM.EuclideanManifold(3)),
         TM.ProductManifold(TM.QuaternionManifold(), TM.EuclideanManifold(3)),
         np.concatenate([unit4[:4], rng.normal(size=(4, 3))], axis=1)),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]


def _deltas(man, n, scale, seed=5):
    return np.random.default_rng(seed).normal(size=(n, man.tangent_size)) * scale


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("name,jm,tm,xs", CASES, ids=IDS)
def test_plus_and_minus_match_jax(name, jm, tm, xs):
    """One block at a time and the whole batch at once: plus(x, d) for
    small and large d, and minus(plus(x, d), x)."""
    for scale in (1e-3, 0.7):
        ds = _deltas(jm, len(xs), scale)
        jy = np.stack([np.asarray(jm.plus(jnp.asarray(x), jnp.asarray(d))) for x, d in zip(xs, ds)])
        ty = np.stack([tm.plus(_t(x), _t(d)).numpy() for x, d in zip(xs, ds)])
        np.testing.assert_allclose(ty, jy, **TOL)
        np.testing.assert_allclose(tm.plus(_t(xs), _t(ds)).numpy(), jy, **TOL)
        jd = np.stack([np.asarray(jm.minus(jnp.asarray(y), jnp.asarray(x))) for x, y in zip(xs, jy)])
        np.testing.assert_allclose(tm.minus(_t(jy), _t(xs)).numpy(), jd, **TOL)
        np.testing.assert_allclose(
            np.stack([tm.minus(_t(y), _t(x)).numpy() for x, y in zip(xs, jy)]), jd, **TOL)


@pytest.mark.parametrize("name,jm,tm,xs", CASES, ids=IDS)
def test_jacobians_match_jax(name, jm, tm, xs):
    for x in xs:
        np.testing.assert_allclose(tm.plus_jacobian(_t(x)).numpy(),
                                   np.asarray(jm.plus_jacobian(jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(tm.minus_jacobian(_t(x)).numpy(),
                                   np.asarray(jm.minus_jacobian(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("name,jm,tm,xs", CASES, ids=IDS)
def test_derivatives_finite_at_zero(name, jm, tm, xs):
    """The evaluator differentiates plus at delta = 0 forward and in
    reverse: both finite, and equal to the JAX package's jvp."""
    zero = torch.zeros(tm.tangent_size, dtype=torch.float64)
    ones = torch.ones(tm.tangent_size, dtype=torch.float64)
    for x in xs:
        _, jv = torch.func.jvp(lambda d: tm.plus(_t(x), d), (zero,), (ones,))
        _, vjp = torch.func.vjp(lambda d: tm.plus(_t(x), d), zero)
        (vj,) = vjp(torch.ones(tm.ambient_size, dtype=torch.float64))
        assert torch.isfinite(jv).all() and torch.isfinite(vj).all()
        _, jjv = jax.jvp(lambda d: jm.plus(jnp.asarray(x), d),
                         (jnp.zeros(jm.tangent_size),), (jnp.ones(jm.tangent_size),))
        np.testing.assert_allclose(jv.numpy(), np.asarray(jjv), **TOL)


def test_angle_wraps_like_jax():
    a = np.array([[3.0], [-3.1], [0.2]])
    d = np.array([[0.5], [-0.4], [7.0]])
    np.testing.assert_allclose(
        TM.AngleManifold().plus(_t(a), _t(d)).numpy(),
        np.stack([np.asarray(JM.AngleManifold().plus(jnp.asarray(x), jnp.asarray(y)))
                  for x, y in zip(a, d)]), **TOL)


def _rotation_inputs():
    rng = np.random.default_rng(11)
    aa = np.concatenate([rng.normal(size=(6, 3)), [[0.0, 0.0, 0.0], [1e-9, -2e-9, 0.0]]])
    q = np.stack([_unit(v) for v in rng.normal(size=(8, 4))])
    q_raw = rng.normal(size=(8, 4)) * 3.0
    p = rng.normal(size=(8, 3))
    jac = jax.vmap(lambda v: jrot.angle_axis_to_rotation_matrix(v))(jnp.asarray(aa))
    return dict(aa=aa, q=q, q_raw=q_raw, p=p, r=np.asarray(jac))


ROTATION_CASES = [
    ("angle_axis_to_quaternion", ("aa",)),
    ("quaternion_to_angle_axis", ("q",)),
    ("quaternion_product", ("q", "q_raw")),
    ("quaternion_conjugate", ("q",)),
    ("unit_quaternion_rotate_point", ("q", "p")),
    ("quaternion_rotate_point", ("q_raw", "p")),
    ("angle_axis_rotate_point", ("aa", "p")),
    ("quaternion_to_rotation_matrix", ("q",)),
    ("rotation_matrix_to_quaternion", ("r",)),
    ("angle_axis_to_rotation_matrix", ("aa",)),
    ("rotation_matrix_to_angle_axis", ("r",)),
    ("eigen_quaternion_to_ceres", ("q",)),
    ("ceres_quaternion_to_eigen", ("q",)),
]


@pytest.mark.parametrize("fn,args", ROTATION_CASES, ids=[c[0] for c in ROTATION_CASES])
def test_rotation_matches_jax(fn, args):
    """Batched over leading axes, and the jvp at the inputs, against the
    JAX package's function."""
    inputs = _rotation_inputs()
    xs = [inputs[a] for a in args]
    want = np.asarray(getattr(jrot, fn)(*[jnp.asarray(x) for x in xs]))
    got = getattr(trot, fn)(*[_t(x) for x in xs]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    tangents = [np.full_like(x, 0.5) for x in xs]
    _, jt = jax.jvp(getattr(jrot, fn), tuple(jnp.asarray(x) for x in xs),
                    tuple(jnp.asarray(t) for t in tangents))
    _, tt = torch.func.jvp(getattr(trot, fn), tuple(_t(x) for x in xs),
                           tuple(_t(t) for t in tangents))
    assert torch.isfinite(tt).all()
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-10, atol=1e-12)
    assert sorted(trot.__all__) == sorted(jrot.__all__)
