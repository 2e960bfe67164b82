"""The Snavely residual's batched form (``ops/reprojection.py``): its plain
version against ``torch.func.jacrev`` of ``snavely_reprojection_error``,
against the JAX package's evaluator rows and against the exact derivative
(mpmath, 50 digits) where autodiff loses digits; the small-angle branch,
both sides of its threshold and a point near the camera plane; and the
rule by which the evaluator takes the batched form. The CUDA kernel runs
in ``tests/test_torch_gpu.py``.

Tolerances, relative to each row's largest |J| entry (or |r|):

- float64, 1e-12: the same function, another order of operations;
- float32, 5e-6 of the float64 closed form: the rounding of a chain of
  some 40 float32 operations (eps 1.2e-7); for r, of |r| + |observation|,
  the terms it is the difference of. Not against float32 autodiff,
  which loses up to eps / theta near small angles (4e-5 at theta = 1e-3);
- just over the small-angle threshold (theta ~ 1e-6) autodiff differentiates
  ``(1 - cos theta) (w.X) w`` with ``dw/daa ~ 1/theta``, so its own
  rounding is about eps / theta = 2e-10 there: 1e-9 against jacrev, and
  1e-14 against the exact derivative, which the closed form keeps.
"""

import jax
import mpmath
import numpy as np
import pytest
import torch

from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.gradient_checker import check_program_gradients
from skeres_tpu_torch.core.problem import Problem
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.io import g2o
from skeres_tpu_torch.models import reprojection as rep
from skeres_tpu_torch.models.manifolds import SubsetManifold
from skeres_tpu_torch.ops import reprojection as rows_op
from skeres_tpu_torch.ops.rotation import _SMALL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(n, dtype=torch.float64, theta=None, seed=0, depth=-5.0):
    """n rows, each its own camera and point: rotations of scale 0.3 (or
    of angle ``theta`` about random axes), the camera ``depth`` from the
    points along z, focal ~500, small k1, k2, observations ~100 pixels."""
    g = np.random.default_rng(seed)
    cams = g.standard_normal((n, 9))
    if theta is None:
        cams[:, 0:3] *= 0.3
    else:
        axis = g.standard_normal((n, 3))
        cams[:, 0:3] = theta * axis / np.linalg.norm(axis, axis=1, keepdims=True)
    cams[:, 3:6] *= 0.5
    cams[:, 5] = depth
    cams[:, 6] = 500.0 + 100.0 * g.random(n)
    cams[:, 7:9] *= 0.1
    pts = g.standard_normal((n, 3))
    obs = 100.0 * g.standard_normal((n, 2))
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return t(cams), t(pts), torch.arange(n), torch.arange(n), t(obs)


def _autodiff(cams, pts, obs):
    """r and J of the port's residual function, by torch.func."""
    def one(c, p, o):
        f = lambda x: rep.snavely_reprojection_error((x[:9], x[9:]), o)  # noqa: E731
        x = torch.cat([c, p])
        return f(x), torch.func.jacrev(f)(x)

    return torch.func.vmap(one)(cams, pts, obs)


def _row_err(got, ref, scale=None):
    """The largest error of a row over that row's largest |entry| (of
    ``scale`` where given)."""
    dims = tuple(range(1, ref.ndim))
    scale = ref if scale is None else scale
    return float(((got - ref).abs().amax(dims) / scale.abs().amax(dims)).max())


@pytest.mark.parametrize("theta", [None, 0.5, 3.0], ids=["scale-0.3", "0.5", "3.0"])
def test_plain_rows_match_autodiff_float64(theta):
    cams, pts, ci, pi, obs = _rows(3000, theta=theta)
    r, jac = rows_op.snavely_rows_reference(cams, pts, ci, pi, obs)
    r_ref, jac_ref = _autodiff(cams, pts, obs)
    assert _row_err(r, r_ref) <= 1e-12
    assert _row_err(jac, jac_ref) <= 1e-12
    cost = rows_op.snavely_costs_reference(cams, pts, ci, pi, obs)
    torch.testing.assert_close(cost, 0.5 * (r_ref * r_ref).sum(1), rtol=1e-14, atol=0)


@pytest.mark.parametrize("theta", [None, 1e-3, 3.0], ids=["scale-0.3", "1e-3", "3.0"])
def test_plain_rows_float32_within_rounding(theta):
    cams, pts, ci, pi, obs = _rows(3000, theta=theta)
    r64, jac64 = rows_op.snavely_rows_reference(cams, pts, ci, pi, obs)
    r32, jac32 = rows_op.snavely_rows_reference(cams.float(), pts.float(), ci, pi, obs.float())
    assert r32.dtype == jac32.dtype == torch.float32
    # r = f d (x, y) - obs: its rounding is relative to the terms, not to r
    assert _row_err(r32.double(), r64, r64.abs() + obs.abs()) <= 5e-6
    assert _row_err(jac32.double(), jac64) <= 5e-6


def test_plain_rows_match_jax_evaluator_rows():
    """The JAX package's evaluator (vmap of autodiff) on a synthetic BAL
    scene: the valid rows of its r and J."""
    bal = jbal.synthetic_bal(16, 500, 4)
    program = jbal.build_bal_problem(bal)[0].compile()
    jev = JEvaluator(program)
    _, (jb,) = jax.jit(jev.blocks)(program.initial_state(jev.dtype))
    n = len(bal.observations)
    cams, pts = torch.tensor(bal.cameras), torch.tensor(bal.points)
    r, jac = rows_op.snavely_rows_reference(
        cams, pts, torch.tensor(bal.camera_index, dtype=torch.int64),
        torch.tensor(bal.point_index, dtype=torch.int64), torch.tensor(bal.observations))
    assert _row_err(r, torch.tensor(np.asarray(jb.r)[:n])) <= 1e-12
    assert _row_err(jac, torch.tensor(np.asarray(jb.jac)[:n])) <= 1e-12


@pytest.mark.parametrize("theta2", [0.0, 0.5 * _SMALL, 0.999 * _SMALL],
                         ids=["aa=0", "half-small", "just-under"])
def test_small_angle_branch_matches_autodiff(theta2):
    """Under the threshold both take X + aa x X and its derivative."""
    cams, pts, ci, pi, obs = _rows(500, theta=float(np.sqrt(theta2)))
    assert bool((cams[:, :3].pow(2).sum(1) < _SMALL).all())
    r, jac = rows_op.snavely_rows_reference(cams, pts, ci, pi, obs)
    r_ref, jac_ref = _autodiff(cams, pts, obs)
    assert _row_err(r, r_ref) <= 1e-12
    assert _row_err(jac, jac_ref) <= 1e-12


def _exact_jacobian(cam, pt, ob):
    """d r / d(camera, point) of one row by central differences at 50
    digits, on the same piecewise function."""
    def f(x):
        a, X = x[0:3], x[9:12]
        th2 = sum(v * v for v in a)
        if th2 < mpmath.mpf(_SMALL):
            P = [X[0] + a[1] * X[2] - a[2] * X[1], X[1] + a[2] * X[0] - a[0] * X[2],
                 X[2] + a[0] * X[1] - a[1] * X[0]]
        else:
            th = mpmath.sqrt(th2)
            w = [v / th for v in a]
            co, s = mpmath.cos(th), mpmath.sin(th)
            wx = [w[1] * X[2] - w[2] * X[1], w[2] * X[0] - w[0] * X[2], w[0] * X[1] - w[1] * X[0]]
            d = sum(w[i] * X[i] for i in range(3))
            P = [co * X[i] + s * wx[i] + (1 - co) * d * w[i] for i in range(3)]
        P = [P[i] + x[3 + i] for i in range(3)]
        xp, yp = -P[0] / P[2], -P[1] / P[2]
        r2 = xp * xp + yp * yp
        dist = 1 + r2 * (x[7] + x[8] * r2)
        return [x[6] * dist * xp - ob[0], x[6] * dist * yp - ob[1]]

    jac = np.zeros((2, 12))
    with mpmath.workdps(50):
        x0 = [mpmath.mpf(float(v)) for v in torch.cat([cam, pt])]
        ob = [mpmath.mpf(float(v)) for v in ob]
        h = mpmath.mpf("1e-20")
        for j in range(12):
            up, down = list(x0), list(x0)
            up[j] += h
            down[j] -= h
            fu, fd = f(up), f(down)
            for i in range(2):
                jac[i, j] = float((fu[i] - fd[i]) / (2 * h))
    return torch.tensor(jac)


@pytest.mark.parametrize("theta", [1.001e-6, 1.01e-6, 1e-5, 1e-3])
def test_just_over_the_threshold_keeps_its_digits(theta):
    """Rodrigues at theta^2 just over ``_SMALL``: the closed form within
    1e-14 of the exact derivative, autodiff within its own rounding."""
    cams, pts, ci, pi, obs = _rows(200, theta=theta, seed=3)
    assert bool((cams[:, :3].pow(2).sum(1) >= _SMALL).all())
    r, jac = rows_op.snavely_rows_reference(cams, pts, ci, pi, obs)
    r_ref, jac_ref = _autodiff(cams, pts, obs)
    assert _row_err(r, r_ref) <= 1e-12
    assert _row_err(jac, jac_ref) <= 1e-9
    exact = torch.stack([_exact_jacobian(cams[b], pts[b], obs[b]) for b in range(12)])
    assert _row_err(jac[:12], exact) <= 1e-14


@pytest.mark.parametrize("depth", [-1e-3, -1e-6])
def test_point_near_the_camera_plane(depth):
    """P.z near 0 (the point beside the camera): J of order 1/P.z^2."""
    cams, pts, ci, pi, obs = _rows(500, depth=0.0, seed=5)
    cams[:, :3] = 0.0  # P = X + t: put P.z at ``depth``
    cams[:, 5] = depth - pts[:, 2]
    r, jac = rows_op.snavely_rows_reference(cams, pts, ci, pi, obs)
    r_ref, jac_ref = _autodiff(cams, pts, obs)
    assert float(jac_ref.abs().max()) > 1e6
    assert _row_err(r, r_ref) <= 1e-12
    assert _row_err(jac, jac_ref) <= 1e-12


def test_rows_write_into_given_outputs():
    cams, pts, ci, pi, obs = _rows(300)
    r_out, jac_out = torch.empty(300, 2, dtype=torch.float64), torch.empty(300, 2, 12,
                                                                           dtype=torch.float64)
    r, jac = rows_op.snavely_rows(cams, pts, ci, pi, obs, r_out, jac_out)
    assert r is r_out and jac is jac_out
    r_ref, jac_ref = rows_op.snavely_rows_reference(cams, pts, ci, pi, obs)
    assert torch.equal(r, r_ref) and torch.equal(jac, jac_ref)
    with pytest.raises(ValueError, match="pt"):
        rows_op.snavely_rows(cams, pts, ci, pi.to(torch.int32), obs)
    with pytest.raises(ValueError, match="points"):
        rows_op.snavely_costs(cams, pts[:, :2].contiguous(), ci, pi, obs)


# -- the evaluator's rule ------------------------------------------------------------------

@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions' calls (the batched form on the CPU)."""
    calls = {"rows": 0, "costs": 0}
    for name in ("rows", "costs"):
        ref = getattr(rows_op, f"snavely_{name}_reference")

        def counted(*a, _ref=ref, _name=name):
            calls[_name] += 1
            return _ref(*a)

        monkeypatch.setattr(rows_op, f"snavely_{name}_reference", counted)
    return calls


def _bal():
    return tbal.synthetic_bal(6, 60, 3)


def _unsplit():
    return tbal.build_bal_problem(_bal())[0]


def _split():
    return tbal.build_split_bal_problem(_bal())[0]


def _fixed_k():
    bal = _bal()
    problem = Problem()
    poses = problem.add_parameter_block_array(bal.cameras[:, :6])
    points = problem.add_parameter_block_array(bal.points)
    data = np.concatenate([bal.observations, bal.cameras[bal.camera_index, 6:]], axis=1)
    problem.add_residual_blocks(rep.snavely_reprojection_error_fixed_k, None,
                                [(poses, bal.camera_index), (points, bal.point_index)], data=data)
    return problem


def _subset_camera():
    problem, cameras, _ = tbal.build_bal_problem(_bal())
    problem.set_manifold(cameras, SubsetManifold(9, [7, 8]))
    return problem


def _numeric_diff():
    bal = _bal()
    problem = Problem()
    cameras = problem.add_parameter_block_array(bal.cameras)
    points = problem.add_parameter_block_array(bal.points)
    problem.add_residual_blocks(rep.snavely_reprojection_error, None,
                                [(cameras, bal.camera_index), (points, bal.point_index)],
                                data=bal.observations, numeric_diff=True)
    return problem


def _pose_graph():
    return g2o.build_pose_graph_problem(g2o.synthetic_sphere(num_poses=12, loops_every=5))[0]


@pytest.mark.parametrize("build,fused", [
    (_unsplit, True), (_split, False), (_fixed_k, False), (_subset_camera, False),
    (_numeric_diff, False), (_pose_graph, False),
], ids=["snavely", "split", "fixed-k", "subset-camera", "numeric-diff", "pose-graph"])
@pytest.mark.parametrize("chunk", [None, 50])
def test_evaluator_takes_the_batched_form_only_where_it_is_the_same_function(
        build, fused, chunk, plain_calls):
    program = build().compile()
    ev = Evaluator(program, device="cpu", chunk_size=chunk)
    assert [ev.takes_batched_form(bi) for bi in range(len(program.batches))] \
        == [fused] * len(program.batches)
    state = program.initial_state("cpu", torch.float64)
    cost, blocks = ev.blocks(state)
    cost_only = ev.cost(state)
    chunks = sum(len(ev._row_slices(bi)) for bi in range(len(program.batches)))
    assert plain_calls == ({"rows": chunks, "costs": chunks} if fused
                           else {"rows": 0, "costs": 0})
    torch.testing.assert_close(cost_only, cost, rtol=1e-13, atol=0)
    for b in blocks:
        assert b.r.is_contiguous() and b.jac.is_contiguous()


@pytest.mark.parametrize("bad_row", [None, 0, 117])
def test_gradient_checker_holds_the_closed_form(bad_row, monkeypatch):
    """``check_program_gradients`` reads the Jacobian the solver takes
    (``Evaluator.jacobian_rows``): the closed form on a Euclidean Snavely
    batch. Correct, it passes; with one entry of one row's J off by 1 %
    (in the first chunk of 50 rows, or the third), the checker names that
    block, residual and coordinate."""
    program = _unsplit().compile()
    ev = Evaluator(program, device="cpu", chunk_size=50)
    state = program.initial_state("cpu", torch.float64)
    _, (b,) = ev.blocks(state)
    r, jac = ev.jacobian_rows(0, slice(0, b.r.shape[0]), state)
    assert torch.equal(r, b.r) and torch.equal(jac, b.jac)  # no loss, no constant block
    assert b.r.shape[0] > 150
    if bad_row is not None:
        plain, seen = rows_op.snavely_rows_reference, [0]

        def wrong(cams, pts, ci, pi, obs):  # called chunk by chunk, in order
            r, jac = plain(cams, pts, ci, pi, obs)
            if 0 <= bad_row - seen[0] < len(ci):
                jac[bad_row - seen[0], 1, 4] *= 1.01
            seen[0] += len(ci)
            return r, jac

        monkeypatch.setattr(rows_op, "snavely_rows_reference", wrong)
    ok, msg = check_program_gradients(program, ev)
    if bad_row is None:
        assert ok, msg
    else:
        assert not ok
        assert f"at block {bad_row}, residual 1, tangent coord 4" in msg
