"""The camera-padded layout of the port's Schur solvers (``core/schur.py``:
``padded_plan``, ``gradient_and_diag``, ``prepare(cam_raw, scale)``
and the padded products) against the JAX package's, float64 on the CPU.

Scenes: ``synthetic_bal(6, 50, 3)`` (``tests/test_sharding.py``'s) and
``synthetic_bal(8, 90, 3)``, the layout forced on by
``jacobian_sort_threshold=1`` and ``jacobian_pad_waste=100``. The pieces
are held to 1e-12 against the JAX padded path where that path is right,
and the S product on the minimizer's path (unscaled placed rows,
``cam_scale`` set) against the JAX generic product, since the JAX padded
one multiplies there by the S of the unscaled Jacobian (ROADMAP Queue 3,
note v). Full solves follow the JAX generic trajectory to 1e-8 a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core import types as jtypes
from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.linear_solvers import lm_diagonal as jlm_diagonal
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.schur import SchurSolver as JSchur
from skeres_tpu.core.schur import _cam_padded_src as j_cam_padded_src
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import types as ttypes
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.schur import SchurSolver, _cam_padded_src, padded_plan
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.parallel.mesh import shard_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SCENE = (6, 50, 3)
ON = dict(sort_threshold=1, pad_waste=100.0)
OFF = dict(sort_threshold=10**12)
MU = 1e-4


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


# -- the plan ---------------------------------------------------------------------------


@pytest.mark.parametrize("tensors", [False, True], ids=["arrays", "tensors"])
@pytest.mark.parametrize("nc,b,n_valid,sentinel", [
    (5, 40, None, None), (7, 64, 50, None), (4, 30, 30, 99), (9, 100, 71, 100),
    (6, 0, None, None), (3000, 20000, None, None)])
def test_cam_padded_src_matches_jax(nc, b, n_valid, sentinel, tensors):
    """The placement equals the JAX package's numpy one element for
    element, from arrays or CPU tensors; cameras with no row and an
    empty batch included."""
    ids = np.random.default_rng(nc * b).integers(0, nc, size=b)
    K = int(np.bincount(ids[: n_valid or b], minlength=nc).max()) if b else 1
    src = _cam_padded_src(torch.from_numpy(ids) if tensors else ids, nc, K, n_valid=n_valid,
                          sentinel=sentinel)
    assert src.dtype == torch.int64
    np.testing.assert_array_equal(
        src.numpy(), j_cam_padded_src(ids, nc, K, n_valid=n_valid, sentinel=sentinel))


def _skewed(bal):
    """``bal`` with camera 0 taking every observation of the first 20
    points: one camera with far more rows than the others."""
    bal.camera_index = bal.camera_index.copy()
    bal.camera_index[: 20 * 3] = 0
    return bal


@pytest.mark.parametrize("tensors", [False, True], ids=["arrays", "tensors"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("case", [
    ("threshold", dict(sort_threshold=151, pad_waste=100.0), False),
    ("at threshold", dict(sort_threshold=150, pad_waste=100.0), False),
    ("default waste", dict(sort_threshold=1), False),
    ("wide waste", dict(sort_threshold=1, pad_waste=3.0), False),
    ("skew", dict(sort_threshold=1, pad_waste=2.0), True),
    ("skew opened", dict(sort_threshold=1, pad_waste=100.0), True),
], ids=lambda c: c[0])
def test_sorted_info_engages_where_jax_does(case, shards, tensors):
    """The gates engage and refuse as the JAX package's, on one device
    and for 2, 3 and 4 shards, from arrays or CPU tensors: the same K, and
    each shard's placement and point map equal to the JAX ``sorted_info``
    (its pad rows and its sentinel taken as the port's sentinel); a
    refusal gives the same note from either input."""
    _, kw, skew = case
    bal = jbal.synthetic_bal(*SCENE)
    bal = _skewed(bal) if skew else bal
    program = jbal.build_bal_problem(bal)[0].compile()
    mesh = None if shards == 1 else jax.sharding.Mesh(np.array(jax.devices()[:shards]), ("obs",))
    jschur = JSchur(JEvaluator(program, mesh=mesh), iterative=True, **kw)
    cam, pt = np.asarray(bal.camera_index), np.asarray(bal.point_index)
    gates = (kw["sort_threshold"], kw.get("pad_waste", 1.5))
    for rank in range(shards):
        if tensors:
            K, plan = padded_plan(torch.from_numpy(cam), torch.from_numpy(pt), bal.num_cameras,
                                  shards, rank, *gates)
            assert (K is None) == (padded_plan(cam, pt, bal.num_cameras, shards, rank, *gates)[0]
                                   is None)
        else:
            K, plan = padded_plan(cam, pt, bal.num_cameras, shards, rank, *gates)
        assert (K is not None) == bool(jschur.sorted_info), (K, plan)
        if K is None:
            assert plan == padded_plan(cam, pt, bal.num_cameras, shards, rank, *gates)[1]
            continue
        info = jschur.sorted_info[0]
        assert (K, bal.num_cameras) == (info["K"], info["nc"])
        assert info["kind"] == ("local" if shards == 1 else "sharded")
        jsrc, jpidx = np.asarray(info["src"]), np.asarray(info["pidx_pad"])
        if shards > 1:
            jsrc, jpidx = jsrc[rank], jpidx[rank]
        lo, hi = shard_rows(len(cam), shards, rank)
        src, pidx = (t.numpy() for t in plan)
        np.testing.assert_array_equal(np.where(src < hi - lo, src, -1),
                                      np.where(jsrc < hi - lo, jsrc, -1))
        assert (src <= hi - lo).all()
        np.testing.assert_array_equal(pidx, jpidx)


# -- the pieces, one linearization ---------------------------------------------------------


class _Lin:
    """One linearization of a scene in both packages on the minimizer's
    path: g and diag with the placed rows, the Jacobi scale,
    and the scaled solver data; solvers of either package on it."""

    def __init__(self, scene):
        bal = jbal.synthetic_bal(*scene)
        jprogram = jbal.build_bal_problem(bal)[0].compile()
        self.jev = JEvaluator(jprogram)
        _, self.jblocks = jax.jit(self.jev.blocks)(jprogram.initial_state(self.jev.dtype))
        self.jg0, self.jdiag0 = jax.jit(self.jev.gradient_and_diag)(self.jblocks)
        self.jscale = 1.0 / (1.0 + jnp.sqrt(self.jdiag0))

        self.tev = Evaluator(tbal.build_bal_problem(bal)[0].compile(), device="cpu")
        _, self.tblocks = self.tev.blocks(self.tev.program.initial_state("cpu", torch.float64))
        self.tg0, self.tdiag0 = self.tev.gradient_and_diag(self.tblocks)
        self.tscale = 1.0 / (1.0 + torch.sqrt(self.tdiag0))
        self.v = np.random.default_rng(3).normal(size=self.tev.num_tangent)
        self._made = {}

    def both(self, cam_raw, **kw):
        """(jschur, jdata, tschur, tdata, jasm, tasm) for solvers made with
        ``kw``, built once a scene."""
        key = (cam_raw, tuple(sorted(kw.items())))
        if key not in self._made:
            jschur, jdata = self.jax(cam_raw=cam_raw, **kw)
            tschur, tdata = self.port(cam_raw=cam_raw, **kw)
            self._made[key] = (jschur, jdata, tschur, tdata,
                               *self.asm(jschur, jdata, tschur, tdata))
        return self._made[key]

    def jax(self, cam_raw=True, **kw):
        schur = JSchur(self.jev, **kw)
        data = schur.scale_data(schur.solver_data(self.jblocks), self.jscale)
        if cam_raw and schur.sorted_info:
            _, _, raw = jax.jit(schur.gradient_and_diag_padded)(self.jblocks)
            return schur, schur.prepare(data, cam_raw=raw, scale=self.jscale)
        return schur, schur.prepare(data)

    def port(self, cam_raw=True, **kw):
        schur = SchurSolver(self.tev, **kw)
        data = schur.scale_data(schur.solver_data(self.tblocks), self.tscale)
        if cam_raw and schur.sorted_info:
            _, _, raw = schur.gradient_and_diag(self.tblocks)
            return schur, schur.prepare(data, cam_raw=raw, scale=self.tscale)
        return schur, schur.prepare(data)

    def asm(self, jschur, jdata, tschur, tdata):
        jd = jlm_diagonal(self.jdiag0 * self.jscale**2, MU, 1e-6, 1e32)
        td = lm_diagonal(self.tdiag0 * self.tscale**2, MU, 1e-6, 1e32)
        return (jschur._assemble(jdata, self.jg0 * self.jscale, jd),
                tschur._assemble(tdata, self.tg0 * self.tscale, td))

    def s_products(self, jkw, tkw, cam_raw):
        """(JAX S v with ``jkw``, port S v with ``tkw``) on the retained
        part of ``v``."""
        jschur, _, _, _, jasm, _ = self.both(cam_raw, **jkw)
        _, _, tschur, _, _, tasm = self.both(cam_raw, **tkw)
        v_f = self.v[: tschur.num_f] if tschur.elim_offset else self.v[-tschur.num_f:]
        return (np.asarray(jschur._s_matvec(jasm, jnp.asarray(v_f))),
                tschur._s_matvec(tasm, torch.as_tensor(v_f)).numpy())


@pytest.fixture(scope="module", params=[SCENE, (8, 90, 3)], ids=["6x50", "8x90"])
def lin(request):
    return _Lin(request.param)


def test_padded_gradient_and_diag_match_jax(lin):
    """g, diag and the raw E^T E of ``gradient_and_diag`` on the layout
    against the JAX package's ``gradient_and_diag_padded``, and g and diag
    against the generic ones."""
    jschur = JSchur(lin.jev, iterative=True, **ON)
    tschur = SchurSolver(lin.tev, iterative=True, **ON)
    assert tschur.sorted_info[0]["kind"] == "local"
    jg, jdiag, jraw = jax.jit(jschur.gradient_and_diag_padded)(lin.jblocks)
    tg, tdiag, traw = tschur.gradient_and_diag(lin.tblocks)
    for got, ref in ((tg, jg), (tdiag, jdiag), (traw[-1], jraw[-1]), (tg, lin.jg0),
                     (tdiag, lin.jdiag0)):
        _close(got.numpy(), ref)
    assert set(traw) == {0, -1}


@pytest.mark.parametrize("cam_raw", [True, False], ids=["cam_raw", "prescaled"])
@pytest.mark.parametrize("piece", ["rhs", "blocks", "blocks_without_e", "jtj_quadratic",
                                   "ftf_diag", "ete0"])
def test_padded_pieces_match_jax_padded(lin, piece, cam_raw):
    """The rhs, the SCHUR_JACOBI blocks with and without the E correction,
    ``jtj_quadratic``, diag(F^T F) and the prepared E^T E against the JAX
    padded path (``prepare`` with and without ``cam_raw``), 1e-12."""
    jschur, jdata, tschur, tdata, jasm, tasm = lin.both(cam_raw, iterative=True, **ON)
    scale = lin.tscale if cam_raw else torch.ones_like(lin.tscale)
    assert torch.equal(tdata["cam_scale"], scale)
    if piece == "rhs":
        got, ref = tschur._schur_rhs(tasm), jschur._schur_rhs(jasm)
    elif piece.startswith("blocks"):
        e_corr = piece == "blocks"
        got = tschur._schur_jacobi_blocks(tasm, include_e_correction=e_corr)[0]
        ref = jschur._schur_jacobi_blocks(jasm, include_e_correction=e_corr)[0]
    elif piece == "jtj_quadratic":
        got = tschur.jtj_quadratic(tdata, torch.as_tensor(lin.v))
        ref = jschur.jtj_quadratic(jdata, jnp.asarray(lin.v))
    elif piece == "ftf_diag":
        got, ref = tschur._ftf_diag(tasm), jschur._ftf_diag(jasm)
    else:
        got, ref = tdata["ete0"], jdata["ete0"]
    _close(got.numpy(), ref)


@pytest.mark.parametrize("e_corr", [True, False], ids=["with_e", "without_e"])
def test_schur_jacobi_blocks_on_and_off_the_layout_agree(lin, e_corr):
    """The SCHUR_JACOBI blocks (with the E correction) and
    POWER_SERIES_EXPANSION's base blocks (without) from the placed rows
    equal those of the row loop, the layout off, 1e-12."""
    _, _, on_schur, _, _, on = lin.both(True, iterative=True, **ON)
    _, _, off_schur, _, _, off = lin.both(True, iterative=True, **OFF)
    assert on_schur.sorted_info and not off_schur.sorted_info
    got = on_schur._schur_jacobi_blocks(on, include_e_correction=e_corr)[0]
    ref = off_schur._schur_jacobi_blocks(off, include_e_correction=e_corr)[0]
    _close(got.numpy(), ref.numpy())


def test_prescaled_s_matvec_matches_jax_padded(lin):
    """S v with pre-scaled placed rows (``prepare(data)`` alone, as the
    covariance calls it) against the JAX padded product, 1e-12."""
    j, t = lin.s_products(dict(iterative=True, **ON), dict(iterative=True, **ON), cam_raw=False)
    _close(t, j)


def test_cam_raw_s_matvec_matches_jax_generic(lin):
    """S v on the minimizer's path (unscaled placed rows, ``cam_scale``
    set) against the JAX generic product, 1e-12; the port's generic
    product too."""
    j, t = lin.s_products(dict(iterative=True, **OFF), dict(iterative=True, **ON), cam_raw=True)
    _close(t, j)
    _, t_generic = lin.s_products(dict(iterative=True, **OFF), dict(iterative=True, **OFF),
                                  cam_raw=True)
    _close(t, t_generic)


def test_note_v_reference_padded_s_matvec_is_unconjugated(lin):
    """ROADMAP Queue 3 note v: on the minimizer's path the JAX padded S
    product parts from the JAX generic one by more than 1e3 relative (it
    leaves the Jacobi scale out), while the port's equals it."""
    j_padded, t_padded = lin.s_products(dict(iterative=True, **ON), dict(iterative=True, **ON),
                                        cam_raw=True)
    j_generic, _ = lin.s_products(dict(iterative=True, **OFF), dict(iterative=True, **OFF),
                                  cam_raw=True)
    gap = np.abs(j_padded - j_generic).max() / np.abs(j_generic).max()
    assert gap > 1e3, gap
    _close(t_padded, j_generic)


# -- full solves ---------------------------------------------------------------------------

_ENUMS = dict(linear_solver_type="LinearSolverType", preconditioner_type="PreconditionerType")
SOLVES = {
    "dense_schur": dict(linear_solver_type="DENSE_SCHUR"),
    "dense_schur_device_loop": dict(linear_solver_type="DENSE_SCHUR", use_device_loop=True,
                                    device_loop_chunk_iterations=4),
    "schur_jacobi": dict(linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="SCHUR_JACOBI"),
    "jacobi": dict(linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="JACOBI"),
    "power_series": dict(linear_solver_type="ITERATIVE_SCHUR",
                         preconditioner_type="POWER_SERIES_EXPANSION"),
    "dense_schur_explicit": dict(linear_solver_type="DENSE_SCHUR"),
    "iterative_explicit": dict(linear_solver_type="ITERATIVE_SCHUR",
                               preconditioner_type="SCHUR_JACOBI",
                               use_explicit_schur_complement=True),
}
ROW_FIELDS = ("cost", "trust_region_radius", "linear_solver_iterations", "step_is_successful")


# tests/test_torch_solve.py's trajectory scene: on SCENE the two packages'
# generic ITERATIVE_SCHUR with JACOBI already part by 3.5e-6 (its PCG on the
# gauge-free scene carries each step's rounding), layout or not
SOLVE_SCENE = (16, 500, 4)


def _kw(types_module, kw, thresh):
    out = dict(max_num_iterations=8, run_full_iteration_budget=True,
               initial_trust_region_radius=1.0, jacobian_sort_threshold=thresh,
               jacobian_pad_waste=100.0)
    for k, v in kw.items():
        out[k] = getattr(getattr(types_module, _ENUMS[k]), v) if k in _ENUMS else v
    return out


def _rows(summary):
    return np.array([[float(getattr(it, f)) for f in ROW_FIELDS] for it in summary.iterations])


def _jax_run(kw, thresh):
    problem, cams, _ = jbal.build_bal_problem(jbal.synthetic_bal(*SOLVE_SCENE))
    s = st.solve(JOptions(**_kw(jtypes, kw, thresh)), problem)
    return _rows(s), cams.values.copy()


def _assert_same(got, ref, rtol=1e-8):
    (a, ca), (b, cb) = got, ref
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a[:, 2:], b[:, 2:])
    np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=rtol)
    np.testing.assert_allclose(ca, cb, rtol=100 * rtol, atol=1e-9)


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_with_layout_follows_jax_generic_trajectory(name, monkeypatch):
    """Each solve with the layout on, step by step within 1e-8 of the JAX
    package's generic path (the same decisions and PCG counts); DENSE_SCHUR
    also of the JAX padded path, which is right there (its damped solve
    reads no padded S product). ``dense_schur_explicit`` takes the
    explicit S (the dense-W gate at 0), whose camera blocks come from the
    placed rows."""
    from skeres_tpu_torch.core import schur as schur_mod

    kw = SOLVES[name]
    if name == "dense_schur_explicit":
        monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    problem, cams, _ = tbal.build_bal_problem(tbal.synthetic_bal(*SOLVE_SCENE))
    s = stt.solve(stt.SolverOptions(device="cpu", **_kw(ttypes, kw, 1)), problem)
    assert s.camera_padded_layout.startswith("batch 0: 16 x "), s.camera_padded_layout
    mine = (_rows(s), cams.values.copy())
    if name == "dense_schur_device_loop":
        # against the JAX host loop: the JAX device loop runs whole chunks
        # (ROADMAP Queue 3 note c) and turns the layout off
        kw = SOLVES["dense_schur"]
    _assert_same(mine, _jax_run(kw, 10**12))
    if name in ("dense_schur", "dense_schur_device_loop"):
        _assert_same(mine, _jax_run(kw, 1))
