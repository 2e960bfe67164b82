"""The implicit S product's kernel pair and the camera blocks' kernel
(``ops/s_product.py``) on the CPU: the plans the kernels read (the rows by
point, each camera's placed rows), the plain versions that CPU tensors
take, the checks of the wrappers, and the camera-padded product through
the passes and the camera blocks through their wrapper against the
generic path on every structure that reaches them. The kernels themselves run in
``tests/test_torch_gpu.py``; float64, 1e-12 relative (sums in another
order)."""

import dataclasses

import numpy as np
import pytest
import torch

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.linear_solvers import lm_diagonal
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
from skeres_tpu_torch.models.reprojection import snavely_reprojection_error
from skeres_tpu_torch.ops import s_product as sp

ON = dict(sort_threshold=1, pad_waste=100.0)
OFF = dict(sort_threshold=10**12)
KINDS = ("uniform", "ragged", "shuffled", "prior", "two batches")


def _program(kind):
    """synthetic_bal(8, 90, 3): its rows as they come (grouped by point,
    3 a point: the point-reduce plan a reshape), with every fifth row left
    out (grouped, 2-3 a point: an index plan), shuffled, with a prior on
    every camera (a second batch adding to S), or split into two
    observation batches."""
    bal = synthetic_bal(8, 90, 3)
    rows = np.arange(len(bal.point_index))
    if kind == "ragged":
        rows = rows[rows % 5 != 0]
    elif kind == "shuffled":
        rows = np.random.default_rng(3).permutation(rows)
    bal = dataclasses.replace(bal, camera_index=bal.camera_index[rows],
                              point_index=bal.point_index[rows],
                              observations=bal.observations[rows])
    if kind != "two batches":
        problem, cameras, _ = build_bal_problem(bal)
        if kind == "prior":
            problem.add_residual_blocks(lambda p, d: 0.3 * (p[0] - d), None,
                                        [(cameras, np.arange(bal.num_cameras))],
                                        data=bal.cameras.copy(), name="prior")
        return problem.compile()
    problem = stt.Problem()
    cameras = problem.add_parameter_block_array(bal.cameras, name="cameras")
    points = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(cameras, 1)
    half = len(rows) // 2
    for name, sel in (("near", slice(0, half)), ("far", slice(half, None))):
        problem.add_residual_blocks(
            snavely_reprojection_error, None,
            [(cameras, bal.camera_index[sel]), (points, bal.point_index[sel])],
            data=bal.observations[sel], name=name)
    return problem.compile()


def _assembled(program, cam_raw, iterative=True):
    """The padded and the generic solver, each with its assembly at the
    first linearization (the padded one on the minimizer's unscaled placed
    rows where ``cam_raw``, else on pre-scaled ones)."""
    ev = Evaluator(program, "cpu", torch.float64)
    _, blocks = ev.blocks(program.initial_state("cpu", torch.float64))
    g, diag = ev.gradient_and_diag(blocks)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    out = {}
    for form, kw in (("padded", ON), ("generic", OFF)):
        schur = SchurSolver(ev, iterative=iterative, **kw)
        data = schur.scale_data(schur.solver_data(blocks), scale)
        if form == "padded" and cam_raw:
            _, _, raw = schur.gradient_and_diag(blocks)
            prep = schur.prepare(data, cam_raw=raw, scale=scale)
        else:
            prep = schur.prepare(data)
        out[form] = schur, schur._assemble(prep, g * scale,
                                           lm_diagonal(diag * scale**2, 1e-4, 1e-6, 1e32))
    return out


def _products(program, cam_raw):
    """S v by the camera-padded layout and by the generic path
    (:func:`_assembled`); and the padded solver."""
    out = {}
    for form, (schur, asm) in _assembled(program, cam_raw).items():
        v = torch.linspace(-1.0, 2.0, schur.num_f, dtype=torch.float64)
        out[form] = schur._s_matvec(asm, v)
        out[form + " solver"] = schur
    return out


@pytest.mark.parametrize("kind", ["uniform", "ragged", "shuffled"])
def test_plans_of_the_passes(kind):
    """The point pass's offsets (and, on shuffled rows, its permutation)
    give every row the destination that the evaluator's point-reduce plan
    gives it; each camera's placed rows that hold observations are the
    first ``cam_rows[c]`` of its K, the rest the sentinel."""
    program = _program(kind)
    ev = Evaluator(program, "cpu", torch.float64)
    schur = SchurSolver(ev, iterative=True, **ON)
    sinfo = schur.sorted_info[0]
    plan = ev._slot_plans[0][schur.e_slot]
    assert plan.kind == ("contig" if kind == "uniform" else "scatter")
    dest = (plan.idx if plan.kind == "scatter"
            else torch.arange(plan.n_dest).repeat_interleave(plan.k))
    n_rows = len(dest)
    seg, perm = sinfo["pt_seg"], sinfo["pt_perm"]
    assert (perm is None) == (kind != "shuffled")
    order = torch.arange(n_rows) if perm is None else perm
    assert torch.equal(torch.sort(order).values, torch.arange(n_rows))
    assert seg.shape == (schur.num_points + 1,) and int(seg[0]) == 0 and int(seg[-1]) == n_rows
    point_of = torch.repeat_interleave(torch.arange(schur.num_points), seg.diff())
    assert torch.equal(dest[order], point_of)
    nc, K, counts = sinfo["nc"], sinfo["K"], sinfo["cam_rows"]
    assert int(counts.sum()) == n_rows and int(counts.max()) == K
    holds = sinfo["src"].view(nc, K) < n_rows
    assert torch.equal(holds, torch.arange(K)[None, :] < counts[:, None])
    assert sinfo["f_first"] and schur._one_padded


@pytest.mark.parametrize("cam_raw", [True, False], ids=["cam_raw", "prescaled"])
@pytest.mark.parametrize("kind", KINDS)
def test_padded_s_product_through_the_passes_matches_generic(kind, cam_raw, monkeypatch):
    """S v through the two passes (their plain versions here: no launch)
    against the generic product, 1e-12 of max|S v|: one padded batch (the
    point pass applies C^-1), one beside a prior (its sums added to the
    prior's), and two padded batches (W^T v summed over both before
    C^-1). The camera blocks of S, with the E correction (SCHUR_JACOBI)
    and without (POWER_SERIES_EXPANSION's ``F^T F``), take one
    :func:`camera_blocks` call a padded batch and equal the row loop's
    within 1e-12 of max|block|."""
    from skeres_tpu_torch.core import schur as schur_mod

    calls = []

    def counting(*args):
        calls.append(args[5] is not None)
        return sp.camera_blocks(*args)

    monkeypatch.setattr(schur_mod, "camera_blocks", counting)
    launches = (sp.point_sums.launches, sp.camera_sums.launches, sp.camera_blocks.launches)
    program = _program(kind)
    out = _products(program, cam_raw)
    schur = out["padded solver"]
    assert sorted(schur.sorted_info) == ([0, 1] if kind == "two batches" else [0])
    assert schur._one_padded == (kind != "two batches")
    ref = out["generic"]
    torch.testing.assert_close(out["padded"], ref, rtol=0,
                               atol=1e-12 * float(ref.abs().max()))
    (padded, on), (generic, off) = _assembled(program, cam_raw).values()
    for e_corr in (True, False):
        calls.clear()
        got = padded._schur_jacobi_blocks(on, include_e_correction=e_corr)
        want = generic._schur_jacobi_blocks(off, include_e_correction=e_corr)
        assert calls == [e_corr] * len(padded.sorted_info)
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * float(b.abs().max()))
    assert (sp.point_sums.launches, sp.camera_sums.launches,
            sp.camera_blocks.launches) == launches


def _pass_inputs(dtype=torch.float64, f_first=True):
    """Random inputs of both passes: 40 points with 1-6 rows each, 5
    cameras, (m, t, e) = (2, 9, 3), the rows' values 26 a row (12 and 12,
    then 2 that the passes do not read, as the minimizer's placed rows)."""
    g = torch.Generator().manual_seed(5)
    n_pts, nc, m, t, e = 40, 5, 2, 9, 3
    pt = torch.repeat_interleave(torch.arange(n_pts), torch.randint(1, 7, (n_pts,), generator=g))
    b = len(pt)
    cam = torch.randint(0, nc, (b,), generator=g)
    wide = torch.randn(b, m * (t + e) + 2, generator=g, dtype=dtype)
    rows = wide[:, : m * (t + e)].unflatten(1, (m, t + e))
    seg = torch.searchsorted(pt, torch.arange(n_pts + 1))
    K = int(torch.bincount(cam, minlength=nc).max())
    order = torch.argsort(cam, stable=True)
    placed = wide.new_zeros((nc * K, wide.shape[1]))
    pidx = torch.zeros(nc * K, dtype=torch.int64)
    counts = torch.bincount(cam, minlength=nc)
    slot = torch.arange(b) - torch.cumsum(counts, 0)[cam[order]] + counts[cam[order]]
    placed[cam[order] * K + slot] = wide[order]
    pidx[cam[order] * K + slot] = pt[order]
    return dict(
        rows=rows, f_first=f_first, cam=cam, seg=seg,
        placed=placed[:, : m * (t + e)].unflatten(1, (m, t + e)), pidx=pidx, counts=counts,
        v_cam=torch.randn(nc, t, generator=g, dtype=dtype),
        cinv=torch.randn(n_pts, e, e, generator=g, dtype=dtype),
        s_e=torch.rand(n_pts, e, generator=g, dtype=dtype),
        s_f=torch.rand(nc, t, generator=g, dtype=dtype))


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result bit
    for bit and launches nothing; the camera pass on rows placed camera by
    camera equals the product of the rows in row order."""
    x = _pass_inputs()
    launches = (sp.point_sums.launches, sp.camera_sums.launches)
    wc = sp.point_sums(x["rows"], True, x["cam"], x["v_cam"], x["seg"], None, x["cinv"], x["s_e"])
    assert torch.equal(wc, sp.point_sums_reference(x["rows"], True, x["cam"], x["v_cam"], x["seg"],
                                                   None, x["cinv"], x["s_e"]))
    out = sp.camera_sums(x["placed"], True, x["pidx"], x["counts"], x["v_cam"], wc, x["s_f"])
    assert torch.equal(out, sp.camera_sums_reference(x["placed"], True, x["pidx"], x["counts"],
                                                     x["v_cam"], wc, x["s_f"]))
    assert (sp.point_sums.launches, sp.camera_sums.launches) == launches
    # the same sums by rows in row order
    F, E = x["rows"][:, :, :9], x["rows"][:, :, 9:]
    pt = torch.repeat_interleave(torch.arange(40), x["seg"].diff())
    v_in = x["v_cam"] * x["s_f"]
    res = torch.einsum("bmt,bt->bm", F, v_in[x["cam"]]) - torch.einsum("bme,be->bm", E, wc[pt])
    ref = torch.zeros_like(out).index_add_(0, x["cam"], torch.einsum("bmt,bm->bt", F, res))
    ref = x["s_f"] * ref
    torch.testing.assert_close(out, ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("terms", ["F^T F", "C^-1", "C^-1 s_e"])
def test_camera_blocks_on_cpu_take_the_plain_version(terms):
    """On CPU tensors :func:`camera_blocks` returns its plain version's
    result bit for bit and launches nothing; the blocks equal the per-row
    ``F^T (I - E (s_e C^-1 s_e) E^T) F`` summed by camera over the rows in
    row order, within 1e-13 of max|block|."""
    x = _pass_inputs()
    cinv = x["cinv"] @ x["cinv"].transpose(1, 2) if terms != "F^T F" else None  # SPD, as C^-1
    s_e = x["s_e"] if terms == "C^-1 s_e" else None
    launches = sp.camera_blocks.launches
    args = (x["placed"], True, x["pidx"], x["counts"], 9, cinv, s_e)
    out = sp.camera_blocks(*args)
    assert torch.equal(out, sp.camera_blocks_reference(*args))
    assert sp.camera_blocks.launches == launches and out.shape == (5, 9, 9)
    F, E = x["rows"][:, :, :9], x["rows"][:, :, 9:]
    pt = torch.repeat_interleave(torch.arange(40), x["seg"].diff())
    mid = torch.eye(2, dtype=torch.float64).expand(len(pt), 2, 2)
    if cinv is not None:
        cs = cinv if s_e is None else cinv * s_e[:, :, None] * s_e[:, None, :]
        mid = mid - E @ cs[pt] @ E.transpose(1, 2)
    ref = torch.zeros_like(out).index_add_(0, x["cam"], F.transpose(1, 2) @ mid @ F)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-13 * float(ref.abs().max()))


@pytest.mark.parametrize("fault", ["half rows", "int32 cam", "strided rows", "wide camera",
                                   "wc dtype", "counts", "blocks past sizes", "blocks cinv dtype",
                                   "blocks device", "blocks s_e alone"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fault):
    """Each fault raises before anything runs, on the CPU as on the card."""
    x = _pass_inputs()
    wc = sp.point_sums(x["rows"], True, x["cam"], x["v_cam"], x["seg"])
    point = dict(rows=x["rows"], f_first=True, cam=x["cam"], v_cam=x["v_cam"], seg=x["seg"])
    camera = dict(placed=x["placed"], f_first=True, pidx=x["pidx"], counts=x["counts"],
                  v_cam=x["v_cam"], wc=wc)
    blocks = dict(placed=x["placed"], f_first=True, pidx=x["pidx"], counts=x["counts"], t=9,
                  cinv=x["cinv"], s_e=x["s_e"])
    if fault == "half rows":
        call, err = lambda: sp.point_sums(**dict(point, rows=x["rows"].half())), TypeError
    elif fault == "int32 cam":
        call, err = lambda: sp.point_sums(**dict(point, cam=x["cam"].int())), ValueError
    elif fault == "strided rows":
        call, err = lambda: sp.point_sums(**dict(point, rows=x["rows"][:, :, ::2])), ValueError
    elif fault == "wide camera":
        wide = torch.zeros(len(x["cam"]), 2, 20, dtype=torch.float64)
        call = lambda: sp.point_sums(**dict(point, rows=wide, v_cam=torch.zeros(5, 17)))  # noqa: E731
        err = ValueError
    elif fault == "wc dtype":
        call, err = lambda: sp.camera_sums(**dict(camera, wc=wc.float())), ValueError
    elif fault == "counts":
        call, err = lambda: sp.camera_sums(**dict(camera, counts=x["counts"][:-1])), ValueError
    elif fault == "blocks past sizes":  # m = 5 residuals a row
        wide = torch.zeros(x["placed"].shape[0], 5, 12, dtype=torch.float64)
        call, err = lambda: sp.camera_blocks(**dict(blocks, placed=wide)), ValueError
    elif fault == "blocks cinv dtype":
        call, err = lambda: sp.camera_blocks(**dict(blocks, cinv=x["cinv"].float())), ValueError
    elif fault == "blocks device":
        meta = {k: v.to("meta") for k, v in blocks.items() if isinstance(v, torch.Tensor)}
        call, err = lambda: sp.camera_blocks(**dict(blocks, **meta)), ValueError
    else:
        call, err = lambda: sp.camera_blocks(**dict(blocks, cinv=None)), ValueError
    with pytest.raises(err):
        call()


def _stacked(copies):
    """synthetic_bal(8, 90, 3) with ``copies`` stacked reprojection
    residuals a row: (m, t, e) = (2 copies, 9, 3)."""
    bal = synthetic_bal(8, 90, 3)
    problem = stt.Problem()
    cameras = problem.add_parameter_block_array(bal.cameras, name="cameras")
    points = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(cameras, 1)
    problem.add_residual_blocks(
        lambda p, d: torch.cat([snavely_reprojection_error(p, d) * 0.5**k for k in range(copies)]),
        None, [(cameras, bal.camera_index), (points, bal.point_index)],
        data=bal.observations, name="stacked")
    return problem.compile()


@pytest.mark.parametrize("copies", [2, 3], ids=["m=4", "m=6"])
def test_layout_gate_refuses_sizes_the_kernels_do_not_take(copies):
    """A batch of ``copies`` stacked reprojection residuals a row (m = 2
    copies): within the kernels' (4, 16, 4) ITERATIVE_SCHUR and
    DENSE_SCHUR take the camera-padded layout; past it both refuse it with
    the sizes in its note and the batch takes the generic branch, whose S
    product the padded solver then gives."""
    program = _stacked(copies)
    ev = Evaluator(program, "cpu", torch.float64)
    for iterative in (True, False):
        schur = SchurSolver(ev, iterative=iterative, **ON)
        if copies == 2:
            assert 0 in schur.sorted_info
        else:
            assert schur.sorted_info == {}
            assert schur.camera_padded_layout == (
                f"batch 0: off (S product kernels: (m, t, e) (6, 9, 3) past {sp.MAX_SIZES})")
    out = _products(program, cam_raw=False)
    ref = out["generic"]
    torch.testing.assert_close(out["padded"], ref, rtol=0, atol=1e-12 * float(ref.abs().max()))


def test_dense_schur_blocks_past_the_kernel_sizes_take_the_row_loop(monkeypatch):
    """DENSE_SCHUR on a batch of three stacked reprojection residuals a row
    (m = 6, past the kernels' (4, 16, 4)): the batch is off the layout, so
    its camera blocks come from the row loop, never from
    :func:`camera_blocks` or its plain version, and equal the generic
    solver's within 1e-12 of max|block|."""
    from skeres_tpu_torch.core import schur as schur_mod

    def refuse(*args):
        raise AssertionError("camera_blocks called off the layout")

    monkeypatch.setattr(schur_mod, "camera_blocks", refuse)
    out = _assembled(_stacked(3), cam_raw=True, iterative=False)
    (padded, on), (generic, off) = out["padded"], out["generic"]
    assert padded.sorted_info == {}
    got, ref = padded._schur_jacobi_blocks(on)[0], generic._schur_jacobi_blocks(off)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12 * float(ref.abs().max()))
