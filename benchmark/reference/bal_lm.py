"""The plain reference of a bundle-adjustment solve: Levenberg-Marquardt on
the Snavely model in plain torch, float64.

It follows the formulas of Ceres's trust-region minimizer
(``trust_region_minimizer.cc``, ``levenberg_marquardt_strategy.cc``) as
the solver options state them, with nothing of the program under test:

- residuals ``r = project(camera, point) - observation``, cost ``0.5 |r|^2``,
  the Jacobian rows by forward-mode differentiation (``torch.func.jvp``),
  one tangent direction of the 12 at a time;
- Jacobi column scaling ``1 / (1 + sqrt(diag(J^T J)))``, taken afresh at
  every linearization, and the damping ``clamp(diag, min, max) / radius``;
- the damped step by Schur elimination of the points:
  ``S = U + D_c - sum_p W_p C_p^-1 W_p^T`` over the camera coordinates,
  either assembled densely block by block (every pair of a point's
  observations adds ``A_a C_p^-1 A_b^T``) and solved by a Cholesky
  factorization (DENSE_SCHUR), or applied implicitly inside conjugate
  gradients with the block-Jacobi preconditioner of S's camera blocks and
  the Nash-Sofer Q-test (ITERATIVE_SCHUR with SCHUR_JACOBI); then the
  points by back-substitution;
- the step quality, the radius update, and the gradient, function and
  parameter tolerance tests.

``solve`` returns the costs of the accepted iterates (the start first),
the final parameters and the final cost.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.snavely import project

__all__ = ["BalLM"]

ROWS_PER_CHUNK = 1 << 20  # rows differentiated at a time
POINTS_PER_CHUNK = 1 << 18  # points per block of S's pair products


def _grid_of(index: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of each of ``n`` owners by ``index``, (n, kmax), padded with
    ``len(index)`` (a zero row): a sum over an owner's rows is then a
    gather and a sum in a fixed order."""
    order = torch.argsort(index, stable=True)
    counts = torch.bincount(index, minlength=n)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(index.numel(), device=index.device) - first[index[order]]
    kmax = int(counts.max()) if index.numel() else 0
    grid = torch.full((n, kmax), index.numel(), dtype=torch.long, device=index.device)
    grid[index[order], slot] = order
    return grid


def _sum_by(grid: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per owner of ``grid``, the sum of its rows of ``values``."""
    padded = torch.cat([values, values.new_zeros((1,) + tuple(values.shape[1:]))])
    return padded[grid].sum(dim=1)


class BalLM:
    """Levenberg-Marquardt for one BAL problem: observations ``observations``
    (B, 2) of point ``point_index`` in camera ``camera_index``."""

    def __init__(self, camera_index, point_index, observations, num_cameras: int,
                 num_points: int, device, dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.nc, self.npt = int(num_cameras), int(num_points)
        self.ci = torch.as_tensor(np.asarray(camera_index), device=device).long()
        self.pi = torch.as_tensor(np.asarray(point_index), device=device).long()
        self.obs = torch.as_tensor(np.asarray(observations), device=device).to(dtype)
        self.num_rows = self.ci.numel()
        # each camera's and each point's observation rows (padded)
        self.camera_rows = _grid_of(self.ci, self.nc)
        self.point_rows = _grid_of(self.pi, self.npt)

    # -- evaluation -------------------------------------------------------------

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), device=self.device).to(self.dtype)

    def residuals(self, cameras: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        return project(cameras[self.ci], points[self.pi]) - self.obs

    def cost(self, cameras, points) -> float:
        """0.5 |r|^2 at the given parameters (arrays or tensors)."""
        r = self.residuals(self._tensor(cameras), self._tensor(points))
        return 0.5 * float(torch.sum(r * r))

    def linearize(self, cameras: torch.Tensor, points: torch.Tensor):
        """(r (B, 2), J_camera (B, 2, 9), J_point (B, 2, 3))."""
        r = torch.empty((self.num_rows, 2), dtype=self.dtype, device=self.device)
        jc = torch.empty((self.num_rows, 2, 9), dtype=self.dtype, device=self.device)
        jp = torch.empty((self.num_rows, 2, 3), dtype=self.dtype, device=self.device)
        for lo in range(0, self.num_rows, ROWS_PER_CHUNK):
            hi = min(lo + ROWS_PER_CHUNK, self.num_rows)
            c, p, o = cameras[self.ci[lo:hi]], points[self.pi[lo:hi]], self.obs[lo:hi]

            def f(c_, p_):
                return project(c_, p_) - o

            zc, zp = torch.zeros_like(c), torch.zeros_like(p)
            for j in range(12):
                tc, tp = zc.clone(), zp.clone()
                (tc if j < 9 else tp)[:, j if j < 9 else j - 9] = 1.0
                value, column = torch.func.jvp(f, (c, p), (tc, tp))
                if j < 9:
                    jc[lo:hi, :, j] = column
                else:
                    jp[lo:hi, :, j - 9] = column
            r[lo:hi] = value
        return r, jc, jp

    # -- the damped step ----------------------------------------------------------

    def _prepare(self, r, jc, jp):
        """What every damped solve of one linearization shares."""
        ci, pi, cams, pts = self.ci, self.pi, self.camera_rows, self.point_rows
        g_c = _sum_by(cams, torch.einsum("bmi,bm->bi", jc, r))
        g_p = _sum_by(pts, torch.einsum("bmi,bm->bi", jp, r))
        d_c = _sum_by(cams, torch.sum(jc * jc, dim=1))
        d_p = _sum_by(pts, torch.sum(jp * jp, dim=1))
        s_c, s_p = 1.0 / (1.0 + torch.sqrt(d_c)), 1.0 / (1.0 + torch.sqrt(d_p))
        fs = jc * s_c[ci][:, None, :]
        es = jp * s_p[pi][:, None, :]
        return dict(
            g_c=g_c, g_p=g_p, s_c=s_c, s_p=s_p,
            gs_c=g_c * s_c, gs_p=g_p * s_p, ds_c=d_c * s_c * s_c, ds_p=d_p * s_p * s_p,
            u=_sum_by(cams, torch.einsum("bmi,bmj->bij", fs, fs)),
            v=_sum_by(pts, torch.einsum("bmi,bmj->bij", es, es)),
            a=torch.einsum("bmi,bmj->bij", fs, es),  # (B, 9, 3)
        )

    def _dense_s(self, lin, cinv, d_c):
        """S = U + D_c - sum_p sum_(a, b) A_a C_p^-1 A_b^T, block by block."""
        nc, a = self.nc, lin["a"]
        s4 = torch.zeros((nc, nc, 9, 9), dtype=self.dtype, device=self.device)
        cams = torch.arange(nc, device=self.device)
        s4[cams, cams] = lin["u"] + torch.diag_embed(d_c)
        flat = s4.view(nc * nc, 81)
        kmax = self.point_rows.shape[1]
        for p0 in range(0, self.npt, POINTS_PER_CHUNK):
            rows = self.point_rows[p0 : p0 + POINTS_PER_CHUNK]
            cinv_chunk = cinv[p0 : p0 + POINTS_PER_CHUNK]
            for ka in range(kmax):
                for kb in range(ka, kmax):
                    pad = self.num_rows
                    ok = torch.nonzero((rows[:, ka] < pad) & (rows[:, kb] < pad))[:, 0]
                    ra, rb = rows[ok, ka], rows[ok, kb]
                    t = torch.bmm(torch.bmm(a[ra], cinv_chunk[ok]), a[rb].transpose(1, 2))
                    ca, cb = self.ci[ra], self.ci[rb]
                    flat.index_add_(0, ca * nc + cb, -t.reshape(-1, 81))
                    if ka != kb:
                        flat.index_add_(0, cb * nc + ca, -t.transpose(1, 2).reshape(-1, 81))
        return s4.permute(0, 2, 1, 3).reshape(nc * 9, nc * 9)

    def _pcg(self, matvec, b, precond, max_iterations: int, q_tolerance: float):
        """Conjugate gradients from 0, stopped by the Q-test
        ``i (Q_i - Q_(i-1)) / Q_i < q_tolerance`` with
        ``Q(x) = 0.5 x'Ax - b'x``, or at ``max_iterations``, or on a zero
        residual. Returns (x, iterations)."""
        x = torch.zeros_like(b)
        r = b.clone()
        p = precond(r)
        rz, rr = (float(v) for v in torch.stack([torch.dot(r, p), torch.dot(r, r)]).tolist())
        q_prev = 0.0
        it = 0
        while it < max_iterations and rr > 0.0:
            ap = matvec(p)
            pap = float(torch.dot(p, ap))
            alpha = rz / pap if pap > 0.0 else 0.0
            x += alpha * p
            r -= alpha * ap
            z = precond(r)
            rz_new, q, rr = torch.stack([torch.dot(r, z), -0.5 * (torch.dot(x, b) + torch.dot(x, r)),
                                         torch.dot(r, r)]).tolist()
            p = z + (rz_new / (rz if rz > 0.0 else 1.0)) * p
            rz = rz_new
            it += 1
            zeta = it * (q - q_prev) / (q if q != 0.0 else 1.0)
            if q != 0.0 and zeta < q_tolerance:
                break
            q_prev = q
        return x, it

    def damped_step(self, lin, mu: float, opts: dict):
        """The scaled step y of ``(J_s^T J_s + D) y = -g_s`` by Schur
        elimination: (y_c (nc, 9), y_p (npt, 3), linear solver iterations)."""
        nc, ci, pi, a = self.nc, self.ci, self.pi, lin["a"]
        cams, pts = self.camera_rows, self.point_rows
        lo, hi = opts["min_lm_diagonal"], opts["max_lm_diagonal"]
        d_c = torch.clamp(lin["ds_c"], lo, hi) * mu
        d_p = torch.clamp(lin["ds_p"], lo, hi) * mu
        cinv = torch.linalg.inv(lin["v"] + torch.diag_embed(d_p))
        b_p = -lin["gs_p"]
        y_p0 = torch.einsum("pij,pj->pi", cinv, b_p)
        rhs = -lin["gs_c"] - _sum_by(cams, torch.einsum("bij,bj->bi", a, y_p0[pi]))
        if opts["linear_solver_type"] == "DENSE_SCHUR":
            s = self._dense_s(lin, cinv, d_c)
            l_factor, info = torch.linalg.cholesky_ex(s)
            if int(info) != 0:
                y_c = torch.full_like(rhs, float("nan"))
            else:
                y_c = torch.cholesky_solve(rhs.reshape(-1, 1), l_factor).reshape(nc, 9)
            iterations = 1
        elif (opts["linear_solver_type"] == "ITERATIVE_SCHUR"
              and opts["preconditioner_type"] == "SCHUR_JACOBI"):
            u_d = lin["u"] + torch.diag_embed(d_c)
            blocks = u_d - _sum_by(cams, torch.bmm(torch.bmm(a, cinv[pi]), a.transpose(1, 2)))
            binv = torch.linalg.inv(blocks)

            def matvec(v):
                v = v.view(nc, 9)
                w = _sum_by(pts, torch.einsum("bji,bj->bi", a, v[ci]))
                wc = torch.einsum("pij,pj->pi", cinv, w)
                out = torch.einsum("cij,cj->ci", u_d, v) - _sum_by(
                    cams, torch.einsum("bij,bj->bi", a, wc[pi]))
                return out.reshape(-1)

            def precond(v):
                return torch.einsum("cij,cj->ci", binv, v.view(nc, 9)).reshape(-1)

            y, iterations = self._pcg(matvec, rhs.reshape(-1), precond,
                                      opts["max_linear_solver_iterations"], opts["eta"])
            y_c = y.view(nc, 9)
        else:
            raise ValueError(f"the reference solves DENSE_SCHUR, or ITERATIVE_SCHUR with "
                             f"SCHUR_JACOBI, not {opts['linear_solver_type']} with "
                             f"{opts.get('preconditioner_type')}")
        y_p = torch.einsum("pij,pj->pi", cinv,
                           b_p - _sum_by(pts, torch.einsum("bji,bj->bi", a, y_c[ci])))
        return y_c, y_p, iterations

    # -- the trust-region loop ----------------------------------------------------

    def solve(self, cameras0, points0, opts: dict, max_accepted: int | None = None) -> dict:
        """Levenberg-Marquardt from ``(cameras0, points0)`` under the solver
        options ``opts`` (the keys of a cell file's ``options``); with
        ``max_accepted``, stopped after that many accepted steps."""
        if opts["trust_region_strategy_type"] != "LEVENBERG_MARQUARDT" or \
                opts["use_nonmonotonic_steps"] or not opts["jacobi_scaling"]:
            raise ValueError("the reference runs monotonic, Jacobi-scaled Levenberg-Marquardt")
        cams, pts = self._tensor(cameras0), self._tensor(points0)
        radius = float(opts["initial_trust_region_radius"])
        decrease = 2.0
        invalid = 0
        r, jc, jp = self.linearize(cams, pts)
        cost = 0.5 * float(torch.sum(r * r))
        lin = self._prepare(r, jc, jp)
        gmax = float(torch.max(torch.cat([lin["g_c"].abs().flatten(),
                                          lin["g_p"].abs().flatten()])))
        accepted = [cost]
        linear_iterations = []
        termination = "NO_CONVERGENCE"
        if gmax <= opts["gradient_tolerance"]:
            termination = "CONVERGENCE"
        iteration = 0
        while termination == "NO_CONVERGENCE" and iteration < opts["max_num_iterations"]:
            iteration += 1
            y_c, y_p, lin_it = self.damped_step(lin, 1.0 / radius, opts)
            linear_iterations.append(lin_it)
            dx_c, dx_p = y_c * lin["s_c"], y_p * lin["s_p"]
            new_cams, new_pts = cams + dx_c, pts + dx_p
            jdx = (torch.einsum("bmi,bi->bm", jc, dx_c[self.ci])
                   + torch.einsum("bmi,bi->bm", jp, dx_p[self.pi]))
            model = -(float(torch.sum(lin["g_c"] * dx_c) + torch.sum(lin["g_p"] * dx_p))
                      + 0.5 * float(torch.sum(jdx * jdx)))
            step_norm = math.sqrt(float(torch.sum(y_c * y_c) + torch.sum(y_p * y_p)))
            new_r = self.residuals(new_cams, new_pts)
            new_cost = 0.5 * float(torch.sum(new_r * new_r))
            x_norm = math.sqrt(float(torch.sum(new_cams * new_cams) + torch.sum(new_pts * new_pts)))
            if not (math.isfinite(new_cost) and math.isfinite(model)
                    and math.isfinite(step_norm) and model > 0.0):
                invalid += 1
                if invalid >= opts["max_num_consecutive_invalid_steps"]:
                    termination = "FAILURE"
                    break
                radius = max(radius / decrease, opts["min_trust_region_radius"])
                decrease *= 2.0
                if radius <= opts["min_trust_region_radius"]:
                    termination = "CONVERGENCE"
                continue
            invalid = 0
            quality = (cost - new_cost) / model
            success = quality > opts["min_relative_decrease"]
            cost_before = cost
            if success:
                radius = min(radius / max(1.0 / 3.0, 1.0 - (2.0 * quality - 1.0) ** 3),
                             opts["max_trust_region_radius"])
                decrease = 2.0
                cams, pts, cost = new_cams, new_pts, new_cost
                accepted.append(new_cost)
                if max_accepted is not None and len(accepted) > max_accepted:
                    termination = "STOPPED"
                    break
                r, jc, jp = self.linearize(cams, pts)
                lin = self._prepare(r, jc, jp)
                gmax = float(torch.max(torch.cat([lin["g_c"].abs().flatten(),
                                                  lin["g_p"].abs().flatten()])))
                if gmax <= opts["gradient_tolerance"]:
                    termination = "CONVERGENCE"
                    break
                if abs(cost_before - new_cost) <= opts["function_tolerance"] * abs(cost_before):
                    termination = "CONVERGENCE"
                    break
            else:
                radius /= decrease
                decrease *= 2.0
            ptol = opts["parameter_tolerance"]
            if ptol > 0 and step_norm <= ptol * (x_norm + ptol):
                termination = "CONVERGENCE"
            elif radius <= opts["min_trust_region_radius"]:
                termination = "CONVERGENCE"
        return dict(
            accepted_costs=accepted, cameras=cams, points=pts, final_cost=cost,
            iterations=iteration, linear_iterations=linear_iterations, termination=termination,
        )
