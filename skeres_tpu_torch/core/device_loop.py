"""The device loop: chunks of LM steps with no host read inside.

PyTorch counterpart of ``skeres_tpu/core/device_loop.py``. The JAX package
compiles a chunk of the LM loop into one XLA program (``lax.while_loop``,
``lax.cond``); here one LM step is captured as one CUDA graph
(``core/graph.py``) and a chunk is K replays of it:

- the whole step sits under an IF node on ``term == RUNNING and it <
  limit``, so the replays after a termination do nothing;
- the trust-region control (step quality, radius, the convergence tests)
  is ``torch.where`` on device scalars, with the reference's formulas;
- the relinearization runs under ``cond`` on an accepted step and writes
  the new ``(state, cost, g, diag, data, scale)`` into the carry's
  buffers in place; the damped solve's jitter ladder and PCG fallback are
  IF nodes of their own (``SchurSolver.solve_damped``), and every PCG
  (DENSE_SCHUR's fallback, ITERATIVE_SCHUR, CGNR) and the power series of a
  preconditioner are WHILE nodes (``core/graph.py:while_loop``);
- the history (cost, radius, step norm, max|g|, relative decrease,
  accepted, linear solver iterations) is written at the device index
  ``it``, since one graph serves every iteration;
- after the K replays the host makes ONE packed device-to-host fetch.

A bounded problem's candidate is projected onto the box and its
convergence test reads the projected gradient, as in the JAX package's
device loop, which has no projected line search (the host loop's); inner
iterations refine the candidate inside the step, their tolerance-stopped
sweeps one WHILE node.

On the CPU the same step runs eagerly (``cond`` reads its predicate), so
the CPU tests hold the port's device loop against the JAX package's.

Limits, as in the JAX package: Levenberg-Marquardt only, monotonic steps
only, no callbacks and no checkpoints inside the loop. Unlike the JAX
form, the last chunk stops at ``max_num_iterations`` exactly. Every linear
solver runs under it. DENSE_QR takes its step by the corrected seminormal
equations (``core/linear_solvers.py:solve_dense_qr_seminormal``:
``cholesky_ex``, two ``solve_triangular``, one refinement) on every device:
``torch.linalg.qr`` cannot be captured inside a conditional node
(cudaErrorInvalidValue when the capture ends; torch 2.11, CUDA 12.8).

Under a mesh (``parallel/mesh.py``) the captured step holds the
collectives of every reduction, NCCL's in the graph: the communicator is
warmed by one ``all_reduce`` before the capture, and nothing is read on
the host under it. A gloo group cannot be captured, so
``use_device_loop`` with a gloo mesh on the card raises ``ValueError``;
on the CPU the step runs eagerly with any backend.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from skeres_tpu_torch.core.graph import CapturedStep, cond
from skeres_tpu_torch.core.linear_solvers import solve_dense_qr_seminormal
from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
from skeres_tpu_torch.core.summary import IterationSummary
from skeres_tpu_torch.core.types import (
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = ["DeviceLoopMinimizer"]

# termination codes inside the device program
_RUNNING = 0
_CONV_GRADIENT = 1
_CONV_FUNCTION = 2
_CONV_PARAMETER = 3
_CONV_RADIUS = 4
_FAIL_INVALID = 5

_MESSAGES = {
    _RUNNING: (TerminationType.NO_CONVERGENCE, "Maximum number of iterations reached."),
    _CONV_GRADIENT: (TerminationType.CONVERGENCE, "Gradient tolerance reached."),
    _CONV_FUNCTION: (TerminationType.CONVERGENCE, "Function tolerance reached."),
    _CONV_PARAMETER: (TerminationType.CONVERGENCE, "Parameter tolerance reached."),
    _CONV_RADIUS: (TerminationType.CONVERGENCE, "Minimum trust region radius reached."),
    _FAIL_INVALID: (
        TerminationType.FAILURE,
        "Number of consecutive invalid steps exceeded the limit.",
    ),
}

# rows of the (7, K) history: cost, radius, step norm, max|g|, relative
# decrease, accepted, linear solver iterations
_HIST_ROWS = 7


@dataclasses.dataclass
class _Carry:
    """The loop's state: device tensors the captured step reads and
    writes in place. ``data`` is the linear solver's data (the Schur
    solvers' prepared dict, or the others' tuples)."""

    state: tuple
    cost: torch.Tensor
    g: torch.Tensor
    diag: torch.Tensor
    data: object
    scale: torch.Tensor
    radius: torch.Tensor
    decrease: torch.Tensor
    jitter: torch.Tensor
    # int64 scalars: it, term, n_succ, n_unsucc, n_invalid, limit
    it: torch.Tensor
    term: torch.Tensor
    n_succ: torch.Tensor
    n_unsucc: torch.Tensor
    n_invalid: torch.Tensor
    limit: torch.Tensor
    hist: torch.Tensor  # (7, K) in the working dtype


def _copy_leaves(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into ``dst`` (same structure), in
    place. A leaf that is a view into an earlier one (the E columns of a
    Jacobian, the A rows of the grid) is written through that one."""
    seen = set()
    for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src)):
        if not isinstance(d, torch.Tensor):
            continue
        ptr = d.untyped_storage().data_ptr()
        if ptr in seen:
            continue
        seen.add(ptr)
        d.copy_(s)


class DeviceLoopMinimizer(TrustRegionMinimizer):
    """TrustRegionMinimizer whose minimize() runs chunks of LM steps on
    the device: on the card, K replays of one captured step."""

    def __init__(self, *args, chunk_iterations: int = 25, **kwargs):
        super().__init__(*args, **kwargs)
        if self.options.trust_region_strategy_type != TrustRegionStrategyType.LEVENBERG_MARQUARDT:
            raise NotImplementedError("device loop supports LEVENBERG_MARQUARDT only")
        if self.ev.mesh is not None and self.ev.device.type == "cuda":
            backend = dist.get_backend(self.ev.mesh.get_group(0))
            if backend != "nccl":
                raise ValueError(
                    f"use_device_loop on a CUDA device with a {backend} mesh: a CUDA graph "
                    "captures NCCL collectives only; use the host loop, or one rank a card "
                    "under NCCL")
        # torch.linalg.qr cannot be captured inside a conditional node
        self._dense_qr = solve_dense_qr_seminormal
        self.chunk_iterations = int(chunk_iterations)
        o, dtype = self.options, self.ev.dtype
        min_radius = o.min_trust_region_radius
        if o.run_full_iteration_budget:
            # with termination off the radius keeps shrinking after
            # convergence; floor it above the dtype's underflow so that
            # mu = 1/radius stays finite
            min_radius = max(min_radius, float(torch.finfo(dtype).tiny))
        self._min_radius = min_radius
        self._carry: Optional[_Carry] = None
        self._step = CapturedStep(self._step_fn, self.ev.device)
        # warm-up, capture and upload of the step's CUDA graph (0 on the CPU)
        self.capture_seconds = 0.0

    # -- the carry -----------------------------------------------------------------

    def _new_carry(self, state, lin) -> _Carry:
        """A carry on ``state`` and its linearization ``lin`` (what
        ``linearize`` returns), which it keeps as its buffers."""
        cost, g, diag, data, scale, _, _ = lin
        dev, dtype = self.ev.device, self.ev.dtype
        scalar = lambda v: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
        count = lambda: torch.zeros((), dtype=torch.int64, device=dev)  # noqa: E731
        return _Carry(
            state=tuple(x.clone() for x in state), cost=cost, g=g, diag=diag, data=data,
            scale=scale, radius=scalar(self.options.initial_trust_region_radius),
            decrease=scalar(2.0), jitter=scalar(0.0),
            it=count(), term=count(), n_succ=count(), n_unsucc=count(), n_invalid=count(),
            limit=count(),
            hist=torch.empty((_HIST_ROWS, self.chunk_iterations), dtype=dtype, device=dev),
        )

    def compile_programs(self, state) -> None:
        """The first linearization and the capture of the step (the
        counterpart of the JAX package's AOT compile; ``solve()`` runs it
        inside the preprocessor's clock). Nothing to do on the CPU."""
        if self.ev.device.type != "cuda":
            return
        # the communicator's first collective sets it up: never under capture
        self.ev.all_reduce(torch.zeros(1, dtype=self.ev.dtype, device=self.ev.device))
        self._carry = self._new_carry(state, self.linearize(state))
        self._step.capture()
        # a graph's first replay uploads it to the device; make it here, as
        # a replay that runs no step (limit 0)
        t0 = time.time()
        self._carry.limit.zero_()
        self._step()
        torch.cuda.synchronize(self.ev.device)
        self.capture_seconds = self._step.capture_seconds + time.time() - t0

    # -- the captured step ---------------------------------------------------------

    def _step_fn(self) -> None:
        c = self._carry
        cond((c.term == _RUNNING) & (c.it < c.limit), self._body)

    def _body(self) -> None:
        """One LM step on the carry (``skeres_tpu/core/device_loop.py:122-285``)."""
        c, o = self._carry, self.options
        cand, mcc, step_norm, lin_iters, jitter, _ = self.solve_step(
            c.state, c.data, c.g, c.diag, c.scale, c.radius, c.jitter, line_search=False
        )
        new_cost, x_norm = self.try_step(cand)
        valid = (torch.isfinite(new_cost) & torch.isfinite(mcc) & torch.isfinite(step_norm)
                 & (mcc > 0.0))
        cost = c.cost.clone()  # the relinearization below overwrites c.cost
        rd = torch.where(valid, (cost - new_cost) / torch.where(mcc > 0.0, mcc, 1.0), 0.0)
        accepted = valid & (rd > o.min_relative_decrease)

        # radius update (reference formulas)
        grow = c.radius / torch.clamp(1.0 - (2.0 * rd - 1.0) ** 3, min=1.0 / 3.0)
        radius_acc = torch.clamp(grow, max=o.max_trust_region_radius)
        radius_rej = torch.clamp(c.radius / c.decrease, min=self._min_radius)
        new_radius = torch.where(accepted, radius_acc, radius_rej)
        new_decrease = torch.where(accepted, 2.0, c.decrease * 2.0)
        n_invalid = torch.where(valid, 0, c.n_invalid + 1)

        cond(accepted, lambda: self._relinearize(cand))

        # convergence tests on the post-step carry
        g_max = self.gradient_max_norm(c.state, c.g)
        term = c.term
        if not o.run_full_iteration_budget:  # benchmark mode: no termination
            running = lambda t: t == _RUNNING  # noqa: E731
            term = torch.where(running(term) & accepted & (g_max <= o.gradient_tolerance),
                               _CONV_GRADIENT, term)
            cost_change = torch.abs(cost - new_cost)
            term = torch.where(
                running(term) & accepted & (cost_change <= o.function_tolerance * torch.abs(cost)),
                _CONV_FUNCTION, term)
            if o.parameter_tolerance > 0:
                # ptol == 0 disables the test: an exactly-zero float32 step
                # (radius underflow after convergence) would pass it
                ptol = o.parameter_tolerance
                term = torch.where(running(term) & (step_norm <= ptol * (x_norm + ptol)),
                                   _CONV_PARAMETER, term)
            term = torch.where(running(term) & (new_radius <= self._min_radius), _CONV_RADIUS, term)
            term = torch.where(
                running(term) & (n_invalid >= o.max_num_consecutive_invalid_steps),
                _FAIL_INVALID, term)

        row = torch.stack([
            torch.where(accepted, new_cost, cost), c.radius, step_norm, g_max, rd,
            accepted.to(cost.dtype), lin_iters.to(cost.dtype),
        ])
        c.hist.index_copy_(1, c.it.reshape(1), row[:, None])
        c.radius.copy_(new_radius)
        c.decrease.copy_(new_decrease)
        c.jitter.copy_(jitter)
        c.term.copy_(term)
        c.n_succ.add_(accepted)
        c.n_unsucc.add_(~accepted)
        c.n_invalid.copy_(n_invalid)
        c.it.add_(1)

    def _relinearize(self, cand) -> None:
        """Accept ``cand``: linearize there and write the result into the
        carry (``skeres_tpu/core/device_loop.py:198-207``)."""
        c, o = self._carry, self.options
        pinned = o.jacobi_scaling and not o.refresh_jacobi_scaling
        self._load(cand, self.linearize(cand, c.scale if pinned else None))

    def _load(self, state, lin) -> None:
        """Write ``state`` and its linearization ``lin`` into the carry."""
        c = self._carry
        cost, g, diag, data, scale, _, _ = lin
        for dst, src in zip(c.state + (c.cost, c.g, c.diag, c.scale),
                            state + (cost, g, diag, scale)):
            dst.copy_(src)
        _copy_leaves(c.data, data)

    # -- the host side (skeres_tpu/core/device_loop.py:427-564) ----------------------

    def minimize(self, state):
        if self.ev.device.type == "cuda" and self._step.graph is None:
            raise RuntimeError("DeviceLoopMinimizer.minimize: compile_programs() has not "
                               "captured the step's CUDA graph")
        try:
            return self._minimize(state)
        finally:
            self._step.release()

    def _minimize(self, state):
        o, s = self.options, self.summary
        start = time.time()
        dtype = self.ev.dtype

        lin = self.linearize(state)
        cost_f, g_max = torch.stack([lin[0], lin[5]]).tolist()
        s.num_jacobian_evaluations += 1
        if not math.isfinite(cost_f):
            s.termination_type = TerminationType.FAILURE
            s.message = "Initial cost evaluation produced non-finite values."
            return state
        s.initial_cost = cost_f + s.fixed_cost
        s.iterations.append(IterationSummary(
            iteration=0,
            cost=cost_f + s.fixed_cost,
            gradient_max_norm=g_max,
            trust_region_radius=float(o.initial_trust_region_radius),
            step_is_valid=True,
            step_is_successful=True,
        ))
        if not o.run_full_iteration_budget and g_max <= o.gradient_tolerance:
            s.termination_type = TerminationType.CONVERGENCE
            s.message = "Gradient tolerance reached."
            return state

        if self._carry is None:
            self._carry = self._new_carry(state, lin)
        else:  # the buffers the captured step reads
            self._load(state, lin)
        del lin
        c = self._carry
        c.radius.fill_(self.initial_radius_override
                       if self.initial_radius_override is not None
                       else o.initial_trust_region_radius)
        c.decrease.fill_(2.0)
        c.jitter.zero_()

        K = self.chunk_iterations
        it_total = 0
        term_code = _RUNNING
        while it_total < o.max_num_iterations:
            if time.time() - start > o.max_solver_time_in_seconds:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum solver time reached."
                return c.state
            limit = min(K, o.max_num_iterations - it_total)
            for t in (c.it, c.term, c.n_succ, c.n_unsucc, c.n_invalid):
                t.zero_()
            c.limit.fill_(limit)
            c.hist.fill_(float("nan"))
            c.hist[5:].zero_()
            for _ in range(limit):
                self._step()
            # ONE device-to-host fetch for the chunk's statistics
            packed = torch.cat([
                torch.stack([c.it, c.term, c.n_succ, c.n_unsucc]).to(dtype),
                c.cost.reshape(1),
                c.hist.reshape(-1),
            ]).tolist()
            it_chunk, term_code, n_succ, n_unsucc = (int(v) for v in packed[:4])
            cost_f = packed[4]
            s.num_successful_steps += n_succ
            s.num_unsuccessful_steps += n_unsucc
            s.num_linear_solves += it_chunk
            s.num_jacobian_evaluations += n_succ
            s.num_residual_evaluations += it_chunk
            h = [packed[5 + r * K : 5 + (r + 1) * K] for r in range(_HIST_ROWS)]
            now = time.time() - start
            for k in range(it_chunk):
                it_total += 1
                s.iterations.append(IterationSummary(
                    iteration=it_total,
                    cost=h[0][k] + s.fixed_cost,
                    gradient_max_norm=h[3][k],
                    step_norm=h[2][k],
                    relative_decrease=h[4][k],
                    trust_region_radius=h[1][k],
                    linear_solver_iterations=int(h[6][k]),
                    step_is_valid=True,
                    step_is_successful=bool(h[5][k]),
                    cumulative_time_in_seconds=now,
                ))
            if term_code != _RUNNING:
                break

        s.termination_type, s.message = _MESSAGES[term_code]
        # monotonic: the carried state is the best iterate and its cost
        # (from the packed fetch) is final_cost (reference semantics)
        s.final_cost = cost_f + s.fixed_cost
        return c.state
