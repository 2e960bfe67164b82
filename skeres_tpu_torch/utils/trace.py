"""The program's spans: named ranges on ``torch.profiler``'s clock.

``span(name, **args)`` opens a range named ``skeres.<layer>.<part>`` where
the work happens (the plans of ``solve()``, the host loop's step, the
damped solve's parts, the device loop's chunks). It costs nothing unless a
profiler records: otherwise it returns one shared
``contextlib.nullcontext()``, with no allocation, no device sync and no
clock read. While a ``torch.profiler`` session records, it is a
record-function range of the profiler's own clock,
to which Kineto aligns the device's trace, so every kernel and every idle
gap of the card can be named by the innermost span open on the host at
that moment. ``args`` (ints) ride on the range as keyword inputs, which
the profiler keeps where it records shapes: ``skeres.solve``, the root,
carries the process's solve number, so that each span can be tied to its
solve. A caller's own session around ``solve`` sees every span
(``tools_torch/trace_spans.py`` opens one and sums each span's host and
device time); ``SolverOptions.trace_dir``'s session covers ``minimize()``
alone, so its trace holds the steps' and the chunks' spans only.

The ranges are of the function scope, as an operator's are, and not the
user scope of ``torch.profiler.record_function``: the profiler mirrors a
user-scope range onto the device's timeline, spanning the kernels
launched inside it, and a reduction of the trace that counts every device
event as work would count those mirrors as busy card. The device time a
span launched is found by correlation instead (each kernel's launch lies
inside it on the host). The function-scope range is
``torch._C._profiler._RecordFunctionFast``, a private API of torch:
``tests/test_torch_trace.py`` fails when a torch release changes it.

The spans:

- ``skeres.solve``; ``skeres.plan.compile`` (``Problem.compile``),
  ``skeres.plan.evaluator``, ``skeres.plan.schur`` (the Schur solver: its
  dense-W plan ``skeres.plan.w``, its pair plan ``skeres.plan.pairs`` with
  ``.metadata`` and ``.sums``, the camera-padded layout
  ``skeres.plan.layout``, the cluster plan ``skeres.plan.cluster``, which
  under visibility clustering holds ``skeres.plan.cluster.visibility``,
  ``.views`` and ``.forest``),
  ``skeres.device_loop.capture``, ``skeres.minimize``,
  ``skeres.postprocess``;
- a step: ``skeres.step.linearize`` (in it ``skeres.schur.place`` and
  ``skeres.schur.prepare``, which holds ``skeres.schur.grid``),
  ``skeres.step.damped_solve`` (``skeres.schur.s_build``,
  ``skeres.schur.factor``, ``skeres.schur.pcg``,
  ``skeres.schur.back_substitute``; the camera blocks of S
  ``skeres.schur.blocks`` inside the first or the third; inside
  ``skeres.schur.pcg`` on visibility clusters, the preconditioner's build
  and factor ``skeres.schur.cluster_factor`` and each application
  ``skeres.schur.cluster_apply``),
  ``skeres.step.candidate_cost``;
- ``skeres.device_loop.chunk``: a chunk's replays and its one fetch.

Inside the device loop's captured step a span is opened once, while the
step is captured; what a replay runs is timed by the device stamps of
``core/device_loop.py`` instead.
"""

from __future__ import annotations

import contextlib
import itertools

import torch
import torch.autograd.profiler as _profiler

__all__ = ["next_solve_number", "span"]

_NULL = contextlib.nullcontext()
_SOLVES = itertools.count(1)


def span(name: str, **args: int):
    """A context manager: the profiler range ``name`` with ``args`` while a
    profiler records, else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name, [], args)


def next_solve_number() -> int:
    """The process's next solve number (1, 2, ...), for ``skeres.solve``."""
    return next(_SOLVES)
