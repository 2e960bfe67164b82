"""Device-side branching for CUDA graphs: ``cond``, ``while_loop``,
``CapturedStep`` and ``stamp``.

The JAX package's device loop is one XLA program: ``lax.while_loop`` over
the LM step, with ``lax.cond`` for the relinearization after an accepted
step, and the jitter ladder and PCG fallback of the damped solve
(``skeres_tpu/core/device_loop.py``, ``core/schur.py``). The port captures
one LM step as a CUDA graph (:class:`CapturedStep`) whose branches are
conditional IF nodes (:func:`cond`) and whose inner loops (the PCG of the
iterative solvers, the power series of a preconditioner) are conditional
WHILE nodes (:func:`while_loop`); ``core/device_loop.py`` replays it.

``cond(pred, true_fn, false_fn)`` runs ``true_fn`` where the device bool
``pred`` holds, else ``false_fn`` (if given):

- eagerly (the CPU, or the card outside a capture): a Python ``if`` on
  ``bool(pred)``, one host read;
- while :class:`CapturedStep` captures: each function is captured into
  the body of an IF node (``csrc/graph_cond.cu``), on ``pred`` and on
  ``~pred``, so every replay decides on the device and the host reads
  nothing.

``while_loop(cond_fn, body_fn)`` runs ``body_fn()`` for as long as the
0-d device bool that ``cond_fn()`` returns holds, the counterpart of
``lax.while_loop`` with its carry in tensors that both functions read and
``body_fn`` updates in place:

- eagerly: a Python ``while`` on ``bool(cond_fn())``, one host read a turn;
- under capture: one WHILE node. ``cond_fn()`` is captured before the node
  and sets its handle; the body holds ``body_fn()``, then ``cond_fn()``
  again and the one-thread kernel that sets the handle from it, so every
  replay runs as many turns as its data ask for and the host reads nothing.

The functions return nothing: they write their results in place into
tensors made before the branch, since a body that does not run leaves no
outputs. Nor may they change Python state that later code reads: under
capture each runs once, whatever ``pred`` holds.

``stamp(dst, index)`` writes the device's clock into a tensor in stream
order, so that a captured step times its own phases on every replay
(``core/device_loop.py``).

Each nesting depth of conditional bodies is captured on a stream of its
own, and what a body allocates comes from a private memory pool of that
depth, held for the life of the graph, so that no block the graph uses is
handed to other work. There is no path without the conditional nodes: a
capture that fails raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from typing import Callable, Optional

import torch

from skeres_tpu_torch.ops.build import load_library

__all__ = ["CapturedStep", "build_library", "cond", "stamp", "while_loop"]

# nesting depth of conditional bodies: the device loop's step, two rungs,
# the PCG fallback and its WHILE body (DENSE_SCHUR); the step, the PCG's
# WHILE body and the power series' inside the preconditioner (ITERATIVE_SCHUR)
_MAX_DEPTH = 5

_capturing: Optional["CapturedStep"] = None  # the capture under way
_warm_all = False  # warm-up: run both sides of every branch


@functools.lru_cache(maxsize=None)
def build_library():
    """Compile ``csrc/graph_cond.cu`` (``ops/build.py``) and bind it.
    Returns ``(library, compiler_log)``."""
    lib, log = load_library("graph_cond")
    lib.skeres_if_node_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
    lib.skeres_while_node_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_void_p),
                                            ctypes.POINTER(ctypes.c_ulonglong)]
    lib.skeres_set_conditional.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.skeres_capture_to_graph.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.skeres_capture_end.argtypes = [ctypes.c_void_p]
    lib.skeres_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    for fn in (lib.skeres_if_node_begin, lib.skeres_while_node_begin, lib.skeres_set_conditional,
               lib.skeres_capture_to_graph, lib.skeres_capture_end, lib.skeres_stamp):
        fn.restype = ctypes.c_int
    return lib, log


def stamp(dst: torch.Tensor, index: Optional[torch.Tensor] = None) -> None:
    """Write the clock's nanoseconds into ``dst[index]`` (``dst`` a 1-D
    int64 tensor, ``index`` a 0-d int64 device tensor; ``dst[0]`` without
    one), in stream order and with no host read: on the card a one-thread
    kernel reading ``%globaltimer`` (``csrc/graph_cond.cu``), which a
    capture records like any kernel; on the CPU ``time.perf_counter_ns()``.
    Only differences of one device's stamps mean anything."""
    if dst.is_cuda:
        lib, _ = build_library()
        _check(lib.skeres_stamp(torch.cuda.current_stream(dst.device).cuda_stream,
                                dst.data_ptr(), None if index is None else index.data_ptr(),
                                dst.numel()), "a stamp")
    elif index is None:
        dst[0] = time.perf_counter_ns()
    else:
        dst.index_fill_(0, index.reshape(1), time.perf_counter_ns())


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA graph capture: {what} failed with CUDA error {err}")


def cond(pred: torch.Tensor, true_fn: Callable[[], None],
         false_fn: Optional[Callable[[], None]] = None) -> Optional[bool]:
    """Run ``true_fn()`` where the 0-d device bool ``pred`` holds, else
    ``false_fn()``: eagerly by one host read, or as IF nodes of the CUDA
    graph being captured (see the module docstring). Returns ``pred`` as
    read eagerly; None under capture and True in the warm-up, where the
    host does not know it."""
    if _warm_all:
        true_fn()
        if false_fn is not None:
            false_fn()
        return True
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        if _capturing is None:
            raise RuntimeError("cond() under a CUDA graph capture that CapturedStep did not start")
        pred = pred.reshape(()).to(torch.bool)
        not_pred = None if false_fn is None else ~pred
        _capturing._cond_node(pred, true_fn)
        if false_fn is not None:
            _capturing._cond_node(not_pred, false_fn)
        return None
    if bool(pred):
        true_fn()
        return True
    if false_fn is not None:
        false_fn()
    return False


def while_loop(cond_fn: Callable[[], torch.Tensor], body_fn: Callable[[], None]) -> None:
    """Run ``body_fn()`` while the 0-d device bool ``cond_fn()`` holds:
    eagerly a Python loop with one host read a turn, or one WHILE node of
    the CUDA graph being captured (see the module docstring). In the
    warm-up both functions run once."""
    if _warm_all:
        cond_fn()
        body_fn()
        return
    pred = cond_fn()
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        if _capturing is None:
            raise RuntimeError(
                "while_loop() under a CUDA graph capture that CapturedStep did not start")
        _capturing._cond_node(pred.reshape(()).to(torch.bool), body_fn, loop_cond=cond_fn)
        return
    while bool(pred):
        body_fn()
        pred = cond_fn()


@contextlib.contextmanager
def _warming():
    global _warm_all
    _warm_all = True
    try:
        yield
    finally:
        _warm_all = False


class CapturedStep:
    """``fn`` (no arguments; it reads and writes tensors that outlive it)
    captured once as a CUDA graph, its :func:`cond` branches as IF nodes,
    then replayed by each call. On the CPU a call runs ``fn``.

    :meth:`capture` first runs ``fn`` eagerly on a side stream with both
    sides of every branch taken (so everything a branch initializes on
    first use is ready; what it writes is the caller's to reset), then
    captures it. ``capture_seconds`` is the time both took.
    ``CapturedStep.captured`` counts the graphs this process has begun to
    capture."""

    captured = 0

    def __init__(self, fn: Callable[[], None], device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.capture_seconds = 0.0
        self._streams = []
        self._pools = []
        self._pool_uses = []
        self._depth = 0

    def capture(self) -> None:
        if self.device.type != "cuda":
            return
        global _capturing
        t0 = time.time()
        build_library()
        dev = self.device
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        # torch hands out streams round-robin from a pool of 32: taken
        # together, the warm-up, capture and IF-body streams are distinct,
        # so no body is captured on a stream that is capturing already
        side, capture_stream, *self._streams = (torch.cuda.Stream(dev)
                                                for _ in range(_MAX_DEPTH + 2))
        self._pools = [torch.cuda.graph_pool_handle() for _ in range(_MAX_DEPTH)]
        self._pool_uses = [0] * _MAX_DEPTH
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), _warming():
            self.fn()
        main.wait_stream(side)
        a = torch.ones(8, 8, device=dev)
        for s in self._streams:  # cuBLAS's per-stream workspace, outside the graph's pools
            s.wait_stream(main)
            with torch.cuda.stream(s):
                a @ a
                a @ a[0]
            main.wait_stream(s)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        CapturedStep.captured += 1
        _capturing = self
        try:
            with torch.cuda.graph(graph, stream=capture_stream):
                self.fn()
        finally:
            _capturing = None
        self.graph = graph
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.time() - t0

    def _cond_node(self, pred: torch.Tensor, fn: Callable[[], None],
                   loop_cond: Optional[Callable[[], torch.Tensor]] = None) -> None:
        """Capture ``fn`` as the body of a conditional node on ``pred``,
        after the work captured so far on the current stream: an IF node,
        or with ``loop_cond`` a WHILE node whose body ends by setting the
        node's handle from ``loop_cond()``."""
        lib, _ = build_library()
        d = self._depth
        if d >= _MAX_DEPTH:
            raise RuntimeError(
                f"cond() and while_loop() nested deeper than {_MAX_DEPTH} under capture")
        parent = torch.cuda.current_stream(self.device)
        body = ctypes.c_void_p()
        handle = ctypes.c_ulonglong()
        if loop_cond is None:
            _check(lib.skeres_if_node_begin(parent.cuda_stream, pred.data_ptr(),
                                            ctypes.byref(body)), "adding an IF node")
        else:
            _check(lib.skeres_while_node_begin(parent.cuda_stream, pred.data_ptr(),
                                               ctypes.byref(body), ctypes.byref(handle)),
                   "adding a WHILE node")
        child = self._streams[d]
        _check(lib.skeres_capture_to_graph(child.cuda_stream, body),
               "capturing a conditional body")
        self._depth += 1
        try:
            with torch.cuda.stream(child):
                torch._C._cuda_beginAllocateCurrentStreamToPool(self.device.index, self._pools[d])
                self._pool_uses[d] += 1
                try:
                    fn()
                    if loop_cond is not None:
                        again = loop_cond().reshape(()).to(torch.bool)
                        _check(lib.skeres_set_conditional(child.cuda_stream, handle.value,
                                                          again.data_ptr()),
                               "setting a WHILE node's handle")
                finally:
                    torch._C._cuda_endAllocateToPool(self.device.index, self._pools[d])
        finally:
            self._depth -= 1
            _check(lib.skeres_capture_end(child.cuda_stream), "ending a conditional body")

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()

    def release(self) -> None:
        """Drop the graph and give its IF bodies' pools back."""
        if self.graph is None:
            return
        torch.cuda.synchronize(self.device)
        self.graph.reset()
        self.graph = None
        for pool, uses in zip(self._pools, self._pool_uses):
            for _ in range(uses):
                torch._C._cuda_releasePool(self.device.index, pool)
        self._pool_uses = [0] * _MAX_DEPTH
