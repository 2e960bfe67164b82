"""Reduce a ``torch.profiler`` session of the traced window, in memory.

Nothing is written to disk. The reduction keeps:

- the window: from the start of the first ``bench.solve`` range to the end
  of the last;
- ``busy_s``: the union of the device's activity (kernels, copies, sets)
  inside the window;
- the device operations that took most time, by name;
- the idle gaps between device activity, each named by the innermost host
  operation that was running at its middle on the thread that ran the
  solves, summed by that name;
- per ``layer.<name>`` span (the benchmark's spans around the calls into
  the program's layers), its summed length and the busy time inside it;
- per ``port.<entry>#<k>`` range (the benchmark's wrapper around a kernel
  entry of the program), the device time of everything launched while it
  was open on that thread. A CUDA-graph replay launches its kernels from
  no range, and names them right only in a process's first graph (PERF.md),
  so what a replay runs is attributed to no entry.
"""

from __future__ import annotations

import bisect
import collections

__all__ = ["reduce_profile"]

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(ev, annotations=frozenset()) -> str:
    """The event's activity kind, or where this torch has no
    ``activity_type`` (2.11), the kind its device and name imply."""
    if hasattr(ev, "activity_type"):
        kind = ev.activity_type()
        return kind if isinstance(kind, str) else str(kind)
    name = ev.name()
    if ev.device_type().name == "CUDA":
        if name in annotations:
            return "gpu_user_annotation"
        return "gpu_memcpy" if "Memcpy" in name else "gpu_memset" if "Memset" in name else "kernel"
    if name in annotations:
        return "user_annotation"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


def _start(ev) -> int:
    return ev.start_ns() if hasattr(ev, "start_ns") else int(ev.start_us() * 1000)


def _length(ev) -> int:
    return ev.duration_ns() if hasattr(ev, "duration_ns") else int(ev.duration_us() * 1000)


def _end(ev) -> int:
    return _start(ev) + _length(ev)


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def reduce_profile(prof, top: int = 10) -> dict | None:
    """The reduction of ``prof`` (a finished ``torch.profiler.profile``), or
    None when it holds no device activity (a run on the CPU)."""
    events = prof.profiler.kineto_results.events()
    annotations = frozenset(ev.name() for ev in events if ev.device_type().name == "CPU"
                            and ev.name().startswith(("bench.", "port.", "layer.")))
    device, host = [], []  # (start, end, name), and (start, end, name, kind, thread, corr)
    launch_at, cpu_ops = {}, {}  # correlation -> (host start, thread)
    for ev in events:
        kind, start = _kind(ev, annotations), _start(ev)
        span = (start, start + _length(ev), ev.name())
        if ev.device_type().name == "CUDA":
            if kind in _DEVICE_KINDS:
                device.append(span + (ev.correlation_id(), ev.linked_correlation_id()))
            continue
        thread = ev.start_thread_id()
        host.append(span + (kind, thread))
        if kind in ("cuda_runtime", "cuda_driver"):
            launch_at[ev.correlation_id()] = (start, thread)
        elif kind in ("cpu_op", "user_annotation"):
            cpu_ops[ev.correlation_id()] = (start, thread)
    solves = [h for h in host if h[2] == "bench.solve"]
    if not device or not solves:
        return None
    main_thread = solves[0][4]
    w0 = min(h[0] for h in solves)
    w1 = max(h[1] for h in solves)

    # -- busy time and the device operations ------------------------------------
    busy = _merge([(max(d[0], w0), min(d[1], w1)) for d in device if min(d[1], w1) > max(d[0], w0)])
    busy_ns = sum(hi - lo for lo, hi in busy)
    busy_starts = [lo for lo, _ in busy]
    by_name = collections.defaultdict(float)
    for d in device:
        by_name[d[2]] += (d[1] - d[0]) * 1e-9

    # -- the busy time inside each layer.<name> span ---------------------------------
    span_busy = {}
    for name in {h[2] for h in host if h[2].startswith("layer.")}:
        spans = _merge([h[:2] for h in host if h[2] == name and h[4] == main_thread])
        inside_ns = 0
        for lo, hi in spans:
            k = bisect.bisect_right(busy_starts, lo) - 1
            for b_lo, b_hi in busy[max(k, 0):]:
                if b_lo >= hi:
                    break
                inside_ns += max(0, min(hi, b_hi) - max(lo, b_lo))
        span_busy[name] = [sum(hi - lo for lo, hi in spans) * 1e-9, inside_ns * 1e-9]

    # -- the device time launched inside each port.<entry>#<k> range ---------------
    ranges = sorted(h[:3] for h in host if h[2].startswith("port.") and h[4] == main_thread)
    starts = [r[0] for r in ranges]
    range_s = collections.defaultdict(float)
    for d in device:
        hit = launch_at.get(d[3])
        if hit is None and d[4]:
            hit = cpu_ops.get(d[4])
        if hit is None or hit[1] != main_thread:
            continue
        k = bisect.bisect_right(starts, hit[0]) - 1
        if k >= 0 and hit[0] <= ranges[k][1]:
            range_s[ranges[k][2]] += (d[1] - d[0]) * 1e-9

    # -- idle gaps, named by what the host was doing -------------------------------
    gaps = []
    edge = w0
    for lo, hi in busy:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    if w1 > edge:
        gaps.append((edge, w1))
    ops = sorted((h[0], -h[1], h[2]) for h in host if h[4] == main_thread)
    idle_by = collections.defaultdict(float)
    stack, i = [], 0
    for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (lo + hi) / 2
        while i < len(ops) and ops[i][0] <= mid:
            while stack and -stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and -stack[-1][1] <= mid:
            stack.pop()
        idle_by[stack[-1][2] if stack else "(no host operation)"] += (hi - lo) * 1e-9

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return dict(
        window_s=(w1 - w0) * 1e-9,
        busy_s=busy_ns * 1e-9,
        device_ops=top_of(by_name),
        idle_gaps=top_of(idle_by),
        range_device_s=dict(range_s),
        span_busy=span_busy,
    )
