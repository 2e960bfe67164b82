"""The trace reduction on a made-up profile: the window, the busy time,
the device time launched inside a kernel entry's range, and the idle gaps
named by the host operation that was running."""

import types

import pytest

from benchmark.trace import reduce_profile


class Event:
    def __init__(self, name, device, start, length, thread=1, corr=0, linked=0):
        self._name, self._device = name, device
        self._start, self._length = start, length
        self._thread, self._corr, self._linked = thread, corr, linked

    def name(self):
        return self._name

    def device_type(self):
        return types.SimpleNamespace(name=self._device)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._length

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_reduce_profile():
    ms = 1_000_000
    events = [
        Event("bench.solve", "CPU", 0, 100 * ms),
        Event("layer.schur_plan", "CPU", 0, 40 * ms),  # the host plans: the card idles
        Event("layer.minimize", "CPU", 45 * ms, 45 * ms),  # 45-90 ms: busy 52-80
        Event("port.blocked_cholesky_factor#0", "CPU", 50 * ms, 10 * ms),
        Event("cudaLaunchKernel", "CPU", 51 * ms, ms // 10, corr=7),
        Event("cudaLaunchKernel", "CPU", 70 * ms, ms // 10, corr=8),
        Event("syrk_lower_f64_kernel", "CUDA", 52 * ms, 20 * ms, corr=7),
        Event("pair_kernel", "CUDA", 72 * ms, 8 * ms, corr=8),
        Event("gemm", "CUDA", 300 * ms, 5 * ms, corr=9),  # after the window
        Event("port.blocked_cholesky_factor#1", "CPU", 200 * ms, ms),  # launched nothing
    ]
    r = reduce_profile(_profile(events))
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.028)
    assert r["range_device_s"] == {"port.blocked_cholesky_factor#0": pytest.approx(0.020)}
    gaps = dict(r["idle_gaps"])
    assert gaps["layer.schur_plan"] == pytest.approx(0.052)  # 0-52 ms: its middle is in the plans
    assert gaps["bench.solve"] == pytest.approx(0.020)  # 80-100 ms: its middle past layer.minimize
    assert dict(r["device_ops"])["gemm"] == pytest.approx(0.005)
    assert r["span_busy"]["layer.minimize"] == [pytest.approx(0.045), pytest.approx(0.028)]


def test_no_device_no_reduction():
    assert reduce_profile(_profile([Event("bench.solve", "CPU", 0, 10)])) is None
