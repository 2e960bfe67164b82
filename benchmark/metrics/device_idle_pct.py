"""device_idle_pct: the share of the traced solves' wall time in which no
kernel, copy or set ran on the card (``torch.profiler``)."""


def read(rec):
    t = rec["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
