"""replay_idle_pct: in the device loop, the share of the minimizer's time
(the benchmark's ``layer.minimize`` spans of the traced solves: the chunks'
graph replays, their packed fetch, the first linearization) in which no
kernel, copy or set ran on the card (``torch.profiler``)."""


def read(rec):
    t = rec["trace"]
    length, busy = (t or {}).get("span_busy", {}).get("layer.minimize", (0.0, 0.0))
    return 100.0 * (1.0 - busy / length) if length > 0 else None
