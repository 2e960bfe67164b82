"""capture_s: the device loop's CUDA-graph capture, mean per solve
(``Summary``'s ``device_loop_capture_time_in_seconds``); a cell on the
host loop captures nothing and reads nothing."""


def read(rec):
    per = [s["capture_s"] for s in rec["solves"]]
    return sum(per) / len(per) if any(c > 0 for c in per) else None
