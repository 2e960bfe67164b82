"""lm_steps_per_s: every LM step of the window's solves, successful or
not, over the sum of their minimizers' seconds (``Summary``'s
``minimizer_time_in_seconds``, read after a device sync)."""


def read(rec):
    seconds = sum(s["minimizer_s"] for s in rec["solves"])
    return sum(s["steps"] for s in rec["solves"]) / seconds if seconds > 0 else None
