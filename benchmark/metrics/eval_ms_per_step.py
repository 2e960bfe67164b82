"""eval_ms_per_step: the evaluator's milliseconds an LM step, Jacobian and
residual evaluations together (``Summary``'s host-loop timers, read after
a device sync); the device loop stamps no such time."""


def read(rec):
    seconds = sum(s["jacobian_eval_s"] + s["residual_eval_s"] for s in rec["solves"])
    steps = sum(s["steps"] for s in rec["solves"])
    return 1e3 * seconds / steps if seconds > 0 and steps else None
