"""linear_solve_ms: milliseconds a damped solve (``Summary``'s
``linear_solver_time_in_seconds`` over ``num_linear_solves``; host loop)."""


def read(rec):
    seconds = sum(s["linear_solver_s"] for s in rec["solves"])
    solves = sum(s["linear_solves"] for s in rec["solves"])
    return 1e3 * seconds / solves if seconds > 0 and solves else None
