"""pcg_iters_per_linear_solve: the iterative linear solver's iterations
over the damped solves (``IterationSummary.linear_solver_iterations``
summed, over ``Summary``'s ``num_linear_solves``)."""


def read(rec):
    iterations = sum(sum(s["linear_iterations"]) for s in rec["solves"])
    solves = sum(s["linear_solves"] for s in rec["solves"])
    return iterations / solves if solves else None
