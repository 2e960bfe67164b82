"""solve_s: the time to a converged solve, the mean of the window's solve
clocks (a fresh Problem from the host arrays, ``solve``, the final
parameters on the host)."""


def read(rec):
    clocks = [s["clock_s"] for s in rec["solves"]]
    return sum(clocks) / len(clocks)
