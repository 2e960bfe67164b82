"""steps_per_solve: LM steps (successful and unsuccessful) a solve, mean."""


def read(rec):
    return sum(s["steps"] for s in rec["solves"]) / len(rec["solves"])
