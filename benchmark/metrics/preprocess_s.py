"""preprocess_s: a solve's preprocessing, mean per solve: the Problem's
construction (the benchmark's clock) plus ``Summary``'s preprocessor
seconds less the device loop's capture (the evaluator, the Schur plans,
the camera-padded layout's plan)."""


def read(rec):
    per = [s["build_s"] + s["preprocessor_s"] - s["capture_s"] for s in rec["solves"]]
    return sum(per) / len(per)
