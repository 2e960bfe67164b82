"""cluster_factor_ms: the mean device time of one build and factor of the
visibility-based cluster preconditioner, on its entry
``cluster_preconditioner`` as ``core/schur.py``'s ITERATIVE_SCHUR calls it
once a damped solve (K3 over the cluster plan, the cluster and band
blocks, the chains' block LDL^T): the device time of what each call
launched inside the benchmark's range around it, in milliseconds. A
program without that entry, or a run that never calls it, has nothing to
read."""

ENTRY = ("skeres_tpu_torch.core.schur", "cluster_preconditioner")


def counts(arguments):
    return {}


def read(rec):
    calls = [c for c in rec["calls"].get(ENTRY[1], []) if c.get("device_s", 0.0) > 0.0]
    if rec["trace"] is None or not calls:
        return None
    return 1e3 * sum(c["device_s"] for c in calls) / len(calls)
