"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the metrics.

Everything that belongs to one configuration, one cell or one metric is a
file of its own, found by its name:

- ``workloads/<cell>.json``: the configuration, the solver options, the
  dtype, the warm-up cap and the limits of the compared numbers;
- ``configs/<config>.json``: the counts, the source, what was assumed and
  cut, and the scene generator's name;
- ``scenes/<generator>.py``: ``generate(config, seed, device)``,
  ``build_problem(scene)`` (through the program's public API) and
  ``make_reference(scene, device)`` (the plain reference of that kind);
- ``metrics/<metric>.py``: ``read(rec)``, the metric from the run's records,
  or None where it finds nothing to read; a kernel metric also names the
  program's entry it wraps (``ENTRY``) and counts a call (``counts``).
  A metric named ``<base>.<part>`` is read by ``metrics/<base>.py`` where it
  has no file of its own: the same quantity under a name of its own, for
  cells that need a bound of their own or report another end-to-end metric.

``BENCHMARK.json`` says which metrics a cell reports: each entry's
``workloads``, and for a per-layer entry without one, every cell that
reports the end-to-end metric it ``moves``.

A run: set-up (the kernels built or found in ``build/``, the scene drawn
from the seed on the device, one warm-up solve of the cell's own scene and
options capped at a few LM steps); then solves back to back, each of a
fresh Problem from the same start, until the first one that ends at or
after ``seconds``; then, with the program's state freed, the reference
solve and the comparison that decides ``correct``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import gc
import importlib.util
import inspect
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "skeres_tpu")
# the traced run profiles the window's solves up to the first that ends at
# or after TRACE_SECONDS, so that its trace stays small and its reduction
# short; the rest of the window runs untraced
TRACE_SECONDS = 10.0

__all__ = ["ROOT", "compare", "forbidden_modules", "lockstep", "load_cell", "load_module",
           "load_reader", "run_cell", "solver_options", "timed_solve"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_")
                                                  .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or where there is
    none, that of the part of the name before the first dot."""
    if (BENCH / "metrics" / f"{metric}.py").exists():
        return load_module("metrics", metric)
    return load_module("metrics", metric.split(".")[0])


def load_cell(name: str) -> dict:
    """The cell file, with its configuration under ``"config_data"``."""
    cell = _load_json(BENCH / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_data"] = _load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def solver_options(cell: dict, device, dtype: str, **overrides):
    """The program's SolverOptions from the cell file's ``options``."""
    from skeres_tpu_torch.core.options import SolverOptions

    defaults = SolverOptions()
    names = {f.name for f in dataclasses.fields(SolverOptions)}
    kw = {}
    for key, value in {**cell["options"], **overrides}.items():
        if key not in names:
            raise ValueError(f"cell {cell['name']}: {key} is no SolverOptions field")
        current = getattr(defaults, key)
        kw[key] = type(current)(value) if isinstance(current, enum.Enum) else value
    options = SolverOptions(device=device, dtype=getattr(torch, dtype), **kw)
    ok, msg = options.is_valid()
    if not ok:
        raise ValueError(f"cell {cell['name']}: {msg}")
    return options


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_solve(scene_mod, scene, options, span) -> dict:
    """One solve as a user makes it: a fresh Problem from the host arrays,
    ``solve``, the final parameters on the host. Its clock covers all three."""
    import skeres_tpu_torch as stt

    t0 = time.perf_counter()
    with span("bench.solve"):
        with span("bench.build_problem"):
            problem, handles = scene_mod.build_problem(scene)
        t1 = time.perf_counter()
        summary = stt.solve(options, problem)
        with span("bench.read_back"):
            params = {name: np.array(h.values, copy=True) for name, h in handles.items()}
    t2 = time.perf_counter()
    its = summary.iterations
    return dict(
        clock_s=t2 - t0,
        build_s=t1 - t0,
        preprocessor_s=summary.preprocessor_time_in_seconds,
        capture_s=summary.device_loop_capture_time_in_seconds,
        minimizer_s=summary.minimizer_time_in_seconds,
        jacobian_eval_s=summary.jacobian_evaluation_time_in_seconds,
        residual_eval_s=summary.residual_evaluation_time_in_seconds,
        linear_solver_s=summary.linear_solver_time_in_seconds,
        linear_solves=summary.num_linear_solves,
        linear_iterations=[it.linear_solver_iterations for it in its[1:]],
        steps=summary.num_successful_steps + summary.num_unsuccessful_steps,
        accepted_costs=[it.cost for it in its if it.step_is_successful],
        initial_cost=summary.initial_cost,
        final_cost=summary.final_cost,
        termination=summary.termination_type.value,
        usable=summary.is_solution_usable,
        schur_path=summary.schur_complement_path,
        layout=summary.camera_padded_layout,
        params=params,
    )


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


def compare(solves, ref_out: dict, reference, names, path_steps=None) -> dict:
    """The compared numbers ``names``, each the worst over the window's solves:

    - ``path_gap``: the costs of the accepted iterates against the
      reference's, iterate by iterate, relative (the shorter path held at
      its last cost; with ``path_steps``, the start and the first
      ``path_steps`` accepted steps): the evaluator, the damped steps and
      the minimizer's decisions together;
    - ``param_gap``: the final parameters against the reference's, by
      group (cameras, points), |x - x_ref| / |x_ref|;
    - ``final_cost_gap``: the program's final cost against the
      reference's evaluation at the program's final parameters.
    """
    ref_path = ref_out["accepted_costs"][: None if path_steps is None else path_steps + 1]
    ref_params = {"cameras": ref_out["cameras"], "points": ref_out["points"]}
    out = dict.fromkeys(names, 0.0)
    for s in solves:
        costs = (s["accepted_costs"] or [math.inf])[: None if path_steps is None else path_steps + 1]
        n = max(len(costs), len(ref_path))
        if "path_gap" in out:
            out["path_gap"] = max(out["path_gap"], max(
                _rel(costs[min(k, len(costs) - 1)], ref_path[min(k, len(ref_path) - 1)])
                for k in range(n)))
        if "param_gap" in out:
            for name, ref_x in ref_params.items():
                x = torch.as_tensor(s["params"][name], device=ref_x.device, dtype=ref_x.dtype)
                gap = float(torch.linalg.vector_norm(x - ref_x) / torch.linalg.vector_norm(ref_x))
                out["param_gap"] = max(out["param_gap"], gap if math.isfinite(gap) else math.inf)
        if "final_cost_gap" in out:
            out["final_cost_gap"] = max(out["final_cost_gap"], _rel(
                s["final_cost"], reference.cost(s["params"]["cameras"], s["params"]["points"])))
    return out


def lockstep(costs, ref_costs, rtol: float = 1e-9) -> int:
    """How many leading accepted iterates agree within ``rtol`` (a
    diagnostic of where two float64 paths part)."""
    n = 0
    for a, b in zip(costs, ref_costs):
        if _rel(a, b) > rtol:
            break
        n += 1
    return n


def _selected(benchmark: dict, cell: str):
    """The cell's end-to-end and per-layer metric entries."""
    def covers(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in benchmark["end_to_end"] if covers(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"]
                 if covers(m) and ("workloads" in m or m["moves"] in names)]
    return e2e, per_layer


# the traced run's spans around the calls into the program's layers
# (``layer.<name>``), each on the name its caller looks up: solve()'s
# Problem.compile, Evaluator and SchurSolver, the minimizers' loops, and
# their linearization, damped solve and candidate evaluation
LAYER_SPANS = (
    ("skeres_tpu_torch.core.problem", "Problem.compile", "problem_compile"),
    ("skeres_tpu_torch.core.solver", "Evaluator", "evaluator_setup"),
    ("skeres_tpu_torch.core.solver", "SchurSolver", "schur_plan"),
    ("skeres_tpu_torch.core.device_loop", "DeviceLoopMinimizer.compile_programs", "capture"),
    ("skeres_tpu_torch.core.minimizer", "TrustRegionMinimizer.minimize", "minimize"),
    ("skeres_tpu_torch.core.device_loop", "DeviceLoopMinimizer.minimize", "minimize"),
    ("skeres_tpu_torch.core.minimizer", "TrustRegionMinimizer.linearize", "linearize"),
    ("skeres_tpu_torch.core.minimizer", "TrustRegionMinimizer.solve_step", "damped_solve"),
    ("skeres_tpu_torch.core.minimizer", "TrustRegionMinimizer.try_step", "candidate_cost"),
)


def _wrap_layers(undo: list) -> None:
    """Rebind each of ``LAYER_SPANS`` to a wrapper that opens its span."""
    for module_name, path, span in LAYER_SPANS:
        owner = importlib.import_module(module_name)
        *outer, name = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
        fn = inspect.getattr_static(owner, name)

        def wrapper(*args, _fn=fn, _span=f"layer.{span}", **kwargs):
            with torch.profiler.record_function(_span):
                return _fn(*args, **kwargs)

        undo.append((owner, name, fn))
        setattr(owner, name, wrapper)


def _wrap_entries(readers: dict, calls: dict, undo: list) -> None:
    """Rebind each kernel entry that a reader names (``ENTRY``, the module
    where the caller looks the name up) to a wrapper that counts the call
    from its arguments and opens a ``port.<entry>#<k>`` profiler range."""
    seen = set()
    for reader in readers.values():
        entry = getattr(reader, "ENTRY", None)
        if entry is None or entry in seen:
            continue
        seen.add(entry)
        module = importlib.import_module(entry[0])
        fn = getattr(module, entry[1])
        signature = inspect.signature(fn)
        log = calls.setdefault(entry[1], [])

        def wrapper(*args, _fn=fn, _sig=signature, _log=log, _count=reader.counts,
                    _name=entry[1], **kwargs):
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            k = len(_log)
            _log.append(dict(_count(bound.arguments)))
            with torch.profiler.record_function(f"port.{_name}#{k}"):
                return _fn(*args, **kwargs)

        undo.append((module, entry[1], fn))
        setattr(module, entry[1], wrapper)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, config_overrides: dict | None = None,
             dtype: str | None = None, log=print) -> dict:
    """One run of ``cell_name``. Returns the result object of the last
    line, plus ``"checks"``: each compared number with its limit.
    ``config_overrides`` and ``dtype`` serve the tests and the control.
    The traced run's rebindings are undone when it returns."""
    undo: list = []
    try:
        return _run_cell(cell_name, seed, seconds, trace, device, t_start, config_overrides,
                         dtype, log, undo)
    finally:
        for owner, name, original in reversed(undo):
            setattr(owner, name, original)


def _run_cell(cell_name, seed, seconds, trace, device, t_start, config_overrides, dtype, log,
              undo) -> dict:
    t_start = time.time() if t_start is None else t_start
    benchmark = _load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(cell_name)
    config = {**cell["config_data"], **(config_overrides or {})}
    dtype = dtype or cell["dtype"]
    e2e, per_layer = _selected(benchmark, cell_name)
    readers = {m["name"]: load_reader(m["name"]) for m in e2e + per_layer}
    scene_mod = load_module("scenes", config["generator"])
    on_card = torch.device(device).type == "cuda"

    # -- set-up ------------------------------------------------------------------
    if on_card:
        from skeres_tpu_torch.ops.build import build_all

        t0 = time.perf_counter()
        build_all()
        log(f"[bench] kernels built or found in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    scene = scene_mod.generate(config, seed, device)
    log(f"[bench] scene drawn in {time.perf_counter() - t0:.3f} s; set-up so far "
        f"{time.time() - t_start:.3f} s")
    options = solver_options(cell, device, dtype)
    calls: dict = {}
    if trace:
        _wrap_layers(undo)
        _wrap_entries({m["name"]: readers[m["name"]] for m in per_layer}, calls, undo)
    null = lambda name: contextlib.nullcontext()  # noqa: E731
    warm = dataclasses.replace(options, max_num_iterations=cell["warmup_max_num_iterations"])
    t0 = time.perf_counter()
    timed_solve(scene_mod, scene, warm, null)
    _sync(device)
    log(f"[bench] warm-up solve in {time.perf_counter() - t0:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # -- the measured window ------------------------------------------------------------
    span = torch.profiler.record_function if trace else null
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    w0 = time.perf_counter()
    setup_s = time.time() - t_start
    solves = []
    n_traced = 0
    if prof is not None:
        prof.start()
    while True:
        solves.append(timed_solve(scene_mod, scene, options, span))
        if prof is not None and time.perf_counter() - w0 >= TRACE_SECONDS:
            _sync(device)
            prof.stop()  # the solves after it run untraced
            span, traced, n_traced = null, prof, len(solves)
            prof = None
        if time.perf_counter() - w0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - w0
    if prof is not None:
        prof.stop()
        traced, n_traced = prof, len(solves)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # -- the check against the plain reference, with the program's state freed --------
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference = scene_mod.make_reference(scene, device)
    path_steps = cell.get("path_accepted_steps")
    ref_out = reference.solve(scene.cameras, scene.points, cell["options"], max_accepted=path_steps)
    numbers = compare(solves, ref_out, reference, cell["checks"], path_steps)
    log(f"[bench] reference: {ref_out['iterations']} LM steps, {len(ref_out['accepted_costs']) - 1} "
        f"accepted, final cost {ref_out['final_cost']!r}, {ref_out['termination']}, "
        f"{time.perf_counter() - t0:.3f} s; linear iterations {ref_out['linear_iterations']}; "
        f"in lockstep for {lockstep(solves[0]['accepted_costs'], ref_out['accepted_costs'])} "
        "accepted iterates")
    checks = {k: {"value": v, "limit": cell["checks"][k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    # -- the metrics ---------------------------------------------------------------------
    reduced = None
    if trace:
        from benchmark.trace import reduce_profile

        reduced = reduce_profile(traced)
        del traced
        for entry, log_calls in calls.items():
            for k, call in enumerate(log_calls):
                # counts a reader kept on the device, read now that nothing is timed
                call.update({key: float(v) for key, v in call.items() if torch.is_tensor(v)})
                call["device_s"] = (reduced or {}).get("range_device_s", {}).get(
                    f"port.{entry}#{k}", 0.0)
            log(f"[bench] trace: {entry} {len(log_calls)} calls, "
                f"{sum(c['device_s'] > 0 for c in log_calls)} with device time; the last "
                f"{json.dumps(log_calls[-1]) if log_calls else None}")
    # the program's own timers and counters are read off the solves that ran
    # untraced, where there are any: the profiler slows the host
    rec = dict(
        cell=cell, solves=solves[n_traced:] if trace and n_traced < len(solves) else solves,
        trace=reduced, calls=calls,
        window=dict(setup_s=setup_s, window_s=window_s, peak_bytes=window_peak),
    )
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(solves),
        "failed": sum(not s["usable"] for s in solves),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": max(setup_peak, window_peak),
        },
    }
    if reduced is not None:
        result["device"]["busy_s"] = reduced["busy_s"]
        result["device"]["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    s0 = solves[0]
    log("[bench] window: " + json.dumps(dict(
        seconds=window_s, setup_s=setup_s, solves=len(solves), steps=s0["steps"],
        accepted=len(s0["accepted_costs"]) - 1, final_cost=s0["final_cost"],
        termination=s0["termination"], schur_path=s0["schur_path"], layout=s0["layout"],
        first_clocks_s=[s["clock_s"] for s in solves[:10]], preprocessor_s=s0["preprocessor_s"],
        capture_s=s0["capture_s"], minimizer_s=s0["minimizer_s"],
        linear_iterations=s0["linear_iterations"])))
    return result
