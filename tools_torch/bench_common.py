"""What the port's measuring scripts share.

``tools_torch/bench_sphere.py``, ``bench_two_signature.py`` and
``bench_scaling.py`` are the PyTorch counterparts of the JAX package's
``tools/bench_*.py``:
the same flags and defaults, the same ``SolverOptions``, the same JSON
keys on the last line (``extra.backend`` becomes ``extra.device``), plus
``--device`` (default ``cuda``) and ``--dtype`` (default ``float32``, what
the JAX scripts run: they leave x64 off).

Each script resolves its device and touches it before it builds a scene,
so that without a card it raises instead of running on the CPU; builds
every kernel source, and solves once (a warm-up solve of its counterpart's,
or a small scene's), before its timed solves, so that neither ``nvcc`` nor
a process's one-time set-up lands in a minimizer's seconds; and prints, on an earlier line, one
``[<script>] solve {...}`` JSON object a timed solve: its set-up seconds
(the preprocessor, the device loop's capture included), the minimizer's
seconds, the steps, the costs and the kernels' launches (under the device
loop these count captures, not replays). Time is read as the JAX scripts
read it, from ``Summary.minimizer_time_in_seconds``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__all__ = ["ROOT", "add_device_flags", "build_kernels", "device_info", "resolve_device",
           "timed_solve", "warm_up"]


def add_device_flags(ap) -> None:
    """The two flags every script adds to its counterpart's."""
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))


def resolve_device(args) -> tuple[torch.device, torch.dtype]:
    """The device and dtype the flags name. The device is touched here,
    before any scene is built: ``cuda`` without a card raises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (--device cpu runs on the CPU)")
    torch.zeros(1, device=device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device, getattr(torch, args.dtype)


def device_info(device: torch.device):
    """``{"name", "power_limit"}`` of the card, as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    name, power_limit = lines[index].rsplit(", ", 1)
    return {"name": name.strip(), "power_limit": power_limit.strip()}


def build_kernels(device: torch.device, tag: str) -> None:
    """On the card, build every kernel source (one ``nvcc`` each, started
    together; a build of the same source in ``build/`` is reused) and print
    the seconds. Nothing to build on the CPU."""
    if device.type != "cuda":
        return
    from skeres_tpu_torch.ops.build import SOURCES, build_all

    t0 = time.perf_counter()
    build_all()
    seconds = time.perf_counter() - t0
    print(f"[{tag}] build {json.dumps({'seconds': seconds, 'sources': list(SOURCES)})}",
          flush=True)


def warm_up(tag: str, options, problem) -> None:
    """Solve ``problem`` (a small scene of the timed one's kind) with the
    timed solve's options, and print the seconds. A process's first solve
    pays one-time set-up that the JAX scripts' compile cache keeps out of
    their minimizer's seconds: torch's lazy imports behind ``torch.func``
    (compiled from source where no bytecode cache is written), the first
    cuBLAS and cuSOLVER calls. Scripts whose counterpart has no warm-up
    solve of its own call this before the timed solve."""
    import dataclasses

    import skeres_tpu_torch as stt

    t0 = time.perf_counter()
    stt.solve(dataclasses.replace(options, minimizer_progress_to_stdout=False), problem)
    seconds = time.perf_counter() - t0
    print(f"[{tag}] warm-up {json.dumps({'seconds': seconds})}", flush=True)


def _launch_counts() -> dict:
    """The kernels' launch counters: K1 (alone or as K2's panels), K2's
    trailing update, K3."""
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products

    return {"K1": cholesky_both.launches, "K2 update": trailing_update_.launches,
            "K3": pair_products.launches}


def timed_solve(tag: str, label: str, options, problem, program=None):
    """``solve(options, problem)``; prints its ``[<tag>] solve`` line with
    the launches it made and returns the Summary."""
    import skeres_tpu_torch as stt

    before = _launch_counts()
    summary = stt.solve(options, problem, program)
    after = _launch_counts()
    record = {
        "label": label,
        "preprocessor_s": summary.preprocessor_time_in_seconds,
        "capture_s": summary.device_loop_capture_time_in_seconds,
        "minimizer_s": summary.minimizer_time_in_seconds,
        "steps": summary.num_successful_steps + summary.num_unsuccessful_steps,
        "linear_solves": summary.num_linear_solves,
        "initial_cost": summary.initial_cost,
        "final_cost": summary.final_cost,
        "launches": {name: after[name] - before[name] for name in after},
    }
    print(f"[{tag}] solve {json.dumps(record)}", flush=True)
    return summary
