"""Run one cell of the benchmark of skeres_tpu_torch on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted`` (solves in the window), ``failed``
(solves whose solution is not usable), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and,
traced, ``breakdown``; last in it, ``checks``: each number compared with
the plain reference beside its limit. The same numbers are the last lines
of standard error. A run without a CUDA card, or with fewer cards than the
cell asks for, prints no result and exits with 3; one that finds JAX or
the JAX package loaded once the window has closed prints no result and
exits with 4.

Every cache the run writes lies under ``build/`` in the checkout, at fixed
paths: the kernels' nvcc builds (``build/skeres_tpu_torch/``, the
program's own), Python's bytecode (``build/benchmark/pycache``), and the
directories torch's extension and Triton caches would use.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "benchmark")
sys.pycache_prefix = os.path.join(CACHE, "pycache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT  # import the benchmark as a package, and the program beside it
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _card_line(torch) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else \
        "nvidia-smi gave nothing"
    return f"[bench] card: {torch.cuda.get_device_name(0)} (nvidia-smi: {smi})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"[bench] no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    print(_card_line(torch), file=sys.stderr, flush=True)
    print(f"[bench] torch imported and the card found at {time.time() - T_START:.3f} s",
          file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START,
                              log=lambda msg: print(msg, file=sys.stderr, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
