"""A dry run of every cell on the CPU at a tiny size: the harness's set-up,
window, metrics and the check against the reference, with the program's
plain kernel versions; and the command line without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import TINY

# what a CPU run has nothing to read for: the card's memory, and the
# device loop's capture of a CUDA graph
CARD_ONLY = {"peak_mem_gib", "capture_s"}
CELLS = ["venice1778.dense-schur", "ladybug49.device-loop", "venice1778.iterative-schur",
         "ladybug49.host-loop"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell, trace):
    r = harness.run_cell(cell, 4_294_967_311, 0.2, trace, device="cpu", config_overrides=TINY,
                         log=lambda msg: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks" and r["device"]["platform"] == "cpu"
    # every metric the cell reports that a CPU run can read: not the card's
    # memory, and nothing from a device trace
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        e2e, per_layer = harness._selected(json.load(f), cell)
    want = {m["name"] for m in (per_layer if trace else e2e)
            if m["source"] != "device_trace" and m["name"].split(".")[0] not in CARD_ONLY}
    assert set(r["metrics"]) == want


def test_no_card_no_result():
    """Without a CUDA card the command prints no result and fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ladybug49.device-loop",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the launch-bound cell on the card: a result line,
    correct, on the card it names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ladybug49.device-loop",
                          "--seed", "3", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
