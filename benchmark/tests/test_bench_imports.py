"""What the benchmark loads: after a dry run of the harness and the
reference, no module whose whole top-level name is jax, jaxlib, flax or
skeres_tpu (skeres_tpu_torch is the program, and allowed); and the
reference alone loads nothing of the program."""

import json
import subprocess
import sys

from benchmark.harness import ROOT

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests.conftest import TINY
r = harness.run_cell("venice1778.dense-schur", 5, 0.0, True, device="cpu", config_overrides=TINY,
                     log=lambda m: None)
print(json.dumps(dict(correct=r["correct"], top=sorted({{m.split(".")[0] for m in sys.modules}}))))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness import load_cell, load_module
from benchmark.tests.conftest import TINY
cell = load_cell("venice1778.iterative-schur")
config = {{**cell["config_data"], **TINY}}
scene_mod = load_module("scenes", config["generator"])
scene = scene_mod.generate(config, 9, "cpu")
out = scene_mod.make_reference(scene, "cpu").solve(scene.cameras, scene.points, cell["options"])
print(json.dumps(dict(steps=out["iterations"], top=sorted({{m.split(".")[0] for m in sys.modules}}))))
"""


def _top_modules(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    r = _top_modules(HARNESS)
    assert r["correct"] and "skeres_tpu_torch" in r["top"]
    assert not {"jax", "jaxlib", "flax", "skeres_tpu"} & set(r["top"])


def test_reference_loads_nothing_of_the_program():
    r = _top_modules(REFERENCE)
    assert r["steps"] >= 1
    assert not {"jax", "jaxlib", "flax", "skeres_tpu", "skeres_tpu_torch"} & set(r["top"])
