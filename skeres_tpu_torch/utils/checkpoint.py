"""Checkpoint/resume for long solves.

PyTorch counterpart of ``skeres_tpu/utils/checkpoint.py``, in the same
``.npz`` layout (``group_i`` float64 arrays, ``radius``, ``iteration``,
``cost``), so that a file written by either package loads in the other.
The trust-region loop is state-light (parameter arrays, radius,
iteration), so a checkpoint is one file per save, written atomically
(temporary file, then rename) so that a killed job never leaves a torn one.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, group_values, radius: float, iteration: int,
                    cost: Optional[float] = None) -> None:
    payload = {f"group_{i}": np.asarray(v, dtype=np.float64) for i, v in enumerate(group_values)}
    payload["radius"] = np.float64(radius)
    payload["iteration"] = np.int64(iteration)
    payload["cost"] = np.float64(np.nan if cost is None else cost)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path: str):
    """Returns (group_values list, radius, iteration, cost)."""
    with np.load(path) as z:
        groups = []
        i = 0
        while f"group_{i}" in z:
            groups.append(z[f"group_{i}"])
            i += 1
        return groups, float(z["radius"]), int(z["iteration"]), float(z["cost"])
