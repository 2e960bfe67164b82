"""Native (C++) host code of the port: the BAL text loader.

Each source here has a plain C interface. It is compiled with ``g++`` at
first use into ``build/skeres_tpu_torch/``, keyed by a hash of the source
and flags (as ``ops/build.py`` does for the CUDA kernels), and loaded with
``ctypes``. Nothing is compiled at import. A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build_shared"]

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "skeres_tpu_torch"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_shared(name: str, sources: list[str]) -> str:
    """Compile ``sources`` (files beside this module) into one shared
    library, unless a build of the same sources and flags exists; returns
    its path."""
    srcs = [_HERE / s for s in sources]
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        digest.update(s.read_bytes())
    out = _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, *map(str, srcs), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {sources}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds end with the same file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(out)
