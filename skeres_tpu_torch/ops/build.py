"""Build the port's CUDA kernels from the sources in this checkout.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` at first use, into ``build/skeres_tpu_torch/``
keyed by a hash of the source and flags, and loaded with ``ctypes``. A
rebuild of the same source reuses the library. Nothing is compiled at
import. :func:`build_all` starts one ``nvcc`` for every source at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load_library"]

SOURCES = ("cholesky", "pair_product", "graph_cond", "s_product", "reprojection")  # csrc/<name>.cu

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "skeres_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def load_library(name: str, defines: tuple = ()):
    """Compile ``csrc/<name>.cu`` (once per source hash and ``defines``,
    preprocessor macros such as ``("SKERES_K1_CLOCKS",)``) and load it.
    Returns ``(library, compiler_log)``; the log is empty when an earlier
    build of the same source was reused."""
    source = _CSRC / f"{name}.cu"
    src = source.read_bytes()
    flags = _NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"{name}-{key}.so"
    log = ""
    if not lib_path.exists():
        nvcc = _nvcc()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *flags, "-o", tmp, str(source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: concurrent builds end with the same file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib_path)), log


def build_all() -> dict:
    """Build every kernel source in parallel: ``{name: compiler_log}``."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(load_library, SOURCES)))
    return {name: log for name, (_, log) in built.items()}
