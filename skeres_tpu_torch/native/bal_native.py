"""ctypes binding of the native BAL parser (``bal_loader.cpp``), built at
the first call of :func:`load`."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from skeres_tpu_torch.native import build_shared

__all__ = ["load"]


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_shared("bal_loader", ["bal_loader.cpp"]))
    lib.bal_sizes.restype = ctypes.c_int
    lib.bal_sizes.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.bal_load.restype = ctypes.c_int
    lib.bal_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_int32)] + [ctypes.POINTER(ctypes.c_double)] * 3
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load(path: str):
    """Parse the BAL text file at ``path``; returns (cameras, points,
    camera_index, point_index, observations). Raises ``IOError`` on a file
    that cannot be read or parsed."""
    lib = _library()
    sizes = (ctypes.c_int64 * 3)()
    rc = lib.bal_sizes(path.encode(), sizes)
    if rc != 0:
        raise IOError(f"bal_sizes({path}) failed with code {rc}")
    nc, npts, nobs = int(sizes[0]), int(sizes[1]), int(sizes[2])
    if min(nc, npts, nobs) < 0:
        raise IOError(f"{path}: negative sizes {nc} {npts} {nobs}")
    cam_idx = np.empty(nobs, dtype=np.int32)
    pt_idx = np.empty(nobs, dtype=np.int32)
    obs = np.empty((nobs, 2), dtype=np.float64)
    cameras = np.empty((nc, 9), dtype=np.float64)
    points = np.empty((npts, 3), dtype=np.float64)
    rc = lib.bal_load(path.encode(), _ptr(cam_idx, ctypes.c_int32), _ptr(pt_idx, ctypes.c_int32),
                      _ptr(obs, ctypes.c_double), _ptr(cameras, ctypes.c_double),
                      _ptr(points, ctypes.c_double))
    if rc != 0:
        raise IOError(f"bal_load({path}) failed with code {rc}")
    return cameras, points, cam_idx, pt_idx, obs
