"""Bridge to the native C++ runtime library (libgsnative.so).

The reference's host side is C++ (engine loop, hapPLY .ply parsing + the
per-gaussian activation transforms + Morton sort, ResourceManager.cpp:167-300).
This module loads the framework's C++ equivalent via ctypes when built
(see native/gsnative.cpp, built by native/build.sh) and transparently falls
back to the pure-numpy implementations otherwise.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(__file__), "libgsnative.so")


def get_lib():
    """Load the native library, or None if not built."""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        path = _lib_path()
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.gs_load_ply.restype = ctypes.c_int
                lib.gs_load_ply.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_longlong),
                ]
                lib.gs_fetch_columns.restype = ctypes.c_int
                lib.gs_fetch_columns.argtypes = [ctypes.c_void_p] * 6
                lib.gs_free.restype = None
                lib.gs_free.argtypes = []
                _LIB = lib
            except OSError:
                _LIB = None
    return _LIB


def try_load_gaussians(path) -> dict | None:
    """Fast-path .ply load via the native parser; None -> caller falls back.

    Returns the same column dict as io.ply.gaussian_columns_from_ply.
    """
    lib = get_lib()
    if lib is None:
        return None
    path = os.fspath(path)
    count = ctypes.c_longlong(0)
    rc = lib.gs_load_ply(path.encode(), ctypes.byref(count))
    if rc != 0:
        return None  # unsupported layout -> python fallback
    n = count.value
    xyz = np.empty((n, 3), dtype=np.float32)
    scales = np.empty((n, 3), dtype=np.float32)
    rots = np.empty((n, 4), dtype=np.float32)
    opacities = np.empty((n,), dtype=np.float32)
    f_dc = np.empty((n, 3), dtype=np.float32)
    f_rest = np.empty((n, 45), dtype=np.float32)
    lib.gs_fetch_columns(
        xyz.ctypes.data_as(ctypes.c_void_p),
        scales.ctypes.data_as(ctypes.c_void_p),
        rots.ctypes.data_as(ctypes.c_void_p),
        opacities.ctypes.data_as(ctypes.c_void_p),
        f_dc.ctypes.data_as(ctypes.c_void_p),
        f_rest.ctypes.data_as(ctypes.c_void_p),
    )
    lib.gs_free()
    return dict(
        xyz=xyz,
        scales=scales,
        rots=rots,
        opacities=opacities,
        f_dc=f_dc,
        f_rest=f_rest,
    )
