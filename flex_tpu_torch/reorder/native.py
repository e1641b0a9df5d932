"""ctypes bindings + build at first use for the C++ orderings (dfs,
gorder, rabbit).

``_native/reorder.cc`` (a copy of the JAX package's source) is compiled
with g++ into the port's build directory by
:func:`..kernels.build_host_lib`: the library name carries a hash of the
source, so a stale build is never loaded, and the build is atomic.
Without a toolchain :func:`available` is False and the pure-Python
orderings run instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from flex_tpu_torch.kernels import build_host_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "reorder.cc")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build_host_lib(_SRC, "flexreorder"))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = str(e)  # no toolchain: pure-Python fallback
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.flex_order_dfs.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
        lib.flex_order_dfs.restype = None
        lib.flex_order_gorder.argtypes = [
            ctypes.c_int64, i64p, i32p, i64p, i32p, ctypes.c_int64, i64p,
        ]
        lib.flex_order_gorder.restype = None
        lib.flex_order_rabbit.argtypes = [
            ctypes.c_int64, i64p, i32p, ctypes.c_int32, ctypes.c_int64,
            i64p, i64p,
        ]
        lib.flex_order_rabbit.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reorder unavailable: {_build_error}")
    return lib


def order_dfs_native(row_ptr: np.ndarray, col: np.ndarray) -> np.ndarray:
    lib = _lib_or_raise()
    n = len(row_ptr) - 1
    out = np.empty(n, dtype=np.int64)
    lib.flex_order_dfs(n, np.ascontiguousarray(row_ptr, np.int64),
                       np.ascontiguousarray(col, np.int32), out)
    return out


def order_gorder_native(
    out_rp: np.ndarray, out_col: np.ndarray,
    in_rp: np.ndarray, in_col: np.ndarray, window: int,
) -> np.ndarray:
    lib = _lib_or_raise()
    n = len(out_rp) - 1
    out = np.empty(n, dtype=np.int64)
    lib.flex_order_gorder(
        n, np.ascontiguousarray(out_rp, np.int64),
        np.ascontiguousarray(out_col, np.int32),
        np.ascontiguousarray(in_rp, np.int64),
        np.ascontiguousarray(in_col, np.int32), window, out,
    )
    return out


def order_rabbit_native(
    row_ptr: np.ndarray, col: np.ndarray, force_undirected: bool,
    max_rounds: int = 64, want_labels: bool = False,
):
    """Returns perm, or (perm, labels) with labels[old_vertex] = cluster id
    in emission order when ``want_labels``."""
    lib = _lib_or_raise()
    n = len(row_ptr) - 1
    out = np.empty(n, dtype=np.int64)
    labels = np.empty(n, dtype=np.int64)
    lib.flex_order_rabbit(
        n, np.ascontiguousarray(row_ptr, np.int64),
        np.ascontiguousarray(col, np.int32),
        1 if force_undirected else 0, max_rounds, out, labels,
    )
    return (out, labels) if want_labels else out
