"""ctypes bindings + build at first use for the C++ CSV line parser.

``_native/fastcsv.cc`` (a copy of the JAX package's parser) is compiled
with g++ into the port's build directory by
:func:`..kernels.build_host_lib`, as :mod:`..reorder.native` is: the
library name carries a hash of the source, so a stale build is never
loaded, and the build writes a temporary file that is renamed into place,
so processes building at once never load a partial file.  Without a
toolchain :func:`available` is False and the NumPy parse runs instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from flex_tpu_torch.kernels import build_host_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "fastcsv.cc")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build_host_lib(_SRC, "flexcsv", ("-pthread",)))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = str(e)  # no toolchain: NumPy parse
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.flex_csv_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.flex_csv_count.restype = ctypes.c_int64
        lib.flex_csv_parse_i64.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int]
        lib.flex_csv_parse_i64.restype = ctypes.c_int64
        lib.flex_csv_parse_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int]
        lib.flex_csv_parse_f32.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


_NTHREADS = min(os.cpu_count() or 1, 16)


def parse_number_line(line: bytes, dtype) -> np.ndarray:
    """Parse one comma-separated number line (stripped of its newline)
    into a NumPy array, with the C++ parser when it builds and
    :func:`_numpy_parse` otherwise.  Malformed input raises ValueError in
    both.  The C++ parser reads an empty token before a comma as 0; the
    NumPy parse refuses it, as in the JAX package."""
    dtype = np.dtype(dtype)
    if not line:
        return np.empty(0, dtype=dtype)
    lib = _load()
    if lib is None:
        return _numpy_parse(line, dtype)
    n = lib.flex_csv_count(line, len(line))
    out = np.empty(n, dtype=np.int64 if dtype.kind == "i" else np.float32)
    fn = (lib.flex_csv_parse_i64 if dtype.kind == "i"
          else lib.flex_csv_parse_f32)
    got = fn(line, len(line), out, n, _NTHREADS)
    if got != n:  # the parser flagged bytes it could not read
        raise ValueError(
            f"malformed number line (expected {n} comma-separated "
            f"{dtype.name} values): {line[:80]!r}...")
    return out.astype(dtype, copy=False)


def _numpy_parse(line: bytes, dtype: np.dtype) -> np.ndarray:
    """Parse without a toolchain.  np.fromstring's partial parse of bad
    input is deprecated; count the tokens so that malformed input raises
    here as in the C++ parser."""
    import warnings

    n = line.count(b",") + 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = np.fromstring(line.decode(), sep=",", dtype=dtype)
    if out.shape[0] != n:
        raise ValueError(
            f"malformed number line (expected {n} comma-separated "
            f"{dtype.name} values): {line[:80]!r}...")
    return out
