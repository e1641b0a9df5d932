"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library in the
package's build directory (listed in ``.gitignore``), named with a hash of
the source and of the headers beside it (``csrc/*.cuh``), so a stale build
is never loaded, and opened with ``ctypes``.
Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from flex_tpu_torch.utils import trace as _trace

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("window_spmm", "window_spmm_bwd", "window_spmm_t", "band_spmm",
           "gespmm", "micro", "winstep_bf16", "edge_dots", "edge_softmax")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict = {}  # (name, symbol) -> the bound C entry
build_log: dict[str, str] = {}  # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not built yet, one nvcc process per source, all
    started together.  Returns name -> library path; raises with nvcc's
    output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, p) in procs.items():
        out, _ = p.communicate()
        build_log[name] = out
        if p.returncode == 0:
            os.replace(tmp, paths[name])
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_host_lib(src: str, stem: str, flags=()) -> str:
    """The g++ build of the host C++ source ``src``: ``lib<stem>-<hash of
    the source>.so`` in the build directory, compiled at first use
    (-mtune, not -march: ISA-portable) to a temporary file that is renamed
    into place, so processes building at once never load a partial file.
    Without a toolchain this raises OSError or CalledProcessError."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{stem}-{h}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-mtune=native", "-std=c++17",
                        "-shared", "-fPIC", *flags, src, "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_all((name,))[name])
            _declare(name, lib)
            _libs[name] = lib
        return _libs[name]


def launch(name: str, symbol: str, device, *args) -> None:
    """Call the C entry ``symbol`` of ``csrc/<name>.cu`` with ``args`` and,
    last, ``device``'s current stream.  The entry returns its launch's
    ``cudaError_t``; anything but 0 raises.  The bound entry is looked up
    once per ``(name, symbol)``; the device is entered only when it is not
    the current one.  The C call is annotated ``flex.launch`` on a
    profiler's clock (:func:`.utils.trace.annotate`)."""
    import torch

    fn = _fns.get((name, symbol))
    if fn is None:
        fn = _fns.setdefault((name, symbol), getattr(load(name), symbol))
    index = device.index
    with _trace.annotate("flex.launch"):
        if index is None or index == torch.cuda.current_device():
            err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        else:
            with torch.cuda.device(index):
                err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def wrappers() -> list:
    """The kernel wrappers: one per hand kernel, kernel 7's bf16
    instance, and the edge softmax's forward and backward.  Each counts
    its own launches in its ``launches`` attribute."""
    from flex_tpu_torch.ops.dyn_ell import edge_dots_rows
    from flex_tpu_torch.ops.edge_softmax import (
        edge_attention_rows, edge_attention_rows_bwd,
    )
    from flex_tpu_torch.ops.gespmm import gespmm_rows, gespmm_rows_bf16
    from flex_tpu_torch.ops.pallas_band import band_spmm_v1, band_spmm_v2
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gB, window_spmm_fwd, window_spmm_t_fwd,
    )

    return [window_spmm_fwd, window_bwd_gA, window_bwd_gB, window_spmm_t_fwd,
            band_spmm_v2, band_spmm_v1, gespmm_rows, gespmm_rows_bf16,
            edge_dots_rows, edge_attention_rows, edge_attention_rows_bwd]


def launch_counts() -> dict[str, int]:
    """Wrapper name -> kernel launches in this process so far."""
    return {fn.__name__: fn.launches for fn in wrappers()}


def reset_launch_counts() -> None:
    for fn in wrappers():
        fn.launches = 0


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "window_spmm":
        # (A, B, win_step, units, out, scratch,
        #  n_units, TM, G, W, n, k, nblk, stream)
        lib.flex_window_spmm_fwd.argtypes = [p, p, p, p, p, p,
                                             i, i, i, i, i, i, i, p]
        lib.flex_window_spmm_fwd.restype = i
        # (scratch, out, splits, n_splits, tile_elems, stream)
        lib.flex_window_spmm_reduce.argtypes = [p, p, p, i, i, p]
        lib.flex_window_spmm_reduce.restype = i
    elif name == "window_spmm_bwd":
        # (g, B, win_step, out_panel, units, g_A,
        #  n_units, TM, G, W, n, k, nblk, stream)
        lib.flex_window_bwd_gA.argtypes = [p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, p]
        lib.flex_window_bwd_gA.restype = i
        # (A, g, slot_s, slot_g, units, out_panel, out, scratch,
        #  n_units, TM, G, W, k, stream)
        lib.flex_window_bwd_gB.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, p]
        lib.flex_window_bwd_gB.restype = i
        # (scratch, out, splits, n_splits, tile_elems, stream)
        lib.flex_window_bwd_gB_reduce.argtypes = [p, p, p, i, i, p]
        lib.flex_window_bwd_gB_reduce.restype = i
    elif name == "window_spmm_t":
        # (AT, BT, win_step, units, outT, scratch,
        #  n_units, n_panels, TM, G, W, n, k, nblk, stream)
        lib.flex_window_spmm_t_fwd.argtypes = [p, p, p, p, p, p,
                                               i, i, i, i, i, i, i, i, p]
        lib.flex_window_spmm_t_fwd.restype = i
        # (scratch, outT, splits, n_splits, n_panels, TM, k, stream)
        lib.flex_window_spmm_t_reduce.argtypes = [p, p, p, i, i, i, i, p]
        lib.flex_window_spmm_t_reduce.restype = i
    elif name == "band_spmm":
        # (a_left, a_right, iW, ranges, B, out, P, TM, W, n, k, stream)
        lib.flex_band_spmm_v2.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.flex_band_spmm_v2.restype = i
        # (band, ws, ranges, B, out, P, TM, W, n, k, stream)
        lib.flex_band_spmm_v1.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.flex_band_spmm_v1.restype = i
    elif name == "gespmm":
        # (cols, vals, row_start, units, splits, B, out, scratch,
        #  n_units, n_splits, k, accumulate, stream)
        lib.flex_gespmm_rows.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.flex_gespmm_rows.restype = i
        # (..., accumulate, lanes, stream): k <= 64, lane groups
        lib.flex_gespmm_rows_grouped.argtypes = [p, p, p, p, p, p, p, p,
                                                 i, i, i, i, i, p]
        lib.flex_gespmm_rows_grouped.restype = i
        # (..., accumulate, ldb, lanes, stream): B's row stride, lanes a unit
        lib.flex_gespmm_rows_bf16.argtypes = [p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, i, p]
        lib.flex_gespmm_rows_bf16.restype = i
    elif name == "micro":
        # (B, idx, out, n_steps, rows, k, depth, stream)
        lib.flex_row_gather_sum.argtypes = [p, p, p, i, i, i, i, p]
        # (x, out, nbytes, stream)
        lib.flex_smem_probe.argtypes = [p, p, i, p]
        # (nbytes, stream)
        lib.flex_empty_probe.argtypes = [i, p]
        ip = ctypes.POINTER(ctypes.c_int)
        # (int* out)
        lib.flex_smem_optin.argtypes = [ip]
        # (slab, idx, out, n_rows, U, k, placement, round_bf16, stream)
        lib.flex_slab_gather.argtypes = [p, p, p, ctypes.c_int64, i, i, i,
                                         i, p]
        # (U, k, int* n_clusters)
        lib.flex_slab_cluster_occupancy.argtypes = [i, i, ip]
        # (v, Bg, out, N, w, k, stream)
        lib.flex_ell_reduce.argtypes = [p, p, p, i, i, i, p]
        for fn in ("flex_row_gather_sum", "flex_smem_probe",
                   "flex_empty_probe", "flex_smem_optin", "flex_slab_gather",
                   "flex_slab_cluster_occupancy", "flex_ell_reduce"):
            getattr(lib, fn).restype = i
    elif name == "winstep_bf16":
        # (A, Bb, win_step, units, out, scratch,
        #  n_units, TM, G, W, n, k, nblk, S, ldb, stream): Bb the bf16 copy
        #  of B, rows ldb elements apart
        lib.flex_winstep_bf16.argtypes = [p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, i, i, p]
        lib.flex_winstep_bf16.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        # (W, int* bk, int* stages, int* smem_bytes)
        lib.flex_winstep_bf16_layout.argtypes = [i, ip, ip, ip]
        lib.flex_winstep_bf16_layout.restype = i
    elif name == "edge_dots":
        # (cols, row_start, units, g, B, out, n_units, k, lanes, width,
        #  stream)
        lib.flex_edge_dots.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.flex_edge_dots.restype = i
    elif name == "edge_softmax":
        f = ctypes.c_float
        # (row_ptr, cols, long_rows, n_long, warp_edges, s_src, s_dst,
        #  alpha, m, slope, stream)
        lib.flex_edge_softmax_fwd.argtypes = [p, p, p, i, i, p, p, p, i, f,
                                              p]
        lib.flex_edge_softmax_fwd.restype = i
        # (row_ptr, cols, long_rows, n_long, col_ptr, long_cols, n_long_cols,
        #  warp_edges, perm, alpha, g, s_src, s_dst, dz, d_src, d_dst, m, n,
        #  slope, stream)
        lib.flex_edge_softmax_bwd.argtypes = [p, p, p, i, p, p, i, i, p, p,
                                              p, p, p, p, p, p, i, i, f, p]
        lib.flex_edge_softmax_bwd.restype = i
    else:
        raise ValueError(f"no CUDA source named {name!r}")
