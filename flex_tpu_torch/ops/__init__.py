"""SpMM dispatcher.

- ``"ref"``      — SciPy host reference (golden), returns NumPy.
- ``"xla"``      — gather + scatter-add in plain tensor ops (the
                   always-correct device baseline).
- ``"bcoo"``     — ``torch.sparse.mm`` on a CSR tensor (the stock-library
                   baseline).
- ``"ell"``      — width-bucketed row chunks.
- ``"windowed"`` — dense window tiles (hand-written CUDA kernels) + ELL
                   residue, for community graphs after rbdeg/rabbit;
                   ``transposed=True`` picks the narrow-k kernel.
- ``"band"``     — dense column-window path for banded matrices
                   (``impl="pallas2"``, ``"xla"`` or ``"pallas"``).
- ``"gespmm"``   — GE-SpMM row-parallel chunks (second-opinion baseline).
- ``"panel"``    — hub rows as row sums + tail rows as dense tm-row panels,
                   for graphs whose rows share few columns after a DEG
                   ordering.

The names, and the default ``"xla"``, are the JAX package's.

Also here: :func:`gcn_layer` and :func:`pick_association`
(:mod:`.gcn`), the GCN layer on any prepared plan.
"""
from __future__ import annotations

import importlib

import torch

from flex_tpu_torch.ops.gcn import gcn_layer, pick_association  # noqa: F401

# method -> (module, prepare function); every prepare takes (g, device=...)
PREPARE = {
    "xla": ("xla_spmm", "prepare_xla"),
    "bcoo": ("bcoo_spmm", "prepare_bcoo"),
    "ell": ("ell_spmm", "prepare_ell"),
    "windowed": ("window_spmm", "prepare_windowed"),
    "band": ("pallas_band", "prepare_band"),
    "gespmm": ("gespmm", "prepare_gespmm"),
    "panel": ("panel_spmm", "prepare_panel"),
}


def prepare_fn(method: str):
    """The ``prepare_*`` function of a device method; an unknown method
    raises a ValueError that names it."""
    if method not in PREPARE:
        raise ValueError(f"unknown spmm method {method!r}")
    module, fn = PREPARE[method]
    return getattr(importlib.import_module(f"flex_tpu_torch.ops.{module}"), fn)


def spmm(g, B, method: str = "xla", device=None, **kwargs):
    """``C = A @ B`` for CSRGraph ``g`` and dense ``B`` (NumPy or tensor),
    through the method's ``spmm_<method>`` (prepare, then call), as the JAX
    dispatcher does.  Device methods run on ``device`` (CUDA unless the
    caller names another) and return a tensor there."""
    if method == "ref":
        from flex_tpu_torch.ops.ref import spmm_scipy

        return spmm_scipy(g, B.cpu().numpy() if torch.is_tensor(B) else B)
    if method not in PREPARE:
        raise ValueError(f"unknown spmm method {method!r}")
    from flex_tpu_torch.sparse.device import dense_operand, resolve_device

    module = importlib.import_module(
        f"flex_tpu_torch.ops.{PREPARE[method][0]}")
    dev = resolve_device(device)
    return getattr(module, f"spmm_{method}")(
        g, dense_operand(B, dev), device=dev, **kwargs)
