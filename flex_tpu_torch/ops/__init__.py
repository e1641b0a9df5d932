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

The names are the JAX package's.  Its ``"panel"`` is not ported yet.

Also here: :func:`gcn_layer` and :func:`pick_association`
(:mod:`.gcn`), the GCN layer on any prepared plan.
"""
from __future__ import annotations

import importlib

import numpy as np
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
}
NOT_PORTED = ("panel",)


def prepare_fn(method: str):
    """The ``prepare_*`` function of a device method; unknown and
    not-yet-ported methods raise a ValueError that names them."""
    if method in NOT_PORTED:
        raise ValueError(f"spmm method {method!r} is not ported yet")
    if method not in PREPARE:
        raise ValueError(f"unknown spmm method {method!r}")
    module, fn = PREPARE[method]
    return getattr(importlib.import_module(f"flex_tpu_torch.ops.{module}"), fn)


def spmm(g, B, method: str = "windowed", device=None, **kwargs):
    """``C = A @ B`` for CSRGraph ``g`` and dense ``B`` (NumPy or tensor).
    Device methods run on ``device`` (CUDA unless the caller names
    another) and return a tensor there."""
    if method == "ref":
        from flex_tpu_torch.ops.ref import spmm_scipy

        return spmm_scipy(g, B.cpu().numpy() if torch.is_tensor(B) else B)
    prepare = prepare_fn(method)
    from flex_tpu_torch.sparse.device import resolve_device

    dev = resolve_device(device)
    Bt = (B if torch.is_tensor(B) else torch.from_numpy(np.asarray(B))).to(
        device=dev, dtype=torch.float32).contiguous()
    return prepare(g, device=dev, **kwargs)(Bt)
