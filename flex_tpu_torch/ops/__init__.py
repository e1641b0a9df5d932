"""SpMM dispatcher.

- ``"ref"``      — SciPy host reference (golden), returns NumPy.
- ``"ell"``      — width-bucketed row chunks.
- ``"windowed"`` — dense window tiles (hand-written CUDA kernel) + ELL
                   residue, for community graphs after rbdeg/rabbit.

Also here: :func:`gcn_layer` and :func:`pick_association`
(:mod:`.gcn`), the GCN layer on any prepared plan.
"""
from __future__ import annotations

import numpy as np
import torch

from flex_tpu_torch.ops.gcn import gcn_layer, pick_association  # noqa: F401


def spmm(g, B, method: str = "windowed", device=None, **kwargs):
    """``C = A @ B`` for CSRGraph ``g`` and dense ``B`` (NumPy or tensor).
    Device methods run on ``device`` (CUDA unless the caller names
    another) and return a tensor there."""
    if method == "ref":
        from flex_tpu_torch.ops.ref import spmm_scipy

        return spmm_scipy(g, B.cpu().numpy() if torch.is_tensor(B) else B)
    from flex_tpu_torch.sparse.device import resolve_device

    dev = resolve_device(device)
    Bt = (B if torch.is_tensor(B) else torch.from_numpy(np.asarray(B))).to(
        device=dev, dtype=torch.float32).contiguous()
    if method == "ell":
        from flex_tpu_torch.ops.ell_spmm import prepare_ell

        return prepare_ell(g, device=dev, **kwargs)(Bt)
    if method == "windowed":
        from flex_tpu_torch.ops.window_spmm import prepare_windowed

        return prepare_windowed(g, device=dev, **kwargs)(Bt)
    raise ValueError(f"unknown spmm method {method!r}")
