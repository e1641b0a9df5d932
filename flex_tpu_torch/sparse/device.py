"""Device-resident CSR tensors.

Counterpart of ``flex_tpu.sparse.device``: the raw CSR is moved to the
device once per graph and every format build reads it from there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.sparse.csr import CSRGraph


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a card, a CUDA device (named or by default) raises;
    it never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    row_ptr: torch.Tensor  # int32[m+1]
    col: torch.Tensor      # int32[nnz]
    vals: torch.Tensor     # float32[nnz]
    m: int
    n: int
    nnz: int

    @property
    def device(self) -> torch.device:
        return self.col.device

    @staticmethod
    def from_graph(g: CSRGraph, device=None) -> "DeviceCSR":
        if g.nnz >= 2**31:
            raise ValueError("int32 CSR limit: nnz must be < 2^31")
        dev = resolve_device(device)
        return DeviceCSR(
            row_ptr=torch.from_numpy(g.row_ptr.astype(np.int32)).to(dev),
            col=torch.from_numpy(g.col.astype(np.int32)).to(dev),
            vals=torch.from_numpy(np.ascontiguousarray(g.vals, np.float32)).to(dev),
            m=g.m, n=g.n, nnz=g.nnz,
        )


def round_up(x: int, mult: int) -> int:
    """The least multiple of ``mult`` that is at least ``x``."""
    return -(-x // mult) * mult


def rows_from_row_ptr(row_ptr: torch.Tensor, nnz: int, m: int) -> torch.Tensor:
    """Per-nnz row ids (int64) from a row_ptr.  ``output_size`` keeps the
    call free of a device-to-host sync."""
    deg = (row_ptr[1:m + 1] - row_ptr[:m]).long()
    return torch.repeat_interleave(
        torch.arange(m, device=row_ptr.device), deg, output_size=nnz)


def dense_operand(B, device) -> torch.Tensor:
    """``B`` (NumPy or a tensor) as a contiguous float32 tensor on
    ``device``."""
    Bt = B if torch.is_tensor(B) else torch.from_numpy(np.asarray(B))
    return Bt.to(device=device, dtype=torch.float32).contiguous()


def resident_csr(g: CSRGraph, dev: "DeviceCSR | None" = None,
                 device=None) -> DeviceCSR:
    """The device CSR a prepare call builds from: ``dev`` when one is given
    (a ``device`` that names another device raises), else ``g`` moved to
    ``device`` (:func:`resolve_device`: CUDA unless the caller names
    another)."""
    if dev is None:
        return DeviceCSR.from_graph(g, device)
    if device is not None:
        want = torch.device(device)
        if want.type != dev.device.type or (
                want.index is not None and want.index != dev.device.index):
            raise ValueError(f"dev lies on {dev.device}, device={device}")
    return dev
