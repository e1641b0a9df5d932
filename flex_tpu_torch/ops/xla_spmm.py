"""Gather + segment-sum SpMM: the always-correct device baseline.

Counterpart of ``flex_tpu.ops.xla_spmm`` (its ``"xla"`` method, named so
here too): C[r] = Σ_e vals[e] · B[col[e]] grouped by row, as
``index_select`` + multiply + ``index_add_``.  Memory-bound by design: it
streams nnz·k elements.  Plain PyTorch, as the JAX one is plain XLA; it
holds no hand kernel.  The per-nnz rows are built on the device from the
resident CSR.  The JAX module's 128-lane padding, edge padding and
optimization barriers are TPU layout workarounds and have no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import (
    DeviceCSR, resident_csr, rows_from_row_ptr,
)


def _spmm_edges(rows, cols, vals, B, *, m: int):
    contrib = B.index_select(0, cols) * vals[:, None]      # [E, k]
    return B.new_zeros((m, B.shape[1])).index_add_(0, rows, contrib)


@dataclasses.dataclass
class XLASpmmPlan:
    rows: torch.Tensor  # int64[E]
    cols: torch.Tensor  # int64[E]
    vals: torch.Tensor  # float32[E]
    m: int

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        return _spmm_edges(self.rows, self.cols, self.vals, B, m=self.m)

    @property
    def flops(self) -> int:
        return 2 * int(self.vals.shape[0])  # per feature column

    def traffic_model(self, k: int) -> dict:
        """Byte model: the gather materialises [E, k], the multiply reads
        and writes it, the scatter-add reads it again; C written once."""
        E = int(self.vals.shape[0])
        return {"bytes": 4 * E * k * 4 + self.m * k * 4, "gathered_rows": E}


def prepare_xla(g: CSRGraph, dev: DeviceCSR | None = None,
                device=None) -> XLASpmmPlan:
    dev = resident_csr(g, dev, device)
    return XLASpmmPlan(rows=rows_from_row_ptr(dev.row_ptr, g.nnz, g.m),
                       cols=dev.col.long(), vals=dev.vals, m=g.m)


def spmm_xla(g: CSRGraph, B: torch.Tensor, **kwargs) -> torch.Tensor:
    return prepare_xla(g, **kwargs)(B)
