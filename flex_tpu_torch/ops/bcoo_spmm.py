"""Stock-library SpMM baseline: ``torch.sparse.mm`` on a CSR tensor.

Counterpart of ``flex_tpu.ops.bcoo_spmm`` (its ``"bcoo"`` method, named so
here too).  There the stock competitor is JAX's own sparse product; here
it is PyTorch's, which on a CUDA tensor is the vendor's sparse library.  It
shares nothing with the ELL, windowed, band or GE-SpMM paths, so it is an
honest cross-check of both correctness and speed.  It holds no hand
kernel, as the JAX one holds no Pallas kernel, and it is a method the
caller names: no other method routes to it.

The CSR tensor is built from the device-resident CSR; the host ships
nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, resident_csr


@dataclasses.dataclass
class BcooPlan:
    m: int
    n: int
    nnz: int
    mat: torch.Tensor  # sparse CSR [m, n]

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.mat, B)

    @property
    def stats(self) -> dict:
        return {"format": "csr", "nnz": self.nnz}

    def traffic_model(self, k: int) -> dict:
        """Lower-bound byte model: per-nnz (col, val) reads, the row
        pointers, one B row per nnz, and the output."""
        by = self.nnz * 8 + (self.m + 1) * 4 + self.nnz * k * 4 \
            + self.m * k * 4
        return {"bytes": int(by), "gathered_rows": self.nnz}


def prepare_bcoo(g: CSRGraph, dev: DeviceCSR | None = None,
                 device=None) -> BcooPlan:
    dev = resident_csr(g, dev, device)
    mat = torch.sparse_csr_tensor(dev.row_ptr, dev.col, dev.vals,
                                  size=(g.m, g.n))
    return BcooPlan(m=g.m, n=g.n, nnz=g.nnz, mat=mat)


def spmm_bcoo(g: CSRGraph, B: torch.Tensor, **kwargs) -> torch.Tensor:
    return prepare_bcoo(g, **kwargs)(B)
