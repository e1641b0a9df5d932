"""The plain reference of ``model.kind: "gcn2"``, the 2-layer GCN (Kipf &
Welling): Z = A'·(relu(A'·(X·W1) + b1)·W2) + b2.  ``params`` are
(W1, b1, W2, b2), the order of ``models/gcn2.py``'s weights."""
from __future__ import annotations

import torch

from spmm_bench.reference.common import matmul, spmm


def forward(A, X, params, mode="f64") -> torch.Tensor:
    """The logits."""
    W1, b1, W2, b2 = params
    h = torch.relu(spmm(A, matmul(X, W1, mode), mode) + b1)
    return spmm(A, matmul(h, W2, mode), mode) + b2
