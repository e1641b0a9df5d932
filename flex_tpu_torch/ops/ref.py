"""Golden SpMM references on the host: SciPy, and a dense NumPy product
for tiny matrices; copy of ``flex_tpu.ops.ref``."""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def spmm_scipy(g: CSRGraph, B: np.ndarray) -> np.ndarray:
    return np.asarray(g.to_scipy() @ np.asarray(B), dtype=np.float32)


def spmm_dense_numpy(g: CSRGraph, B: np.ndarray) -> np.ndarray:
    """O(m·n·k) dense check for tiny matrices only."""
    A = g.to_scipy().toarray()
    return (A @ np.asarray(B)).astype(np.float32)
