"""Golden SpMM reference on the host (SciPy); copy of
``flex_tpu.ops.ref.spmm_scipy``."""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def spmm_scipy(g: CSRGraph, B: np.ndarray) -> np.ndarray:
    return np.asarray(g.to_scipy() @ np.asarray(B), dtype=np.float32)
