"""Dense feature operand (host, NumPy); copy of ``make_features`` from
``flex_tpu.io.csv_loader``."""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def make_features(g: CSRGraph, k: int, seed: int = 1, debug: bool = False) -> np.ndarray:
    """The dense operand B: n×k random U[-1,1) features (row-index
    features with ``debug=True``, for hand-checking)."""
    if debug:
        return np.broadcast_to(
            np.arange(g.n, dtype=np.float32)[:, None], (g.n, k)
        ).copy()
    rng = np.random.default_rng(seed)
    return (2.0 * rng.random((g.n, k)) - 1.0).astype(np.float32)
