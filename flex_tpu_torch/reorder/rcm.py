"""Reverse Cuthill–McKee ordering (host).

Copy of ``flex_tpu.reorder.rcm``: SciPy's ``reverse_cuthill_mckee`` on the
symmetrised pattern (``symmetric_mode=False`` makes SciPy work on A + Aᵀ,
the undirected graph).
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def order_rcm(g: CSRGraph) -> np.ndarray:
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = reverse_cuthill_mckee(g.to_scipy(), symmetric_mode=False)
    return perm.astype(np.int64)  # perm[new] = old, SciPy's convention too
