"""Degree ordering (host).

Copy of ``flex_tpu.reorder.deg``: a stable sort by degree, descending by
default, with node-id-ascending tie-break.  The panel plan needs it: its
hub rows must form a prefix.
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def order_deg(g: CSRGraph, desc: bool = True) -> np.ndarray:
    d = g.degrees
    key = -d if desc else d
    return np.argsort(key, kind="stable").astype(np.int64)
