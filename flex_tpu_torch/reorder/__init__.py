"""Vertex orderings (host).  Every function returns ``perm`` with
``perm[new_id] = old_id``.

  - ``ovo``    — original vertex order (identity).
  - ``rabbit`` — modularity clustering (:mod:`.rabbit`).
  - ``rbdeg``  — rabbit clusters contiguous, vertices degree-descending
                 inside each cluster: concentrates every cluster's
                 high-degree columns into a few aligned column blocks,
                 which the windowed format turns into dense tiles.
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.perm import apply_vertex_order

ORDER_ABBR = {
    "ovo": "OVO",
    "rabbit": "RBT",
    "rbdeg": "RBD",
}


def compute_order(g: CSRGraph, method: str, **kwargs) -> np.ndarray:
    """Return perm[new] = old for the requested ordering."""
    from flex_tpu_torch.reorder.rabbit import order_rabbit

    method = method.lower()
    if method == "ovo":
        return np.arange(g.m, dtype=np.int64)
    if method == "rabbit":
        return order_rabbit(g, **kwargs)
    if method == "rbdeg":
        _, labels = order_rabbit(g, want_labels=True, **kwargs)
        return np.lexsort((-g.degrees, labels)).astype(np.int64)
    raise ValueError(f"unknown ordering {method!r}; have {sorted(ORDER_ABBR)}")


def reorder(g: CSRGraph, method: str, check: bool = True, **kwargs) -> CSRGraph:
    """Compute an ordering and apply it (rows+cols permuted, rows re-sorted)."""
    perm = compute_order(g, method, **kwargs)
    return apply_vertex_order(g, perm, ORDER_ABBR[method.lower()], check=check)
