"""Vertex orderings (host).  Every function returns ``perm`` with
``perm[new_id] = old_id``.

  - ``ovo``    — original vertex order (identity).
  - ``deg``    — degree sort, descending (:mod:`.deg`).
  - ``rcm``    — reverse Cuthill–McKee (:mod:`.rcm`).
  - ``dfs``    — DFS preorder renumbering (:mod:`.dfs`).
  - ``gorder`` — sliding-window locality ordering (:mod:`.gorder`).
  - ``rabbit`` — modularity clustering (:mod:`.rabbit`).
  - ``rbdeg``  — rabbit clusters contiguous, vertices degree-descending
                 inside each cluster: concentrates every cluster's
                 high-degree columns into a few aligned column blocks,
                 which the windowed format turns into dense tiles.

dfs, gorder and rabbit run their C++ versions (:mod:`.native`) when they
build, else the Python loops.
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.perm import apply_vertex_order

ORDER_ABBR = {
    "ovo": "OVO",
    "deg": "DEG",
    "rcm": "RCM",
    "dfs": "DFS",
    "gorder": "GOR",
    "rabbit": "RBT",
    "rbdeg": "RBD",
}


def compute_order(g: CSRGraph, method: str, **kwargs) -> np.ndarray:
    """Return perm[new] = old for the requested ordering."""
    method = method.lower()
    if method == "ovo":
        return np.arange(g.m, dtype=np.int64)
    if method == "deg":
        from flex_tpu_torch.reorder.deg import order_deg

        return order_deg(g, **kwargs)
    if method == "rcm":
        from flex_tpu_torch.reorder.rcm import order_rcm

        return order_rcm(g, **kwargs)
    if method == "dfs":
        from flex_tpu_torch.reorder.dfs import order_dfs

        return order_dfs(g, **kwargs)
    if method == "gorder":
        from flex_tpu_torch.reorder.gorder import order_gorder

        return order_gorder(g, **kwargs)
    if method == "rabbit":
        from flex_tpu_torch.reorder.rabbit import order_rabbit

        return order_rabbit(g, **kwargs)
    if method == "rbdeg":
        from flex_tpu_torch.reorder.rabbit import order_rabbit

        _, labels = order_rabbit(g, want_labels=True, **kwargs)
        return np.lexsort((-g.degrees, labels)).astype(np.int64)
    raise ValueError(f"unknown ordering {method!r}; have {sorted(ORDER_ABBR)}")


def reorder(g: CSRGraph, method: str, check: bool = True, **kwargs) -> CSRGraph:
    """Compute an ordering and apply it (rows+cols permuted, rows re-sorted)."""
    perm = compute_order(g, method, **kwargs)
    return apply_vertex_order(g, perm, ORDER_ABBR[method.lower()], check=check)
