"""DFS preorder renumbering (host).

Copy of ``flex_tpu.reorder.dfs``: an iterative depth-first search from
vertex 0 hands out new ids in discovery order, restarting at the
lowest-numbered unvisited vertex for each new component.  The C++
version in :mod:`flex_tpu_torch.reorder.native` runs when it builds.
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def order_dfs(g: CSRGraph, use_native: bool | None = None) -> np.ndarray:
    from flex_tpu_torch.reorder import native

    n = g.m
    row_ptr = g.row_ptr
    col = g.col
    if use_native is None:
        use_native = native.available()
    if use_native:
        return native.order_dfs_native(row_ptr, col)
    visited = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)  # perm[new] = old
    nxt = 0  # next new id to hand out

    root = 0
    # the stack holds (vertex, edge cursor) pairs
    stack_v = np.empty(n, dtype=np.int64)
    stack_e = np.empty(n, dtype=np.int64)
    while nxt < n:
        visited[root] = True
        perm[nxt] = root
        nxt += 1
        top = 0
        stack_v[0] = root
        stack_e[0] = row_ptr[root]
        while top >= 0:
            v = stack_v[top]
            e = stack_e[top]
            end = row_ptr[v + 1]
            # advance to the first unvisited neighbour
            while e < end and visited[col[e]]:
                e += 1
            if e == end:
                top -= 1
                continue
            stack_e[top] = e + 1
            d = col[e]
            visited[d] = True
            perm[nxt] = d
            nxt += 1
            top += 1
            stack_v[top] = d
            stack_e[top] = row_ptr[d]
        if nxt >= n:
            break
        while root < n and visited[root]:
            root += 1
    return perm
