"""Gorder: sliding-window graph ordering (Wei et al., SIGMOD'16), host.

Copy of ``flex_tpu.reorder.gorder``: an RCM pre-pass, the bidirected
adjacency in the RCM label space, then a greedy max-priority order where a
candidate's priority counts, over the last ``window`` ordered vertices u,
direct edges u→v ("child"), v→u ("parent") and shared in-neighbours
("sibling"), all unit-weighted.  Vertices of out-degree > sqrt(n) ("huge")
are skipped when fanning out updates, which bounds the cost.

This is the pure-Python version; :mod:`flex_tpu_torch.reorder.native`
provides the C++ one used for large graphs.
"""
from __future__ import annotations

import heapq

import numpy as np

from flex_tpu_torch.reorder.rcm import order_rcm
from flex_tpu_torch.sparse.csr import CSRGraph, repeat_arange
from flex_tpu_torch.sparse.perm import invert_permutation


def _relabel_csr(row_ptr, col, old_to_new, n):
    """Rebuild CSR under a relabeling: neighbor lists sorted ascending and
    DEDUPED — gorder's locality counts are unit-weighted, and deduping
    here makes the C++ native's sorted-list merges and the Python
    fallback's set() semantics see the identical simple graph (they
    diverged on multigraphs otherwise)."""
    deg = np.diff(row_ptr)
    new_rows = old_to_new[repeat_arange(deg)]
    new_cols = old_to_new[col]
    order = np.lexsort((new_cols, new_rows))
    new_rows, new_cols = new_rows[order], new_cols[order]
    if len(new_rows):
        keep = np.r_[True, (np.diff(new_rows) != 0)
                     | (np.diff(new_cols) != 0)]
        new_rows, new_cols = new_rows[keep], new_cols[keep]
    rp = np.zeros(n + 1, dtype=np.int64)
    # bincount over np.add.at per the host-pass rules
    rp[1:] = np.bincount(new_rows, minlength=n)
    np.cumsum(rp, out=rp)
    return rp, new_cols


def order_gorder(g: CSRGraph, window: int = 3, use_native: bool | None = None) -> np.ndarray:
    """Return perm[new] = old. ``window=3`` matches ``DataLoader.cu:808``."""
    n = g.m
    if n == 0:
        return np.zeros(0, dtype=np.int64)

    # RCM pre-pass (complete_gorder, order_gorder.cu:13-31).
    perm_rcm = order_rcm(g)  # new->old
    rank_rcm = invert_permutation(perm_rcm)  # old->new

    # Bidirected adjacency in RCM space.
    out_rp, out_col = _relabel_csr(g.row_ptr, g.col.astype(np.int64), rank_rcm, n)
    # in-adjacency = transpose
    in_rp, in_col = _relabel_csr(
        *_transpose_csr(g.row_ptr, g.col.astype(np.int64), n), rank_rcm, n
    )

    from flex_tpu_torch.reorder import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        order_arr = native.order_gorder_native(
            out_rp, out_col.astype(np.int32), in_rp, in_col.astype(np.int32), window
        )
        return perm_rcm[order_arr]

    deg_out = np.diff(out_rp)
    deg_in = np.diff(in_rp)
    deg_total = deg_out + deg_in
    huge = int(np.sqrt(n))

    key = deg_in.astype(np.int64).copy()  # initial priority = in-degree
    placed = np.zeros(n, dtype=bool)

    # Lazy max-heap: stale entries skipped at pop time.
    heap = [(-key[u], u) for u in range(n) if deg_total[u] > 0]
    heapq.heapify(heap)
    isolates = [u for u in range(n) if deg_total[u] == 0]

    order: list[int] = []

    def out_n(u):
        return out_col[out_rp[u] : out_rp[u + 1]]

    def in_n(u):
        return in_col[in_rp[u] : in_rp[u + 1]]

    def bump(nodes, delta):
        # Push on every change (also decrements): the lazy heap only ever
        # yields a node whose popped key equals its current key, so a
        # decremented node must have a fresh entry to stay reachable.
        for v in nodes:
            if not placed[v]:
                key[v] += delta
                heapq.heappush(heap, (-key[v], v))

    def window_update(new_node, old_node):
        """move_window (order_gorder.cu:88-143)."""
        if old_node != new_node:
            if deg_out[old_node] <= huge:
                bump(out_n(old_node), -1)
        # Partition parents into (old-only, new-only); common parents ignored.
        op = set(in_n(old_node).tolist()) if old_node != new_node else set()
        np_ = set(in_n(new_node).tolist())
        common = op & np_
        for parent in op - common:
            if deg_out[parent] > huge:
                continue
            bump([parent], -1)
            bump([s for s in out_n(parent) if s != old_node], -1)
        if deg_out[new_node] <= huge:
            bump(out_n(new_node), +1)
        for parent in np_ - common:
            if deg_out[parent] > huge:
                continue
            bump([parent], +1)
            bump([s for s in out_n(parent) if s != new_node], +1)

    def extract_max():
        while heap:
            negk, u = heapq.heappop(heap)
            if placed[u] or -negk != key[u]:
                continue
            return u
        return -1

    hub = extract_max()
    if hub >= 0:
        placed[hub] = True
        order.append(hub)
        window_update(hub, hub)
        while True:
            u = extract_max()
            if u < 0:
                break
            placed[u] = True
            order.append(u)
            old = order[-window - 1] if len(order) > window else u
            window_update(u, old)

    order.extend(isolates)
    assert len(order) == n

    # order[] is in RCM label space; compose back to original vertex ids.
    return perm_rcm[np.asarray(order, dtype=np.int64)]


def _transpose_csr(row_ptr, col, n):
    deg = np.diff(row_ptr)
    rows = repeat_arange(deg)
    order = np.lexsort((rows, col))
    t_rows = col[order]
    t_cols = rows[order]
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, t_rows + 1, 1)
    np.cumsum(rp, out=rp)
    return rp, t_cols
