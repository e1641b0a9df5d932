"""Rabbit ordering: modularity-based clustering (host).

Copy of ``flex_tpu.reorder.rabbit.order_rabbit``: unit-weight undirected
multigraph (self-loops dropped, directed inputs mirrored); rounds visit
vertices in degree-ascending order and merge u into the neighbour v that
maximises ΔQ = w(u,v) − deg(u)·deg(v)/(2m); the order is the dendrogram's
leaves, clusters emitted in surviving-root index order.  The C++ version
in :mod:`flex_tpu_torch.reorder.native` runs when it builds; the Python
loop below is for small graphs without a toolchain.  :func:`modularity`
is the Newman modularity of a community assignment.
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph, repeat_arange


def order_rabbit(
    g: CSRGraph, max_rounds: int = 64, use_native: bool | None = None,
    want_labels: bool = False,
):
    """Rabbit permutation; with ``want_labels``, also returns
    labels[old_vertex] = cluster id in emission order."""
    n = g.m
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return (z, z.copy()) if want_labels else z

    from flex_tpu_torch.reorder import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        return native.order_rabbit_native(
            g.row_ptr, g.col, not g.pattern_is_symmetric, max_rounds,
            want_labels=want_labels,
        )

    adj: list[dict[int, int]] = [dict() for _ in range(n)]
    force_undirected = not g.pattern_is_symmetric
    rows = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    for u, d in zip(rows.tolist(), g.col.tolist()):
        if u == d:
            continue
        adj[u][d] = 1
        if force_undirected:
            adj[d][u] = 1

    deg = np.array([len(a) for a in adj], dtype=np.int64)
    n_edges = int(deg.sum())
    if n_edges == 0:
        ident = np.arange(n, dtype=np.int64)
        return (ident, ident.copy()) if want_labels else ident
    two_m_inv = 1.0 / (2.0 * n_edges)

    tree: list = list(range(n))  # dendrogram: nested tuples of vertex ids
    alive = np.ones(n, dtype=bool)
    round_of = np.zeros(n, dtype=np.int64)

    this_round = list(range(n))
    for rnd in range(1, max_rounds + 1):
        this_round.sort(key=lambda i: deg[i])
        next_round: list[int] = []
        for u in this_round:
            if not alive[u] or round_of[u] == rnd:
                continue
            au = adj[u]
            if not au:
                continue
            dv_2m = deg[u] * two_m_inv
            # argmax ΔQ over neighbours; ties prefer the smallest id, so
            # the C++ version (unordered_map) agrees
            best_dq, v = -1.0, -1
            for d, w in au.items():
                dq = w - deg[d] * dv_2m
                if dq > best_dq or (dq == best_dq and d < v):
                    best_dq, v = dq, d
            if best_dq <= 0 or v < 0:
                continue

            # merge u into v
            av = adj[v]
            deg[v] += deg[u]
            for d, w in au.items():
                if d == v:
                    continue
                av[d] = av.get(d, 0) + w
                ad = adj[d]
                if u in ad:
                    ad[v] = ad.get(v, 0) + ad.pop(u)
            av.pop(u, None)
            tree[v] = (tree[v], tree[u])
            tree[u] = None
            alive[u] = False

            if round_of[v] != rnd:
                round_of[v] = rnd
                next_round.append(v)
        if not next_round:
            break
        this_round = next_round

    # emit leaves: surviving clusters in vertex-index order, v's subtree
    # before u's within each dendrogram
    perm = np.empty(n, dtype=np.int64)
    labels = np.empty(n, dtype=np.int64)
    pos = 0
    cluster = -1
    for r in range(n):
        if not alive[r]:
            continue
        cluster += 1
        stack = [tree[r]]
        while stack:
            node = stack.pop()
            if isinstance(node, tuple):
                stack.append(node[1])
                stack.append(node[0])
            else:
                labels[node] = cluster
                perm[pos] = node
                pos += 1
    if pos != n:
        raise AssertionError(f"rabbit emitted {pos} of {n} vertices")
    return (perm, labels) if want_labels else perm


def modularity(g: CSRGraph, communities: np.ndarray) -> float:
    """Newman modularity of a community assignment on the undirected
    unit-weight version of g (a diagnostic: the reference prints Q after
    clustering)."""
    n = g.m
    rows = repeat_arange(g.degrees, total=g.nnz)
    cols = g.col.astype(np.int64)
    mask = rows != cols
    rows, cols = rows[mask], cols[mask]
    if not g.pattern_is_symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        keys = np.unique(rows * n + cols)
        rows, cols = keys // n, keys % n
    m2 = len(rows)
    if m2 == 0:
        return 0.0
    deg = np.bincount(rows, minlength=n)
    same = communities[rows] == communities[cols]
    e_in = same.sum() / m2
    dc = np.bincount(communities, weights=deg.astype(np.float64))
    exp = float((dc**2).sum()) / (m2 * m2)
    return float(e_in - exp)
