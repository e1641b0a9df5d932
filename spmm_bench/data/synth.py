"""Frozen copy of the port's graph generator (``io/synth.py``).

The benchmark makes its graphs with this copy, so that a change to the
program cannot change the yardstick.  ``bipartite_projection_graph`` and
its helpers are copied line for line; the result is three NumPy arrays
(row_ptr int64, col int32, vals float32) in place of the port's
``CSRGraph``, with the same values.  ``tests/test_spmm_bench_data.py``
holds the copy to the port's arrays at small sizes.

Generators are found by name (:data:`GENERATORS`); a configuration file
names one and gives its keyword arguments.
"""
from __future__ import annotations

import numpy as np


def csr_from_coo(rows, cols, vals, m):
    """(row_ptr int64[m+1], col int32[nnz], vals float32[nnz]): entries
    sorted by row, then column, as the port's ``CSRGraph.from_coo``."""
    rows = np.asarray(rows, dtype=np.int64)
    order_idx = np.lexsort((np.asarray(cols), rows))
    rows, cols, vals = (rows[order_idx], np.asarray(cols)[order_idx],
                        np.asarray(vals)[order_idx])
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    row_ptr[1:] = np.bincount(rows, minlength=m)
    np.cumsum(row_ptr, out=row_ptr)
    return (row_ptr, np.asarray(cols, dtype=np.int32),
            np.asarray(vals, dtype=np.float32))


def _sym_from_pairs(pair, m, rng, shuffle):
    """Unordered pair keys (a*m+b) → symmetric CSR with unit self-loops and
    identical values in both directions."""
    a, b = pair // m, pair % m
    pv = (2.0 * rng.random(len(pair)) - 1.0).astype(np.float32)
    rows = np.concatenate([a, b, np.arange(m)])
    cols = np.concatenate([b, a, np.arange(m)])
    vals = np.concatenate([pv, pv, np.ones(m, np.float32)])
    if shuffle:
        perm = rng.permutation(m)
        rows, cols = perm[rows], perm[cols]
    return csr_from_coo(rows, cols, vals, m)


def bipartite_projection_graph(
    m: int,
    nnz_target: int,
    n_comm: int = 41,
    cross: float = 0.128,
    act_mean: float = 6.0,
    act_sigma: float = 0.9,
    act_max: int = 256,
    pop_sigma: float = 1.5,
    comm_zipf: float = 0.8,
    seed: int = 0,
    shuffle: bool = True,
):
    """Union-of-cliques graph from a bipartite user→post projection — the
    documented generative process of the Reddit GNN dataset (posts linked
    when the same user comments on both).  Posts belong to ``n_comm``
    Zipf-sized communities with lognormal popularity; each user has a
    lognormal activity and a home community, and comments outside it with
    probability ``cross``.  Users are added until the unique-pair count
    reaches the undirected-edge target, then trimmed."""
    rng = np.random.default_rng(seed)
    sizes = (np.arange(1, n_comm + 1, dtype=np.float64)) ** (-comm_zipf)
    sizes = np.maximum((sizes / sizes.sum() * m).astype(np.int64), 1)
    sizes[0] += m - sizes.sum()
    comm_start = np.concatenate([[0], np.cumsum(sizes)])

    w = rng.lognormal(0.0, pop_sigma, m)  # post popularity
    cumw_all = np.cumsum(w)
    comm_cumw = [np.cumsum(w[comm_start[c]:comm_start[c + 1]])
                 for c in range(n_comm)]
    comm_w_tot = np.array([cw[-1] for cw in comm_cumw])
    comm_p = comm_w_tot / comm_w_tot.sum()

    E = max((nnz_target - m) // 2, 1)
    # expected unique pairs per user ≈ E[a(a-1)]/2 before dedup; start
    # below target and top up
    mean_pairs = float(np.mean(
        (a := np.clip(rng.lognormal(np.log(act_mean), act_sigma, 4096),
                      2, act_max).astype(np.int64)) * (a - 1) / 2))
    batch_users = max(int(E * 0.7 / mean_pairs), 64)

    def user_batch(U):
        a = np.clip(rng.lognormal(np.log(act_mean), act_sigma, U),
                    2, act_max).astype(np.int64)
        home = rng.choice(n_comm, U, p=comm_p)
        T = int(a.sum())
        user_of = np.repeat(np.arange(U), a)
        is_cross = rng.random(T) < cross
        draws = np.empty(T, np.int64)
        n_cross = int(is_cross.sum())
        draws[is_cross] = np.searchsorted(
            cumw_all, rng.random(n_cross) * cumw_all[-1])
        hc = home[user_of]
        for c in range(n_comm):
            sel = np.where(~is_cross & (hc == c))[0]
            if not len(sel):
                continue
            cw = comm_cumw[c]
            draws[sel] = comm_start[c] + np.searchsorted(
                cw, rng.random(len(sel)) * cw[-1])
        # expand each user's posts into clique pairs, grouped by activity
        starts = np.concatenate([[0], np.cumsum(a)])
        out = []
        for av in np.unique(a):
            us = np.where(a == av)[0]
            mat = draws[starts[us][:, None] + np.arange(av)[None, :]]
            iu, ju = np.triu_indices(av, 1)
            p1, p2 = mat[:, iu].ravel(), mat[:, ju].ravel()
            keep = p1 != p2
            out.append(np.minimum(p1, p2)[keep] * m
                       + np.maximum(p1, p2)[keep])
        return np.concatenate(out)

    pair = np.unique(user_batch(batch_users))
    for _ in range(12):
        if len(pair) >= E:
            break
        need = E - len(pair)
        more = user_batch(max(int(batch_users * need / max(E, 1) * 1.3), 64))
        pair = np.unique(np.concatenate([pair, more]))
    if len(pair) > E:
        sel = rng.choice(len(pair), E, replace=False)
        sel.sort()
        pair = pair[sel]
    return _sym_from_pairs(pair, m, rng, shuffle)


GENERATORS = {"bipartite_projection_graph": bipartite_projection_graph}
