"""Synthetic graph generators (host, NumPy).

Copy of the generators of ``flex_tpu.io.synth`` that the ported SpMM
strategies and their tests use.  The same seed gives the same arrays as
the JAX package.

- :func:`rmat_graph` — R-MAT / Kronecker power-law graphs.
- :func:`uniform_graph` — uniform sparsity (what band and windowed refuse).
- :func:`banded_graph` — diagonal-band sparsity (the band strategy's case).
- :func:`community_graph`, :func:`bipartite_projection_graph`,
  :func:`reddit_posts` — community graphs (the windowed strategy's case).
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def _dedupe_coo(rows, cols, m):
    keys = rows.astype(np.int64) * m + cols
    keys = np.unique(keys)
    return keys // m, keys % m


def _trim_to_csr(rows, cols, nnz_target, m, rng, name) -> CSRGraph:
    """Deduplicate, thin to ``nnz_target`` entries and draw the values:
    the common tail of the three plain generators."""
    rows, cols = _dedupe_coo(rows, cols, m)
    if len(rows) > nnz_target:
        sel = rng.choice(len(rows), nnz_target, replace=False)
        sel.sort()
        rows, cols = rows[sel], cols[sel]
    vals = (2.0 * rng.random(len(rows)) - 1.0).astype(np.float32)
    return CSRGraph.from_coo(rows, cols, vals, m, name=name)


def rmat_graph(
    m: int,
    nnz_target: int,
    a: float = 0.45,
    b: float = 0.22,
    c: float = 0.22,
    seed: int = 0,
    name: str = "rmat",
) -> CSRGraph:
    """R-MAT (Chakrabarti et al., SDM'04) generator, with a skew softer
    than Graph500's (0.57/0.19/0.19), nearer the GNN benchmark graphs."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(m, 2))))
    n_samples = int(nnz_target * 1.15) + 16  # oversample to survive dedupe

    rows = np.zeros(n_samples, dtype=np.int64)
    cols = np.zeros(n_samples, dtype=np.int64)
    p_ab = a + b
    p_abc = a + b + c
    for _ in range(scale):
        r = rng.random(n_samples)
        # quadrants: a=[0,a) top-left, b=[a,a+b) top-right (sets the column
        # bit), c=[a+b,a+b+c) bottom-left (sets the row bit), d=rest (both)
        right = ((r >= a) & (r < p_ab)) | (r >= p_abc)
        down = r >= p_ab
        rows = rows * 2 + down
        cols = cols * 2 + right

    keep = (rows < m) & (cols < m)
    return _trim_to_csr(rows[keep], cols[keep], nnz_target, m, rng, name)


def uniform_graph(m: int, nnz_target: int, seed: int = 0,
                  name: str = "uniform") -> CSRGraph:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, int(nnz_target * 1.1) + 16)
    cols = rng.integers(0, m, len(rows))
    return _trim_to_csr(rows, cols, nnz_target, m, rng, name)


def banded_graph(m: int, bandwidth: int, avg_degree: float, seed: int = 0,
                 name: str = "banded") -> CSRGraph:
    """Edges concentrated within ±bandwidth of the diagonal."""
    rng = np.random.default_rng(seed)
    nnz_target = int(m * avg_degree)
    rows = rng.integers(0, m, int(nnz_target * 1.2) + 16)
    off = rng.integers(-bandwidth, bandwidth + 1, len(rows))
    cols = np.clip(rows + off, 0, m - 1)
    return _trim_to_csr(rows, cols, nnz_target, m, rng, name)

def community_graph(
    m: int,
    nnz_target: int,
    n_comm: int = 41,
    intra_frac: float = 0.76,
    deg_sigma: float = 1.3,
    max_degree: int | None = None,
    comm_zipf: float = 0.8,
    seed: int = 0,
    name: str = "community",
    shuffle: bool = True,
) -> CSRGraph:
    """Degree-corrected planted-partition (SBM) generator: a symmetric
    graph with self-loops, heavy-tailed degrees and ``n_comm`` Zipf-sized
    communities, where an ``intra_frac`` fraction of edge endpoints stay
    inside the source node's community.  Node ids are shuffled when
    ``shuffle`` so a reordering pass must rediscover the communities."""
    rng = np.random.default_rng(seed)
    # communities: Zipf sizes, contiguous blocks before the shuffle
    sizes = (np.arange(1, n_comm + 1, dtype=np.float64)) ** (-comm_zipf)
    sizes = np.maximum((sizes / sizes.sum() * m).astype(np.int64), 1)
    sizes[0] += m - sizes.sum()  # exact total
    comm_of = np.repeat(np.arange(n_comm), sizes)  # node -> community
    comm_start = np.concatenate([[0], np.cumsum(sizes)])

    # heavy-tailed Chung-Lu weights
    w = rng.lognormal(mean=0.0, sigma=deg_sigma, size=m)
    if max_degree is None:
        max_degree = max(int(nnz_target / m * 200), 64)
    avg_und = max((nnz_target - m) // 2, 1) / m  # undirected edges per node
    w *= avg_und / w.mean()
    w = np.minimum(w, max_degree / 2)

    # sample undirected edges (u, v), u != v
    E = max((nnz_target - m) // 2, 1)
    cumw = np.cumsum(w)
    total_w = cumw[-1]
    comm_cumw = [np.cumsum(w[comm_start[c]:comm_start[c + 1]])
                 for c in range(n_comm)]

    def draw_global(size):
        return np.searchsorted(cumw, rng.random(size) * total_w)

    def sample_pairs(n_samp):
        u = draw_global(n_samp)
        v = np.empty(n_samp, dtype=np.int64)
        intra = rng.random(n_samp) < intra_frac
        v[~intra] = draw_global(int((~intra).sum()))
        # intra endpoints: degree-weighted draw restricted to comm(u)
        cu = comm_of[u]
        for c in range(n_comm):
            sel = np.where(intra & (cu == c))[0]
            if not len(sel):
                continue
            cw = comm_cumw[c]
            v[sel] = comm_start[c] + np.searchsorted(
                cw, rng.random(len(sel)) * cw[-1])
        keep = u != v
        u, v = u[keep], v[keep]
        return np.minimum(u, v) * m + np.maximum(u, v)

    # top up until E unique pairs (intra sampling collides in small
    # dense communities)
    pair = np.unique(sample_pairs(int(E * 1.25) + 16))
    for _ in range(8):
        if len(pair) >= E:
            break
        extra = sample_pairs(int((E - len(pair)) * 2.5) + 16)
        pair = np.unique(np.concatenate([pair, extra]))
    if len(pair) > E:
        sel = rng.choice(len(pair), E, replace=False)
        sel.sort()
        pair = pair[sel]
    return _sym_from_pairs(pair, m, rng, shuffle, name)


def _sym_from_pairs(pair, m, rng, shuffle, name) -> CSRGraph:
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
    return CSRGraph.from_coo(rows, cols, vals, m, name=name)


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
    name: str = "biproj",
    shuffle: bool = True,
) -> CSRGraph:
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
    return _sym_from_pairs(pair, m, rng, shuffle, name)


def reddit_posts(seed: int = 0) -> CSRGraph:
    """Reddit stand-in: bipartite user→post projection with the dataset's
    exact size (232,965 nodes, 23,446,803 nnz = 11,606,919 undirected
    edges x2 + self-loops), 41 communities and (1-cross)^2 ≈ 0.76 edge
    homophily."""
    return bipartite_projection_graph(
        232_965, 23_446_803, n_comm=41, cross=0.128,
        act_mean=6.0, act_sigma=0.9, act_max=256, pop_sigma=1.5,
        seed=seed, name="reddit_posts",
    )
