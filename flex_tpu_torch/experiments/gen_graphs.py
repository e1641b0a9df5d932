"""Make and order the headline's proxy graphs once, into the build cache.

Counterpart of ``experiments/gen_graphs.py``.  For every graph of
``io.synth`` named in ``graphs`` (made with seed 0) and every ordering in
``orders`` (``"ovo"`` keeps the generated order), the ordered graph is
written to ``<cache_dir>/<graph>_<order>_v<version>.npz`` (row_ptr, col,
vals) with its ordering next to it (``..._perm_v<version>.npy``), each
written whole or not at all.  A cache that is already there is not
rebuilt.  reddit_posts × rbdeg is the headline's own file
(:data:`..bench.headline.GRAPH_NPZ`), which ``load_graph`` reads.  The
script wrote ``/tmp`` npz files and pinned JAX to the CPU; the port keeps
its graphs in its build directory, and the work is host work.

    python -m flex_tpu_torch.experiments.gen_graphs [graph ...] [order ...]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from flex_tpu_torch.bench.headline import CACHE_VERSION
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.io import synth
from flex_tpu_torch.kernels import BUILD_DIR
from flex_tpu_torch.sparse.device import resolve_device

GRAPHS = ("reddit_posts", "reddit_comm")
ORDERS = ("rbdeg", "deg")


def cache_path(graph: str, order: str, cache_dir: str = BUILD_DIR) -> str:
    return os.path.join(cache_dir, f"{graph}_{order}_v{CACHE_VERSION}.npz")


def perm_path(graph: str, order: str, cache_dir: str = BUILD_DIR) -> str:
    return os.path.join(cache_dir,
                        f"{graph}_{order}_perm_v{CACHE_VERSION}.npy")


def load(graph: str, order: str, cache_dir: str = BUILD_DIR):
    """The cached ordered graph as a CSRGraph."""
    from flex_tpu_torch.reorder import ORDER_ABBR
    from flex_tpu_torch.sparse.csr import CSRGraph

    d = np.load(cache_path(graph, order, cache_dir))
    return CSRGraph.from_arrays(
        d["row_ptr"], d["col"], d["vals"], name=graph,
        order=ORDER_ABBR.get(order, order.upper()))


def _write(path: str, save) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        save(f)
    os.replace(tmp, path)


def build(g, order: str, graph: str, cache_dir: str = BUILD_DIR) -> None:
    """Order ``g`` by ``order`` and write the cache and the ordering."""
    from flex_tpu_torch.reorder import ORDER_ABBR, compute_order
    from flex_tpu_torch.sparse.perm import apply_vertex_order

    if order == "ovo":
        go, perm = g, np.arange(g.m)
    else:
        perm = compute_order(g, order)
        go = apply_vertex_order(g, perm, ORDER_ABBR[order], check=False)
    os.makedirs(cache_dir, exist_ok=True)
    # the ordering as reorder.inout.save_order writes it
    _write(perm_path(graph, order, cache_dir),
           lambda f: np.save(f, np.asarray(perm, dtype=np.int64)))
    _write(cache_path(graph, order, cache_dir),
           lambda f: np.savez(f, row_ptr=go.row_ptr, col=go.col,
                              vals=go.vals))


def cached(graph: str, order: str, cache_dir: str = BUILD_DIR):
    """The cached ordered graph, made first when the cache lacks it."""
    if not os.path.exists(cache_path(graph, order, cache_dir)):
        build(getattr(synth, graph)(seed=0), order, graph, cache_dir)
    return load(graph, order, cache_dir)


def main(graphs=GRAPHS, orders=ORDERS, cache_dir: str = BUILD_DIR,
         device=None) -> dict:
    """Write every (graph, order) cache that is missing.  Returns
    (graph, order) -> "cached" or the seconds its ordering took."""
    p(banner(resolve_device(device)))
    out = {}
    for gname in graphs:
        todo = [o for o in orders if not os.path.exists(
            cache_path(gname, o, cache_dir)) or not os.path.exists(
            perm_path(gname, o, cache_dir))]
        for o in orders:
            if o not in todo:
                out[(gname, o)] = "cached"
                p(f"{gname} {o}: cached -> {cache_path(gname, o, cache_dir)}")
        if not todo:
            continue
        t0 = time.time()
        g = getattr(synth, gname)(seed=0)
        p(f"{gname}: m={g.m} nnz={g.nnz} gen={time.time()-t0:.0f}s")
        for o in todo:
            t0 = time.time()
            build(g, o, gname, cache_dir)
            out[(gname, o)] = time.time() - t0
            p(f"  {o}: {time.time()-t0:.0f}s -> "
              f"{cache_path(gname, o, cache_dir)}")
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    main(tuple(a for a in args if hasattr(synth, a)) or GRAPHS,
         tuple(a for a in args if not hasattr(synth, a)) or ORDERS)
