"""The configuration's graph and the port's ordering of it, cached in the
benchmark's ``cache/`` directory inside the checkout.

- The graph comes from the frozen generator copy (:mod:`.data.synth`) and
  is cached under a key of that copy's source and the generator's
  parameters.
- The ordering is the port's (``reorder.compute_order``), the file a user
  keeps beside the graph.  It is cached under a key of the port's
  ``reorder/`` sources, the graph's key and the ordering's name, so a
  change to the ordering code makes it anew.
- The autotuner's choice (``bench.autotune.suggest``: the method and its
  keyword arguments), which a user also makes once for a graph.  It is
  cached under a key of all the port's Python sources, the ordering's
  key and ``suggest``'s arguments, so any change to the program makes it
  anew.

Each file is written whole or not at all (a temporary name in the same
directory, then a rename), and read on its existence.  Only a checkout's
first run pays for them.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import time

import numpy as np

from spmm_bench.data import synth

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(BENCH_DIR, "cache")


def _hash_files(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _atomic_save(path: str, write) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def graph_key(spec: dict) -> str:
    """The cache key of a configuration's graph: the generator copy's
    source and the generator's name and parameters."""
    h = hashlib.sha256(_hash_files([synth.__file__]).encode())
    h.update(json.dumps([spec["generator"], spec["params"]],
                        sort_keys=True).encode())
    return h.hexdigest()[:16]


def load_graph(spec: dict, log, cache_dir: str = CACHE_DIR):
    """(row_ptr, col, vals) of the configuration's graph (``spec`` is its
    ``graph`` entry), from the cache or made and cached."""
    path = os.path.join(cache_dir, f"graph-{graph_key(spec)}.npz")
    if os.path.exists(path):
        with np.load(path) as d:
            arrs = d["row_ptr"], d["col"], d["vals"]
        log(f"[graph] read from the cache: {path}")
    else:
        t0 = time.perf_counter()
        arrs = synth.GENERATORS[spec["generator"]](**spec["params"])
        _atomic_save(path, lambda f: np.savez(
            f, row_ptr=arrs[0], col=arrs[1], vals=arrs[2]))
        log(f"[graph] made in {time.perf_counter() - t0:.1f}s, cached: "
            f"{path}")
    m, nnz = len(arrs[0]) - 1, len(arrs[1])
    if (m, nnz) != (spec["nodes"], spec["nnz"]):
        raise RuntimeError(f"graph is {m} nodes, {nnz} nonzeros; the "
                           f"configuration states {spec['nodes']}, "
                           f"{spec['nnz']}")
    return arrs


def order_key(spec: dict, order: str) -> str:
    """The cache key of the port's ordering of a graph."""
    import flex_tpu_torch.reorder as reorder

    root = os.path.dirname(os.path.abspath(reorder.__file__))
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith((".py", ".cc", ".h"))]
    h = hashlib.sha256(_hash_files(files).encode())
    h.update(f"{graph_key(spec)}:{order}".encode())
    return h.hexdigest()[:16]


def port_order(g, spec: dict, order: str, log,
               cache_dir: str = CACHE_DIR) -> np.ndarray:
    """perm[new] = old of the port's ``order`` for the port's graph ``g``,
    from the cache or computed by ``reorder.compute_order`` and cached."""
    from flex_tpu_torch.reorder import compute_order

    path = os.path.join(cache_dir, f"order-{order}-{order_key(spec, order)}"
                                   f".npy")
    if os.path.exists(path):
        perm = np.load(path)
        log(f"[order] read from the cache: {path}")
    else:
        t0 = time.perf_counter()
        perm = np.asarray(compute_order(g, order), dtype=np.int64)
        _atomic_save(path, lambda f: np.save(f, perm))
        log(f"[order] {order} in {time.perf_counter() - t0:.1f}s, cached: "
            f"{path}")
    return perm


def _package_dir() -> str:
    import flex_tpu_torch

    return os.path.dirname(os.path.abspath(flex_tpu_torch.__file__))


def suggest_key(cfg: dict) -> str:
    """The cache key of the autotuner's choice for a configuration."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(_package_dir())
             for f in fs if f.endswith(".py")]
    h = hashlib.sha256(_hash_files(files).encode())
    h.update(order_key(cfg["graph"], cfg["order"]).encode())
    h.update(json.dumps(cfg["suggest"], sort_keys=True).encode())
    return h.hexdigest()[:16]


def port_suggest(g, cfg: dict, log, cache_dir: str = CACHE_DIR):
    """(method, keyword arguments) of ``bench.autotune.suggest`` on the
    ordered graph ``g`` with the configuration's arguments, from the cache
    or chosen and cached."""
    from flex_tpu_torch.bench.autotune import suggest

    path = os.path.join(cache_dir, f"suggest-{suggest_key(cfg)}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            method, kwargs, reason = pickle.load(f)
        log(f"[suggest] read from the cache: {path}: {method} ({reason})")
        return method, kwargs
    t0 = time.perf_counter()
    sug = suggest(g, **cfg["suggest"])
    method, kwargs = sug.method, dict(sug.prep_kwargs)
    _atomic_save(path, lambda f: pickle.dump((method, kwargs, sug.reason),
                                             f))
    log(f"[suggest] {method} in {time.perf_counter() - t0:.1f}s, cached: "
        f"{path} ({sug.reason})")
    return method, kwargs
