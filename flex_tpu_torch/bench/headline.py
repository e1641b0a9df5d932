"""The headline benchmark: Reddit-scale SpMM at k = 128, one JSON line.

Counterpart of the repository's ``bench.py`` (its worker and its final
line) on the port.  The graph is ``reddit_posts(seed=0)`` (232,965 rows,
23,446,803 nonzeros: Reddit's published size) ordered by rbdeg; the
method is the autotuner's choice, ``suggest(g, 128, win_min_count=64,
max_dense_bytes=6 GiB)``.  One cold prepare and call comes first (it
builds the hand kernels; its seconds go to stderr), then two more timed
builds for stderr (after ``torch.cuda.empty_cache()``, then warm), then
``bench_spmm(g, 128, method, iters=10, check=True)`` and the secondary
``ell`` row.

stdout is one JSON line: ``metric``, ``value`` (GF/s = 2·nnz·k / tElap),
``unit``, ``vs_baseline`` (against ASpT on an H100, 1237.25 GF/s),
``t_pre_s``, ``t_elap_ms``, ``pre_elap_ratio``, ``method``, ``err_frac``,
``model_elap_ratio`` (tElap over the autotuner's model of the method),
``secondary_ell_gflops``, ``secondary_ell_pre_ratio``, ``annotations``
when there are any, and ``device`` (the card's name and power limit as
nvidia-smi gives them).  A result beyond ``res_check``'s tolerance on more
than 1e-4 of its outputs reports value 0 with ``result-check-failed`` and
exits 1.  Everything else, each hand kernel's launch count from 0 last,
goes to stderr.

The TPU harness's workarounds have no counterpart: no worker process and
retry, no watchdogs, no calibration probes, no fallback method, no
serial-chain tElap.  Any
exception propagates and the process exits non-zero.  Runs on the card
unless called with ``main(device="cpu")``.

    python3 bench_torch.py
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from flex_tpu_torch.kernels import BUILD_DIR

METRIC = "spmm_effective_gflops_reddit_posts_k128"
BASELINE_GFLOPS = 1237.25  # ASpT on an H100, Reddit k=128 (BASELINE.md)
K = 128
ERR_LIMIT = 1e-4           # bench.py's acceptance of err_frac
MODEL_DIVERGENCE = 3.0     # tElap over the time model that gets annotated
EXPECT_M, EXPECT_NNZ = 232_965, 23_446_803

# the cache of the ordered graph, keyed by generator and ordering version
CACHE_VERSION = 1
GRAPH_NPZ = os.path.join(BUILD_DIR,
                         f"reddit_posts_rbdeg_v{CACHE_VERSION}.npz")
# the graph before ordering as a 3-line CSV (the name up to its first dot
# is the graph's name) and the rbdeg ordering file, for the command line
GRAPH_CSV = os.path.join(BUILD_DIR, "reddit_posts.csv")
GRAPH_PERM = os.path.join(BUILD_DIR,
                          f"reddit_posts_rbdeg_perm_v{CACHE_VERSION}.npy")

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def load_graph(csv: bool = False):
    """The headline's graph, reddit_posts(seed=0) ordered by rbdeg, cached
    under the build directory (:data:`GRAPH_NPZ`) with its rbdeg ordering
    file (:data:`GRAPH_PERM`).  With ``csv`` also the graph before ordering
    as a CSV (:data:`GRAPH_CSV`), written by ``save_csv`` and read back by
    ``load_csv``, whose row_ptr and col must equal the generated ones."""
    from flex_tpu_torch.io import load_csv, reddit_posts, save_csv
    from flex_tpu_torch.reorder import ORDER_ABBR, compute_order
    from flex_tpu_torch.reorder.inout import save_order
    from flex_tpu_torch.sparse.csr import CSRGraph
    from flex_tpu_torch.sparse.perm import apply_vertex_order

    g0 = None
    if os.path.exists(GRAPH_NPZ) and os.path.exists(GRAPH_PERM):
        d = np.load(GRAPH_NPZ)
        g = CSRGraph.from_arrays(d["row_ptr"], d["col"], d["vals"],
                                 name="reddit_posts", order="RBD")
        log(f"[graph] loaded {GRAPH_NPZ}")
    else:
        t0 = time.perf_counter()
        g0 = reddit_posts(seed=0)
        t1 = time.perf_counter()
        perm = compute_order(g0, "rbdeg")
        g = apply_vertex_order(g0, perm, ORDER_ABBR["rbdeg"], check=False)
        log(f"[graph] host: reddit_posts {t1 - t0:.1f}s, rbdeg "
            f"{time.perf_counter() - t1:.1f}s")
        os.makedirs(BUILD_DIR, exist_ok=True)
        save_order(perm, GRAPH_PERM)
        # written whole or not at all: the cache is read on its existence
        tmp = GRAPH_NPZ + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, row_ptr=g.row_ptr, col=g.col, vals=g.vals)
        os.replace(tmp, GRAPH_NPZ)
    if (g.m, g.nnz) != (EXPECT_M, EXPECT_NNZ):
        raise AssertionError(f"graph is {g.m} x {g.nnz} nnz, expected "
                             f"{EXPECT_M} x {EXPECT_NNZ}")
    if csv and not os.path.exists(GRAPH_CSV):
        if g0 is None:
            g0 = reddit_posts(seed=0)
        t0 = time.perf_counter()
        save_csv(g0, GRAPH_CSV)
        t1 = time.perf_counter()
        back = load_csv(GRAPH_CSV)
        if not (np.array_equal(back.row_ptr, g0.row_ptr)
                and np.array_equal(back.col, g0.col)):
            raise AssertionError("load_csv(save_csv(g)) changed row_ptr or "
                                 "col")
        log(f"[graph] save_csv {t1 - t0:.1f}s "
            f"({os.path.getsize(GRAPH_CSV) / 1e9:.3f} GB), load_csv "
            f"{time.perf_counter() - t1:.1f}s: row_ptr and col equal the "
            f"generated graph's; values within "
            f"{float(np.abs(back.vals - g0.vals).max()):.2e} ({{:g}} keeps "
            f"six digits)")
    return g


def final_line(res: dict) -> str:
    """The one stdout line, from the result dict of :func:`main`: the keys
    of ``bench.py``'s line (without its TPU probes) and ``device``."""
    out = {"metric": METRIC, "value": res["value"], "unit": "GFLOP/s",
           "vs_baseline": round(res["value"] / BASELINE_GFLOPS, 4)}
    for key in ("t_pre_s", "t_elap_ms", "pre_elap_ratio", "method",
                "err_frac", "model_elap_ratio", "secondary_ell_gflops",
                "secondary_ell_pre_ratio", "annotations", "device"):
        if key in res and res[key] not in (None, []):
            out[key] = res[key]
    return json.dumps(out)


def timed_prepare(prepare, g, csr, prep_kwargs):
    """(plan, seconds, allocator segments it added) of one build from the
    resident CSR, ended by a synchronise; no segment count off the card."""
    import torch

    from flex_tpu_torch.bench.harness import _sync

    dev = csr.device

    def segments():
        if dev.type != "cuda":
            return None
        return torch.cuda.memory_stats(dev)["segment.all.allocated"]

    _sync(dev)
    before = segments()
    t0 = time.perf_counter()
    plan = prepare(g, dev=csr, **prep_kwargs)
    _sync(dev)
    secs = time.perf_counter() - t0
    after = segments()
    return plan, secs, None if after is None else after - before


def main(device=None) -> int:
    """Run the headline on ``device`` (the card unless the caller names
    another), print its line, return the exit status: 1 when the result
    check failed, else 0."""
    import torch

    from flex_tpu_torch import kernels
    from flex_tpu_torch.bench.autotune import suggest
    from flex_tpu_torch.bench.harness import _sync, bench_spmm
    from flex_tpu_torch.ops import prepare_fn
    from flex_tpu_torch.sparse.device import DeviceCSR, resolve_device
    from flex_tpu_torch.utils.device_info import smi_query

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32
    kernels.reset_launch_counts()
    res: dict = {"annotations": []}
    if dev.type == "cuda":
        res["device"] = smi_query(dev.index or 0) or \
            torch.cuda.get_device_name(dev)
    else:
        res["device"] = dev.type
    log(f"device: {res['device']}")

    g = load_graph()
    log(f"graph ready: {g}")
    t0 = time.perf_counter()
    csr = DeviceCSR.from_graph(g, dev)
    _sync(dev)
    log(f"CSR upload: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    sug = suggest(g, K, win_min_count=64, max_dense_bytes=6 << 30)
    method, prep_kwargs = sug.method, dict(sug.prep_kwargs)
    log(f"suggest ({time.perf_counter() - t0:.1f}s host): {method} "
        f"({sug.reason})")

    # the cold pass: the first build in the process (the command line's
    # tPre is one), then the first launch of each kernel, which builds it
    prepare = prepare_fn(method)
    plan, t_first, segs_first = timed_prepare(prepare, g, csr, prep_kwargs)
    t0 = time.perf_counter()
    plan(torch.zeros((g.n, K), dtype=torch.float32, device=dev))
    _sync(dev)
    del plan
    log(f"cold call (kernel builds included): "
        f"{time.perf_counter() - t0:.1f}s")
    # the line's tPre is bench_spmm's: a build after one in the same
    # process, with the blocks that build freed held by the allocator.
    # Apart: the build with the allocator's cache emptied first, then warm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    plan, t_empty, segs_empty = timed_prepare(prepare, g, csr, prep_kwargs)
    del plan
    plan, t_warm, segs_warm = timed_prepare(prepare, g, csr, prep_kwargs)
    del plan
    log(f"tPre apart: first in the process {t_first:.4f}s "
        f"({segs_first} new allocator segments), after empty_cache "
        f"{t_empty:.4f}s ({segs_empty}), warm {t_warm:.4f}s ({segs_warm}); "
        f"the line's is a warm one")

    r = bench_spmm(g, K, method=method, iters=10, check=True, chain=False,
                   dev=csr, **prep_kwargs)
    if r.check.err_frac > ERR_LIMIT:
        log(f"result check failed: err_frac {r.check.err_frac} > "
            f"{ERR_LIMIT}; reporting 0")
        res["annotations"].append("result-check-failed")
        value = 0.0
    else:
        value = round(r.gflops, 2)
    res.update({
        "value": value,
        "t_pre_s": round(r.t_pre, 4),
        "t_elap_ms": round(r.t_elap * 1e3, 4),
        "pre_elap_ratio": round(r.pre_ratio, 2),
        "method": method,
        "err_frac": r.check.err_frac,
    })
    log(f"headline: tPre={r.t_pre:.4f}s tElap={r.t_elap * 1e3:.4f}ms "
        f"gflops={r.gflops:.1f} pre/elap={r.pre_ratio:.2f} "
        f"err_frac={r.check.err_frac} extra={r.extra}")

    model_t = (sug.model or {}).get(method)
    if model_t:
        ratio = r.t_elap / model_t
        res["model_elap_ratio"] = round(ratio, 2)
        if ratio > MODEL_DIVERGENCE:
            res["annotations"].append(
                f"model-divergence:{ratio:.1f}x-slower-than-time-model")

    # the secondary row: the ELL plan, a sub-second build for one-shot runs
    r2 = bench_spmm(g, K, method="ell", iters=10, check=False, chain=False,
                    dev=csr)
    log(f"[secondary] ell: tPre={r2.t_pre:.4f}s tElap="
        f"{r2.t_elap * 1e3:.4f}ms gflops={r2.gflops:.1f} "
        f"pre/elap={r2.pre_ratio:.2f}")
    res["secondary_ell_gflops"] = round(r2.gflops, 1)
    res["secondary_ell_pre_ratio"] = round(r2.pre_ratio, 2)

    log(f"kernel launches: {json.dumps(kernels.launch_counts())}")
    print(final_line(res), flush=True)
    return 1 if "result-check-failed" in res["annotations"] else 0
