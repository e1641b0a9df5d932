"""Round-3 (tm, W, mc, G, step_order, dense cap) sweep of the windowed
hybrid on the headline graph.

Counterpart of ``experiments/sweep_windowed_r3.py``: its six ``CONFIGS``
(the dense cap's capacity frontier at tm 256 and 128, then taller panels
of 512 rows) on reddit_posts rbdeg (:func:`..bench.headline.load_graph`),
k = 128, B standard normal (NumPy seed 0).  One plan lives at a time: each
is built cold (tPre, ended by a synchronise), called once, timed over 20
calls with its residue alone, then freed with the card's cache emptied
before the next.  A config the build refuses prints the script's
``FAILED`` line and is returned under ``"failed"``.  The script's ``/tmp``
npz and compile-cache configuration are dropped.

    python -m flex_tpu_torch.experiments.sweep_windowed_r3
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from flex_tpu_torch.bench.harness import _sync, time_ms
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.ops.window_spmm import prepare_windowed
from flex_tpu_torch.sparse.device import DeviceCSR, resolve_device

CONFIGS = [
    # (tm, W, mc, G, step_order, max_dense_bytes)
    (256, 128, 56, 4, "row", 8 << 30),
    (256, 128, 48, 4, "row", 9 << 30),
    (128, 128, 32, 4, "row", 6 << 30),
    (128, 128, 24, 4, "row", 8 << 30),
    (512, 128, 64, 4, "row", 6 << 30),
    (512, 128, 96, 4, "row", 6 << 30),
]


def free(dev: torch.device) -> None:
    """Drop what the last plan left: Python's garbage and the card's
    cached blocks."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main(device=None, graph=None, configs=CONFIGS, k: int = 128,
         iters: int = 20) -> dict:
    """Every config in turn.  Returns tag -> the printed numbers, and
    ``"failed"``: [(tag, exception type, message)]."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.bench.headline import load_graph

        graph = load_graph()
    g = graph
    csr = DeviceCSR.from_graph(g, dev)
    _sync(dev)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (g.n, k), dtype=np.float32)).to(dev)
    p(f"graph {g}; k={k}")
    out = {"device": banner(dev), "failed": []}
    for tm, W, mc, gs, so, cap in configs:
        tag = f"tm={tm} W={W} mc={mc} G={gs} so={so}"
        plan = None
        try:
            t0 = time.time()
            plan = prepare_windowed(g, dev=csr, tm=tm, W=W, min_count=mc,
                                    g_step=gs, step_order=so,
                                    max_dense_bytes=cap)
            _sync(dev)
            t_pre_cold = time.time() - t0
            plan(B)
            t_elap = time_ms(dev, plan, B, iters=iters) * 1e-3
            t_res = time_ms(dev, plan.ell, B, iters=iters) * 1e-3 \
                if plan.ell.nnz else 0.0
            gf = 2 * g.nnz * k / t_elap / 1e9
            p(f"{tag}: tElap={t_elap*1e3:6.1f}ms ({gf:5.1f} GF/s) "
              f"res={t_res*1e3:6.1f}ms cov={plan.coverage:.3f} "
              f"steps={plan.A.shape[0]} preCold={t_pre_cold:.1f}s")
            out[tag] = {"t_elap_ms": t_elap * 1e3, "gflops": gf,
                        "res_ms": t_res * 1e3, "coverage": plan.coverage,
                        "steps": int(plan.A.shape[0]),
                        "t_pre_cold_s": t_pre_cold}
        except Exception as e:
            p(f"{tag}: FAILED {type(e).__name__}: {e}")
            out["failed"].append((tag, type(e).__name__, str(e)))
        del plan
        free(dev)
    return out


if __name__ == "__main__":
    main()
