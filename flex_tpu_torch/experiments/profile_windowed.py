"""Where the windowed hybrid's time goes: the full call, the dense half
alone and the residue alone.

Counterpart of ``experiments/profile_windowed.py`` on the headline graph
(:func:`..bench.headline.load_graph`): ``prepare_windowed(tm=256, W=128,
min_count=mc)``, B = ``make_features(g, 128)``; the plan's call, the same
plan with an empty residue (the dense half with its assembly) and the
residue's own call, each the median of 10 timed calls.  It prints the
script's two lines.  The script's ``/tmp`` npz and compile-cache
configuration are dropped.

    python -m flex_tpu_torch.experiments.profile_windowed [mc]
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from flex_tpu_torch.bench.harness import _sync, time_ms
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.io import make_features
from flex_tpu_torch.ops.ell_spmm import EllPlan
from flex_tpu_torch.ops.window_spmm import prepare_windowed
from flex_tpu_torch.sparse.device import DeviceCSR, resolve_device


def empty_residue(m: int, device) -> EllPlan:
    return EllPlan(m=m, buckets=(),
                   chunk_row=torch.zeros((0,), dtype=torch.int32,
                                         device=device),
                   padded_nnz=0, nnz=0)


def main(device=None, graph=None, mc: int = 128, k: int = 128,
         iters: int = 10) -> dict:
    """The three times at ``min_count=mc``.  Returns them in ms with the
    plan's numbers."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.bench.headline import load_graph

        graph = load_graph()
    g = graph
    csr = DeviceCSR.from_graph(g, dev)
    _sync(dev)
    t0 = time.time()
    plan = prepare_windowed(g, dev=csr, tm=256, W=128, min_count=mc)
    _sync(dev)
    p(f"prepare: {time.time()-t0:.1f}s stats={plan.stats}")
    B = torch.from_numpy(make_features(g, k)).to(dev)
    dense_only = dataclasses.replace(plan, ell=empty_residue(g.m, dev))
    t_full = time_ms(dev, plan, B, iters=iters) * 1e-3
    t_dense = time_ms(dev, dense_only, B, iters=iters) * 1e-3
    t_res = time_ms(dev, plan.ell, B, iters=iters) * 1e-3
    S = plan.stats["n_steps"]
    p(f"mc={mc} cov={plan.coverage:.3f} S={S} res_nnz={plan.ell.nnz} "
      f"res_pad={plan.ell.padded_nnz}")
    p(f"full={t_full*1e3:.1f}ms dense={t_dense*1e3:.1f}ms "
      f"({t_dense/S*1e6:.2f}us/step) res={t_res*1e3:.1f}ms "
      f"sum={1e3*(t_dense+t_res):.1f}ms "
      f"-> {2*g.nnz*k/t_full/1e9:.1f} GF/s")
    return {"device": banner(dev), "mc": mc, "coverage": plan.coverage,
            "steps": S, "res_nnz": plan.ell.nnz,
            "res_pad": plan.ell.padded_nnz, "full_ms": t_full * 1e3,
            "dense_ms": t_dense * 1e3, "res_ms": t_res * 1e3,
            "gflops": 2 * g.nnz * k / t_full / 1e9}


if __name__ == "__main__":
    main(mc=int(sys.argv[1]) if len(sys.argv) > 1 else 128)
