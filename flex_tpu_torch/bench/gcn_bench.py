"""GCN-layer benchmark: H = relu(A·X·W) under both association orders.

Counterpart of ``flex_tpu.bench.gcn_bench``: times A·(X·W) and (A·X)·W
through :func:`..ops.gcn.gcn_layer` (CUDA events on the card, the host
clock on ``device="cpu"``), and checks the two results against each
other and against SciPy with ``res_check2``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.bench.harness import time_ms
from flex_tpu_torch.ops.gcn import gcn_layer, pick_association
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import resolve_device
from flex_tpu_torch.utils.check import res_check2


@dataclasses.dataclass
class GCNBenchResult:
    graph: str
    d: int
    c: int
    t_axw: float          # A·(X·W), seconds
    t_ax_w: float         # (A·X)·W, seconds
    auto_choice: str
    cross_err_frac: float  # the two associations against each other
    scipy_err_frac: float

    def gflops(self, nnz: int, m: int) -> dict:
        return {
            "axw": (2 * m * self.d * self.c + 2 * nnz * self.c) / self.t_axw / 1e9,
            "ax_w": (2 * nnz * self.d + 2 * m * self.d * self.c) / self.t_ax_w / 1e9,
        }


def bench_gcn_layer(
    g: CSRGraph, d: int, c: int | None = None, method: str = "ell",
    iters: int = 5, seed: int = 0, check: bool = True, device=None,
) -> GCNBenchResult:
    """Both associations of one GCN layer (d inputs, c outputs; c defaults
    to the dataset's label width) on ``method``'s plan."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.ops import prepare_fn

    device = resolve_device(device)
    c = c if c is not None else g.label_width
    plan = prepare_fn(method)(g, device=device)
    X = torch.from_numpy(make_features(g, d, seed=seed)).to(device)
    rng = np.random.default_rng(seed + 1)
    W = torch.from_numpy(
        rng.standard_normal((d, c)).astype(np.float32) * 0.1).to(device)

    def f_axw(X, W):
        return gcn_layer(plan, X, W, association="axw")

    def f_ax_w(X, W):
        return gcn_layer(plan, X, W, association="ax_w")

    t_axw = time_ms(device, f_axw, X, W, iters=iters) * 1e-3
    t_ax_w = time_ms(device, f_ax_w, X, W, iters=iters) * 1e-3

    cross = scipy_err = 0.0
    if check:
        h1 = f_axw(X, W).cpu().numpy()
        h2 = f_ax_w(X, W).cpu().numpy()
        cross = res_check2(h1, h2, tol=0.01).err_frac
        A = g.to_scipy()
        want = np.maximum(A @ X.cpu().numpy() @ W.cpu().numpy(), 0.0)
        scipy_err = res_check2(want, h1, tol=0.01).err_frac

    return GCNBenchResult(
        graph=g.name, d=d, c=c, t_axw=t_axw, t_ax_w=t_ax_w,
        auto_choice=pick_association(g.m, g.nnz, d, c),
        cross_err_frac=cross, scipy_err_frac=scipy_err,
    )
