"""Reddit-scale GCN training on the windowed plan against ELL.

Counterpart of ``experiments/bench_gcn_train.py``: a 2-layer GCN (d = 128
-> 128 -> 41 classes, like Reddit) takes full-graph steps with Adam (lr
1e-2) on reddit_posts rbdeg (:func:`..bench.headline.load_graph`), X =
``make_features(g, 128)``, seeded labels, every node labelled.

First the gradient parity line: g_B of (plan(B)·co).sum() through the
windowed plan (``prepare_windowed(tm=256, W=128, min_count=64)``) and
through the same plan under ``with_training_bwd`` (the residue's g_B as
the transposed pattern's forward on kernel 7), max relative difference.
Then ms/step (2 warm-up, 5 timed steps, the median between CUDA events)
on each plan:

- ``windowed``: the plan as built; the residue's g_B is autograd's plain
  transposed scatter (``index_add_``), as the JAX script's autodiff
  transposed the gather;
- ``windowed+tbwd``: ``with_training_bwd(plan)``;
- ``ell``: ``prepare_ell(g)``, its g_B the plain transposed scatter;
- ``ell+tbwd``: the same ELL plan with its transposed-pattern backward
  (``with_bwd_plan(plan, n)``): the port's own row, not the script's.

The steps are :func:`..models.common.make_step` on ``gcn_loss`` with the
plan as given (``make_train_step`` would attach the training backward to
every windowed plan).  SpMM work a step: 2 layers × (forward + g_B) = 4
SpMMs, the script's GF/s.  The script's compile cache, ``/tmp`` npz and
its logging clock are dropped.

    python -m flex_tpu_torch.experiments.bench_gcn_train
"""
from __future__ import annotations

import time

import numpy as np
import torch

from flex_tpu_torch.bench.harness import _sync
from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.io import make_features
from flex_tpu_torch.models import GCN
from flex_tpu_torch.models.common import make_step
from flex_tpu_torch.models.gcn import gcn_loss
from flex_tpu_torch.ops.ell_spmm import prepare_ell, with_bwd_plan
from flex_tpu_torch.ops.window_spmm import prepare_windowed, with_training_bwd
from flex_tpu_torch.sparse.device import DeviceCSR, resolve_device

D_IN, D_HID, N_CLS = 128, 128, 41
WIN_KW = dict(tm=256, W=128, min_count=64)


def grad_b(plan, B: torch.Tensor, co: torch.Tensor) -> torch.Tensor:
    """g_B of (plan(B)·co).sum()."""
    b = B.detach().clone().requires_grad_(True)
    (plan(b) * co).sum().backward()
    return b.grad


def plans(g, csr: DeviceCSR, win_kw=WIN_KW) -> dict:
    """name -> a function that builds the plan."""
    return {
        "windowed": lambda: prepare_windowed(g, dev=csr, **win_kw),
        "windowed+tbwd": lambda: with_training_bwd(
            prepare_windowed(g, dev=csr, **win_kw)),
        "ell": lambda: prepare_ell(g, dev=csr),
        "ell+tbwd": lambda: with_bwd_plan(prepare_ell(g, dev=csr), g.n),
    }


def step_ms(step, args, dev: torch.device, n: int = 5, warmup: int = 2
            ) -> tuple[float, list]:
    """(median ms of ``n`` steps, every step's loss): CUDA events on the
    card, the host clock on the CPU."""
    losses = [float(step(*args)) for _ in range(warmup)]
    ts = []
    for _ in range(n):
        if dev.type == "cuda":
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            loss = step(*args)
            e.record()
            torch.cuda.synchronize(dev)
            ts.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            loss = step(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return float(np.median(ts)), losses


def main(device=None, graph=None, names=("windowed", "windowed+tbwd", "ell",
                                         "ell+tbwd"),
         win_kw=WIN_KW, steps: int = 5, warmup: int = 2) -> dict:
    """The parity line and a ms/step line a plan.  Returns the numbers and
    each plan's losses."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.bench.headline import load_graph

        graph = load_graph()
    g = graph
    csr = DeviceCSR.from_graph(g, dev)
    _sync(dev)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(make_features(g, D_IN)).to(dev)
    y = torch.from_numpy(rng.integers(0, N_CLS, g.m)).to(dev)
    mask = torch.ones(g.m, device=dev)
    co = torch.from_numpy(rng.random((g.m, D_IN)).astype(np.float32)).to(dev)

    base = prepare_windowed(g, dev=csr, **win_kw)
    g1 = grad_b(base, X, co)
    g2 = grad_b(with_training_bwd(base), X, co)
    den = g1.abs().clamp_min(1e-3)
    parity = float(((g1 - g2).abs() / den).max())
    p(f"grad parity windowed vs +tbwd: max_rel={parity:.2e}")
    del base, g1, g2, den, co
    out = {"device": banner(dev), "grad_parity_max_rel": parity}
    build = plans(g, csr, win_kw)
    for name in names:
        plan = build[name]()
        model = GCN(D_IN, D_HID, N_CLS, nnz=g.nnz,
                    generator=torch.Generator().manual_seed(0)).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = make_step(lambda pl, X_, y_, m_: gcn_loss(model, pl, X_, y_,
                                                         m_), plan, opt)
        ms, losses = step_ms(step, (X, y, mask), dev, steps, warmup)
        gf = 4 * 2 * g.nnz * D_IN / (ms * 1e-3) / 1e9
        p(f"{name}: {ms:.1f} ms/step ({gf:.0f} GF/s SpMM-equiv)")
        out[name] = {"ms_per_step": ms, "gflops_spmm_equiv": gf,
                     "losses": losses}
        del plan, model, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
