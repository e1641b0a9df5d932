"""Train a GCN on a community graph through the windowed plan.

Counterpart of ``examples/train_gcn_windowed.py``: the community
generator, the rbdeg clustering ordering, the windowed hybrid (dense
windows on the hand kernels, an ELL residue) and GCN(64 → 64 → 8)
training with Adam(1e-2), whose backward runs the window kernels'
gradient.

    python -m flex_tpu_torch.examples.train_gcn_windowed [steps] [m] [nnz]
        [--device=cpu]
"""
from __future__ import annotations

import sys
import time

import torch


def main(steps: int = 20, m: int = 20_000, nnz: int = 2_000_000,
         device=None) -> dict:
    from flex_tpu_torch.examples import labels, summary, train
    from flex_tpu_torch.io import community_graph, make_features
    from flex_tpu_torch.models import GCN, gcn_loss, make_train_step
    from flex_tpu_torch.ops.window_spmm import prepare_windowed
    from flex_tpu_torch.reorder import reorder
    from flex_tpu_torch.sparse.device import resolve_device
    from flex_tpu_torch.utils.device_info import device_banner

    dev = resolve_device(device)
    print(device_banner(dev), flush=True)
    t0 = time.perf_counter()
    g = reorder(community_graph(m, nnz, n_comm=8, seed=0), "rbdeg",
                check=False)
    plan = prepare_windowed(g, device=dev, tm=256, W=128, min_count=64)
    print(f"graph {g.m}x{g.m} nnz={g.nnz}; windowed coverage="
          f"{plan.coverage:.2f} ({time.perf_counter() - t0:.0f}s)",
          flush=True)

    n_classes = 8
    model = GCN(64, 64, n_classes, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0)).to(dev)
    X = torch.from_numpy(make_features(g, 64)).to(dev)
    y, mask = labels(g.m, n_classes, 0.3, dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, plan, opt)
    with torch.no_grad():
        loss0 = float(gcn_loss(model, plan, X, y, mask))
    print(f"initial loss {loss0:.4f}", flush=True)
    losses, ms = train(step, (X, y, mask), steps, dev, every=5)
    return summary(loss0, losses, ms)


if __name__ == "__main__":
    from flex_tpu_torch.examples import parse

    pos, device = parse(sys.argv[1:], ("steps", "m", "nnz"))
    main(*map(int, pos), device=device)
