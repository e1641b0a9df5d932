"""Train a 2-layer multi-head GAT on Pubmed, or a graph of its size.

Counterpart of ``examples/train_gat_pubmed.py``: load, self-loops (so
attention covers N(i) and i), the dynamic-value SpMM plan
(``ops/dyn_ell``, on the hand row-unit kernel), per-head edge scores and
the segment softmax, GAT(128 → 4 heads of 16 → the graph's classes)
training with Adam(1e-2).  Without a CSV the graph is
:func:`flex_tpu_torch.entry.pubmed_sized_graph`.

    python -m flex_tpu_torch.examples.train_gat_pubmed [steps] [graph.csv]
        [--device=cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def main(steps: int = 30, csv: str | None = None, device=None) -> dict:
    import scipy.sparse as sp

    from flex_tpu_torch.entry import pubmed_sized_graph
    from flex_tpu_torch.examples import labels, summary, train
    from flex_tpu_torch.io import load_csv, make_features
    from flex_tpu_torch.models import (
        GAT, gat_loss, make_gat_train_step, prepare_attention,
    )
    from flex_tpu_torch.sparse.csr import CSRGraph
    from flex_tpu_torch.sparse.device import resolve_device
    from flex_tpu_torch.utils.device_info import device_banner

    dev = resolve_device(device)
    print(device_banner(dev), flush=True)
    g0 = load_csv(csv) if csv else pubmed_sized_graph()
    # GAT attends over N(i) ∪ {i}
    A = (g0.to_scipy() + sp.eye(g0.m, format="csr")).tocsr()
    A.sort_indices()
    g = CSRGraph.from_arrays(A.indptr.astype(np.int64),
                             A.indices.astype(np.int64),
                             A.data.astype(np.float32), name=f"{g0.name}+sl")
    ag = prepare_attention(g, device=dev)
    print(f"{g}", flush=True)

    d_in, d_hidden, c = 128, 16, g0.label_width
    model = GAT(d_in, d_hidden, c, n_heads=4,
                generator=torch.Generator().manual_seed(0)).to(dev)
    X = torch.from_numpy(make_features(g, d_in)).to(dev)
    y, mask = labels(g.m, c, 0.1, dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_gat_train_step(model, ag, opt)
    with torch.no_grad():
        loss0 = float(gat_loss(model, ag, X, y, mask))
    losses, ms = train(step, (X, y, mask), steps, dev, every=10)
    return summary(loss0, losses, ms)


if __name__ == "__main__":
    from flex_tpu_torch.examples import parse

    pos, device = parse(sys.argv[1:], ("steps", "graph.csv"))
    main(*([int(pos[0])] if pos else []), *pos[1:], device=device)
