"""Train a 2-layer GCN on Pubmed, or a graph of its size.

Counterpart of ``examples/train_gcn_pubmed.py``: load, the deg ordering,
the autotuner's method and its plan, GCN(128 → 64 → the graph's classes)
training with Adam(5e-3), then a checkpoint of the model and the
optimizer, restored into a fresh model and optimizer, from which the next
step must give the uninterrupted run's loss bit for bit.  Without a CSV
(``load_csv``'s 3-line format) the graph is
:func:`flex_tpu_torch.entry.pubmed_sized_graph`.

    python -m flex_tpu_torch.examples.train_gcn_pubmed [steps] [graph.csv]
        [--device=cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch


def main(steps: int = 30, csv: str | None = None, device=None) -> dict:
    from flex_tpu_torch.bench.autotune import suggest
    from flex_tpu_torch.entry import pubmed_sized_graph
    from flex_tpu_torch.examples import labels, summary, train
    from flex_tpu_torch.io import load_csv, make_features
    from flex_tpu_torch.models import GCN, gcn_loss, make_train_step
    from flex_tpu_torch.models.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )
    from flex_tpu_torch.ops import prepare_fn
    from flex_tpu_torch.reorder import reorder
    from flex_tpu_torch.sparse.device import resolve_device
    from flex_tpu_torch.utils.device_info import device_banner

    dev = resolve_device(device)
    print(device_banner(dev), flush=True)
    g = reorder(load_csv(csv) if csv else pubmed_sized_graph(), "deg",
                check=False)
    sug = suggest(g, 128)
    print(f"{g}; autotuner: {sug.method} ({sug.reason})", flush=True)
    plan = prepare_fn(sug.method)(g, device=dev, **sug.prep_kwargs)

    d_in, d_hidden, c = 128, 64, g.label_width

    def new_model(seed):
        model = GCN(d_in, d_hidden, c, nnz=g.nnz,
                    generator=torch.Generator().manual_seed(seed)).to(dev)
        return model, torch.optim.Adam(model.parameters(), lr=5e-3)

    model, opt = new_model(0)
    X = torch.from_numpy(make_features(g, d_in)).to(dev)
    y, mask = labels(g.m, c, 0.3, dev)
    step = make_train_step(model, plan, opt)
    with torch.no_grad():
        loss0 = float(gcn_loss(model, plan, X, y, mask))
    losses, ms = train(step, (X, y, mask), steps, dev, every=10)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gcn_pubmed.ckpt")
        save_checkpoint(path, model, opt, step=steps)
        resumed, resumed_opt = new_model(1)
        got = restore_checkpoint(path, resumed, resumed_opt)
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 resumed.parameters()))
    nxt = float(step(X, y, mask))
    nxt_resumed = float(make_train_step(resumed, plan, resumed_opt)(
        X, y, mask))
    print(f"checkpoint round-trip: step={got}, parameters "
          f"{'equal' if same else 'DIFFER'}; next loss {nxt:.6f} "
          f"(resumed {nxt_resumed:.6f})", flush=True)
    if got != steps or not same or nxt != nxt_resumed:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    return summary(loss0, losses, ms)


if __name__ == "__main__":
    from flex_tpu_torch.examples import parse

    pos, device = parse(sys.argv[1:], ("steps", "graph.csv"))
    main(*([int(pos[0])] if pos else []), *pos[1:], device=device)
