"""``model.kind: "gcn2"``: the program's 2-layer GCN (Kipf & Welling),
``models.gcn.GCN``, with the benchmark's seed-made weights copied in; its
loss is the program's ``gcn_loss``.  The plain reference is
``reference/gcn2.py``."""
import torch

from spmm_bench.workload import glorot


def weights(md: dict, gen: torch.Generator, device) -> list:
    """(W1, b1, W2, b2): Glorot-uniform weights from ``gen``, zero
    biases, in the program's parameter order."""
    W1 = glorot((md["d_in"], md["d_hidden"]), gen, device)
    W2 = glorot((md["d_hidden"], md["n_classes"]), gen, device)
    return [W1, torch.zeros(md["d_hidden"], device=device),
            W2, torch.zeros(md["n_classes"], device=device)]


def build(cell, params: list):
    """The program's GCN on the cell's device with ``params`` copied in;
    it runs on the plan the traffic kind builds (``model(plan, X)``)."""
    from flex_tpu_torch.models.gcn import GCN

    md = cell.cfg["model"]
    model = GCN(md["d_in"], md["d_hidden"], md["n_classes"], cell.nnz,
                torch.Generator().manual_seed(0)).to(cell.device)
    with torch.no_grad():
        for p, w in zip(model.parameters(), params):
            p.copy_(w)
    return model


def loss(model, plan, X, y, mask):
    """The program's masked cross-entropy of ``model``'s logits."""
    from flex_tpu_torch.models.gcn import gcn_loss

    return gcn_loss(model, plan, X, y, mask)
