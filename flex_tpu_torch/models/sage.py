"""GraphSAGE (mean aggregator) on the SpMM plans.

Counterpart of ``flex_tpu.models.sage``: GraphSAGE (Hamilton et al. 2017)
whose per-layer compute is one sparse aggregation Â·H (any prepared plan)
plus dense products:

    H_{l+1} = act( H_l · W_self + (Â · H_l) · W_neigh + b )

With a row-normalised Â this is full-graph mean-aggregator SAGE.  The
neighbour term goes through :func:`flex_tpu_torch.ops.gcn.gcn_layer`,
whose operation count picks (Â·H)·W or Â·(H·W), as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from flex_tpu_torch.models.common import glorot_uniform
from flex_tpu_torch.ops.gcn import gcn_layer


class GraphSAGE(nn.Module):
    """A 2-layer mean-aggregator SAGE.  ``nnz`` (the adjacency's) drives the
    association choice; the weights are Glorot-uniform from ``generator``
    (a CPU ``torch.Generator``; move the module to the card afterwards),
    with the JAX package's names and shapes."""

    def __init__(self, d_in: int, d_hidden: int, n_classes: int, nnz: int,
                 *, generator: torch.Generator):
        super().__init__()
        self.nnz = nnz
        self.Ws1 = nn.Parameter(glorot_uniform((d_in, d_hidden), generator))
        self.Wn1 = nn.Parameter(glorot_uniform((d_in, d_hidden), generator))
        self.b1 = nn.Parameter(torch.zeros(d_hidden))
        self.Ws2 = nn.Parameter(glorot_uniform((d_hidden, n_classes),
                                               generator))
        self.Wn2 = nn.Parameter(glorot_uniform((d_hidden, n_classes),
                                               generator))
        self.b2 = nn.Parameter(torch.zeros(n_classes))

    def _layer(self, plan, X, Ws, Wn, b, activation):
        # the bias rides the self term once
        neigh = gcn_layer(plan, X, Wn, None, activation=None,
                          association="auto", nnz=self.nnz)
        h = X @ Ws + neigh + b
        return activation(h) if activation is not None else h

    def forward(self, plan: Callable, X) -> torch.Tensor:
        h = self._layer(plan, X, self.Ws1, self.Wn1, self.b1, torch.relu)
        return self._layer(plan, h, self.Ws2, self.Wn2, self.b2, None)


def sage_loss(model: GraphSAGE, plan, X, y, mask) -> torch.Tensor:
    """Masked softmax cross-entropy over labelled nodes."""
    from flex_tpu_torch.models.common import masked_xent

    return masked_xent(model(plan, X), y, mask)


def make_sage_train_step(model: GraphSAGE, plan, optimizer) -> Callable:
    """Returns ``step(X, y, mask) -> loss``; ``optimizer`` holds
    ``model.parameters()``.  The plan goes through
    :func:`.common.training_plan` (a windowed plan gets its transposed
    residue backward)."""
    from flex_tpu_torch.models import common

    return common.make_step(
        lambda plan_, X, y, mask: sage_loss(model, plan_, X, y, mask),
        common.training_plan(plan), optimizer)
