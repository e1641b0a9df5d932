"""Trainable 2-layer GCN (Kipf & Welling) on the SpMM plans.

    H1 = relu(Â · X · W1 + b1)
    Z  = Â · H1 · W2 + b2
    L  = masked softmax cross-entropy

Counterpart of ``flex_tpu.models.gcn``.  Â is any prepared plan; the
parameters keep the JAX package's names, shapes and orientation
(``W1`` is (d_in, d_hidden)), and ``torch.optim.Adam`` stands for
``optax.adam`` (same b1, b2 and eps, eps outside the root in both).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from flex_tpu_torch.models.common import glorot_uniform
from flex_tpu_torch.ops.gcn import gcn_layer


class GCN(nn.Module):
    """A 2-layer GCN.  ``nnz`` (the adjacency's) drives the association
    choice; the weights are Glorot-uniform from ``generator`` (a CPU
    ``torch.Generator``; move the module to the card afterwards)."""

    def __init__(self, d_in: int, d_hidden: int, n_classes: int, nnz: int,
                 generator: torch.Generator):
        super().__init__()
        self.nnz = nnz
        self.W1 = nn.Parameter(glorot_uniform((d_in, d_hidden), generator))
        self.b1 = nn.Parameter(torch.zeros(d_hidden))
        self.W2 = nn.Parameter(glorot_uniform((d_hidden, n_classes),
                                               generator))
        self.b2 = nn.Parameter(torch.zeros(n_classes))

    def forward(self, plan: Callable, X,
                matmul: Callable = torch.matmul) -> torch.Tensor:
        h = gcn_layer(plan, X, self.W1, self.b1, activation=torch.relu,
                      association="auto", nnz=self.nnz, matmul=matmul)
        return gcn_layer(plan, h, self.W2, self.b2, activation=None,
                         association="auto", nnz=self.nnz, matmul=matmul)


def gcn_loss(model: GCN, plan, X, y, mask) -> torch.Tensor:
    """Masked softmax cross-entropy over labelled nodes."""
    from flex_tpu_torch.models.common import masked_xent

    return masked_xent(model(plan, X), y, mask)


def make_train_step(model: GCN, plan, optimizer) -> Callable:
    """Returns ``step(X, y, mask) -> loss``; ``optimizer`` holds
    ``model.parameters()``.  The plan goes through
    :func:`.common.training_plan` (a windowed plan gets its transposed
    residue backward)."""
    from flex_tpu_torch.models import common

    return common.make_step(
        lambda plan_, X, y, mask: gcn_loss(model, plan_, X, y, mask),
        common.training_plan(plan), optimizer)
