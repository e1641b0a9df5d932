"""Shared training machinery for the model families.

Counterpart of ``flex_tpu.models.common``: one masked cross-entropy and
one optimizer-step factory (semi-supervised node classification over a
prepared SpMM plan).
"""
from __future__ import annotations

from typing import Callable

import torch


def masked_xent(logits, y, mask) -> torch.Tensor:
    """Masked softmax cross-entropy over labelled nodes."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y.long()[:, None])[:, 0]
    denom = mask.sum().clamp_min(1)
    return (nll * mask).sum() / denom


def make_step(loss_fn: Callable, graph_arg, optimizer) -> Callable:
    """Returns ``step(X, y, mask) -> loss`` for ``loss_fn(graph_arg, X, y,
    mask)``: one backward pass and one update of ``optimizer``'s
    parameters (the model's, which ``loss_fn`` reads).  The loss returned
    is the one before the update."""

    def step(X, y, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(graph_arg, X, y, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
