"""Shared training machinery for the model families.

Counterpart of ``flex_tpu.models.common``: one masked cross-entropy and
one optimizer-step factory (semi-supervised node classification over a
prepared SpMM plan).
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def glorot_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform f32 weights of ``shape`` from ``generator`` (a CPU
    ``torch.Generator``), with the fans of JAX's initializer: the last axis
    is fan-out, the one before it fan-in, and the axes before those
    multiply both."""
    receptive = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))
    return (torch.rand(shape, generator=generator, dtype=torch.float32)
            * 2 - 1) * limit


def training_plan(plan):
    """The plan a train step differentiates through: a windowed plan
    without a transposed residue backward gets one (``with_training_bwd``;
    training differentiates only the parameters, and the adjacency is a
    constant).  Any other plan is returned as it is; a bare EllPlan does
    not record B's row count (n != m on rectangular graphs), so callers use
    ``ell_spmm.with_bwd_plan`` with the right n."""
    from flex_tpu_torch.ops.window_spmm import WindowedPlan, with_training_bwd

    if isinstance(plan, WindowedPlan) and plan.ell.bwd_plan is None:
        return with_training_bwd(plan)
    return plan


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
