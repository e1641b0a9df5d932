"""GCN layer: H = act(A · X · W + b).

Counterpart of ``flex_tpu.ops.gcn``.  A layer can associate as (A·X)·W or
A·(X·W); the cheaper order depends on the widths: 2·nnz·d + 2·m·d·c
against 2·m·d·c + 2·nnz·c operations, so A·(X·W) wins iff the output
width c is at most the input width d.

The SpMM side takes any prepared plan; the dense product is a plain
``torch.matmul`` in full float32 (TF32 stays off), as the JAX package
leaves it to XLA.
"""
from __future__ import annotations

from typing import Callable

import torch

from flex_tpu_torch.ops.operands import check_precision
from flex_tpu_torch.utils import trace as _trace


def pick_association(m: int, nnz: int, d: int, c: int) -> str:
    """'axw' = A·(X·W), 'ax_w' = (A·X)·W: whichever does fewer operations."""
    flops_axw = 2 * m * d * c + 2 * nnz * c
    flops_ax_w = 2 * nnz * d + 2 * m * d * c
    return "axw" if flops_axw <= flops_ax_w else "ax_w"


def _dense(matmul: Callable, X, W):
    """``matmul(X, W)``, annotated ``flex.gemm`` on a profiler's clock
    (:func:`.utils.trace.annotate`)."""
    with _trace.annotate("flex.gemm"):
        return matmul(X, W)


def gcn_layer(plan, X, W, b=None, activation: Callable | None = torch.relu,
              association: str = "auto", nnz: int | None = None,
              precision=None, matmul: Callable = torch.matmul):
    """One GCN layer using a prepared SpMM plan for A.

    plan: any callable B ↦ A·B for the adjacency.
    X: [n, d] features.  W: [d, c] weights.  b: optional [c] bias.
    association: 'axw', 'ax_w', or 'auto' (the operation count, which
    needs ``nnz``).  precision: the JAX signature's dot precision (None, a
    name, a ``jax.lax.Precision`` member or a pair of them), accepted and
    ignored: the dense product is exact f32 here.  matmul: the dense
    product (the 2-D sharded step passes one that runs W's column blocks on
    several devices)."""
    check_precision(precision)
    d, c = W.shape
    if association == "auto":
        if nnz is None:
            raise ValueError("association='auto' needs nnz")
        association = pick_association(X.shape[0], nnz, d, c)
    if association == "axw":
        H = plan(_dense(matmul, X, W))
    elif association == "ax_w":
        H = _dense(matmul, plan(X), W)
    else:
        raise ValueError(association)
    if b is not None:
        H = H + b
    if activation is not None:
        H = activation(H)
    return H
