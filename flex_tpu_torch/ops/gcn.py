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

import enum
from typing import Callable

import torch


def pick_association(m: int, nnz: int, d: int, c: int) -> str:
    """'axw' = A·(X·W), 'ax_w' = (A·X)·W: whichever does fewer operations."""
    flops_axw = 2 * m * d * c + 2 * nnz * c
    flops_ax_w = 2 * nnz * d + 2 * m * d * c
    return "axw" if flops_axw <= flops_ax_w else "ax_w"


def _check_precision(precision) -> None:
    pair = precision if isinstance(precision, tuple) else (precision,)
    if len(pair) not in (1, 2) or not all(
            p is None or isinstance(p, (str, enum.Enum)) for p in pair):
        raise TypeError(f"precision must be None, a name, a Precision "
                        f"member or a pair of them, got {precision!r}")


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
    _check_precision(precision)
    d, c = W.shape
    if association == "auto":
        if nnz is None:
            raise ValueError("association='auto' needs nnz")
        association = pick_association(X.shape[0], nnz, d, c)
    if association == "axw":
        H = plan(matmul(X, W))
    elif association == "ax_w":
        H = matmul(plan(X), W)
    else:
        raise ValueError(association)
    if b is not None:
        H = H + b
    if activation is not None:
        H = activation(H)
    return H
