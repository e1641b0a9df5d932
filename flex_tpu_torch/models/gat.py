"""Graph Attention Network (GAT) on the dynamic-value SpMM plan.

Counterpart of ``flex_tpu.models.gat``.  GAT (Velickovic et al. 2018)
recomputes its aggregation weights every forward pass, the workload of
:mod:`flex_tpu_torch.ops.dyn_ell` (static pattern, edge values with
gradients).

Per head:  e_ij   = LeakyReLU(a_srcᵀ W h_i + a_dstᵀ W h_j)
           α_ij   = softmax over j ∈ N(i) of e_ij
           h'_i   = Σ_j α_ij · W h_j          (one dynamic-value SpMM)

aᵀ[Wh_i ‖ Wh_j] = a_srcᵀWh_i + a_dstᵀWh_j turns the per-edge score into
two m-vectors gathered at the edge endpoints.  The row-wise softmax is a
max-shifted segment softmax over the CSR rows.  Layer 1 concatenates the
heads after an ELU, layer 2 averages them.  The model attends over
exactly the given pattern: for N(i) ∪ {i}, pass a graph with diagonal
entries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from flex_tpu_torch.models.common import glorot_uniform
from flex_tpu_torch.ops.dyn_ell import DynEllPlan, prepare_dyn_ell
from flex_tpu_torch.sparse.csr import CSRGraph


@dataclasses.dataclass
class AttentionGraph:
    """Per-edge machinery shared by every GAT layer and head: the row
    lengths (segment sums) and the dynamic-value SpMM plan (aggregation),
    whose CSR-order endpoint ids the scores and the softmax read."""

    m: int
    nnz: int
    deg: torch.Tensor    # i64 [m] row lengths
    plan: DynEllPlan

    @property
    def rows(self) -> torch.Tensor:
        """i64 [nnz] CSR-order source (output row) ids."""
        return self.plan.rows

    @property
    def cols(self) -> torch.Tensor:
        """i32 [nnz] CSR-order destination ids."""
        return self.plan.cols


def prepare_attention(g: CSRGraph, dev=None, device=None) -> AttentionGraph:
    """Everything derives on the device from the resident CSR (``dev``, or
    ``g`` moved to ``device``: CUDA unless the caller names another)."""
    from flex_tpu_torch.sparse.device import resident_csr

    dev = resident_csr(g, dev, device)
    return AttentionGraph(
        m=g.m, nnz=g.nnz, deg=(dev.row_ptr[1:] - dev.row_ptr[:-1]).long(),
        plan=prepare_dyn_ell(g, dev=dev))


def edge_softmax(ag: AttentionGraph, e: torch.Tensor) -> torch.Tensor:
    """Row-wise max-shifted softmax of CSR-order edge scores e[nnz] ->
    alpha[nnz].  The maximum is detached (the softmax does not change
    under a shift); the row sums are a segment reduction over the CSR runs,
    which sums each row in a fixed order.  Rows with no edges are never
    gathered, so their -inf maximum never propagates."""
    mx = torch.full((ag.m,), float("-inf"), dtype=e.dtype, device=e.device)
    mx = mx.scatter_reduce(0, ag.rows, e.detach(), reduce="amax")
    ex = torch.exp(e - mx.index_select(0, ag.rows))
    s = torch.segment_reduce(ex, "sum", lengths=ag.deg)
    return ex / s.index_select(0, ag.rows)


def gat_head(ag: AttentionGraph, H, W, a_src, a_dst,
             negative_slope: float = 0.2) -> torch.Tensor:
    """One attention head: the aggregated (m, d_out) features."""
    Hw = H @ W
    e = torch.nn.functional.leaky_relu(
        (Hw @ a_src).index_select(0, ag.rows)
        + (Hw @ a_dst).index_select(0, ag.cols), negative_slope)
    return ag.plan(edge_softmax(ag, e), Hw)


class GAT(nn.Module):
    """2-layer multi-head GAT: layer 1 concatenates ``n_heads`` heads of
    width ``d_hidden``, layer 2 averages ``n_heads`` output heads.  The
    weights are Glorot-uniform from ``generator`` (a CPU
    ``torch.Generator``; move the module to the card afterwards), with the
    JAX package's names and shapes."""

    def __init__(self, d_in: int, d_hidden: int, n_classes: int,
                 n_heads: int = 4, *, generator: torch.Generator):
        super().__init__()
        nh, dh = n_heads, d_hidden
        self.n_heads = n_heads

        def glorot(*shape):
            return glorot_uniform(shape, generator)

        self.W1 = nn.Parameter(glorot(nh, d_in, dh))
        self.a1s = nn.Parameter(glorot(nh, dh, 1)[..., 0])
        self.a1d = nn.Parameter(glorot(nh, dh, 1)[..., 0])
        self.W2 = nn.Parameter(glorot(nh, nh * dh, n_classes))
        self.a2s = nn.Parameter(glorot(nh, n_classes, 1)[..., 0])
        self.a2d = nn.Parameter(glorot(nh, n_classes, 1)[..., 0])

    def forward(self, ag: AttentionGraph, X) -> torch.Tensor:
        h1 = torch.cat([
            torch.nn.functional.elu(gat_head(ag, X, self.W1[h], self.a1s[h],
                                             self.a1d[h]))
            for h in range(self.n_heads)], dim=1)
        out = [gat_head(ag, h1, self.W2[h], self.a2s[h], self.a2d[h])
               for h in range(self.n_heads)]
        return sum(out) / self.n_heads


def gat_loss(model: GAT, ag, X, y, mask) -> torch.Tensor:
    """Masked softmax cross-entropy over labelled nodes."""
    from flex_tpu_torch.models.common import masked_xent

    return masked_xent(model(ag, X), y, mask)


def make_gat_train_step(model: GAT, ag: AttentionGraph,
                        optimizer) -> Callable:
    """Returns ``step(X, y, mask) -> loss``; ``optimizer`` holds
    ``model.parameters()``."""
    from flex_tpu_torch.models import common

    return common.make_step(
        lambda ag_, X, y, mask: gat_loss(model, ag_, X, y, mask),
        ag, optimizer)
