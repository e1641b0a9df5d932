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
max-shifted segment softmax over the CSR rows.  Scores and softmax are
one differentiable call of the plan (:meth:`.DynEllPlan.edge_attention`):
on the card a hand-written kernel pair (a warp a row, a block a long
one) with no scatter and nothing read on the host; on the CPU the plain
composition.

:class:`GAT` stacks layers of heads (:class:`GATLayer`: a head count, a
width per head, and whether the heads are concatenated after an ELU or
averaged), optionally with an identity skip connection around one layer.
By default it is the JAX package's two-layer model: one head count,
layer 1 concatenated, layer 2 averaged.  The model attends over exactly
the given pattern: for N(i) ∪ {i}, pass a graph with diagonal entries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from flex_tpu_torch.models.common import glorot_uniform
from flex_tpu_torch.ops.dyn_ell import DynEllPlan, prepare_dyn_ell
from flex_tpu_torch.ops.edge_softmax import segment_softmax_plain
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils import trace as _trace


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

    with _trace.setup_span("flex.build.attention", m=g.m, nnz=g.nnz):
        dev = resident_csr(g, dev, device)
        return AttentionGraph(
            m=g.m, nnz=g.nnz,
            deg=(dev.row_ptr[1:] - dev.row_ptr[:-1]).long(),
            plan=prepare_dyn_ell(g, dev=dev))


def _softmax_attrs(ag: AttentionGraph):
    """The ``flex.edge_softmax`` span's attrs (host time only)."""
    return None, {"m": ag.m, "nnz": ag.nnz}


def edge_softmax(ag: AttentionGraph, e: torch.Tensor) -> torch.Tensor:
    """Row-wise max-shifted softmax of CSR-order edge scores e[nnz] ->
    alpha[nnz] (:func:`.ops.edge_softmax.segment_softmax_plain`): the
    plain building block, differentiable in e.  Its call is the
    ``flex.edge_softmax`` span (host time only)."""
    with _trace.span("flex.edge_softmax", _softmax_attrs, ag):
        return segment_softmax_plain(ag.rows, ag.deg, e)


def gat_head(ag: AttentionGraph, H, W, a_src, a_dst,
             negative_slope: float = 0.2) -> torch.Tensor:
    """One attention head: the aggregated (m, d_out) features.  H·W is
    annotated ``flex.gemm`` on a profiler's clock; the scores' products
    H·W·a stay matrix-vector products, and the edge scores and their
    softmax are :meth:`.DynEllPlan.edge_attention` (on the card, the
    kernel pair of ``csrc/edge_softmax.cu``)."""
    with _trace.annotate("flex.gemm"):
        Hw = H @ W
    alpha = ag.plan.edge_attention(Hw @ a_src, Hw @ a_dst, negative_slope)
    return ag.plan(alpha, Hw)


class GATLayer(NamedTuple):
    """One layer of :class:`GAT`: ``heads`` attention heads of ``width``
    features each, concatenated after an ELU (``concat``) or averaged, with
    no activation (the output layer's form)."""

    heads: int
    width: int
    concat: bool


def _names(l: int) -> tuple[str, str, str]:
    """The parameter names of layer ``l`` (from 1): W, a_src, a_dst."""
    return f"W{l}", f"a{l}s", f"a{l}d"


class GAT(nn.Module):
    """Multi-head GAT: ``layers`` (a sequence of :class:`GATLayer`, or of
    (heads, width, concat) triples) in order, each with parameters
    ``W<l>`` (heads, d_in of the layer, width), ``a<l>s`` and ``a<l>d``
    (heads, width), l counting from 1.  ``skip`` names the layer l whose
    input is added to its output (an identity skip connection: the two
    must be of one width), or None.

    Without ``layers`` it is the JAX package's two-layer model:
    ``GATLayer(n_heads, d_hidden, True)`` then ``GATLayer(n_heads,
    n_classes, False)``, with its names and shapes (``d_hidden`` and
    ``n_classes`` are then required; with ``layers`` they and ``n_heads``
    are not read).  The weights are Glorot-uniform from ``generator`` (a
    CPU ``torch.Generator``; move the module to the card afterwards),
    drawn layer by layer in the parameters' order."""

    def __init__(self, d_in: int, d_hidden: int | None = None,
                 n_classes: int | None = None, n_heads: int = 4, *,
                 generator: torch.Generator, layers=None,
                 skip: int | None = None):
        super().__init__()
        if layers is None:
            if d_hidden is None or n_classes is None:
                raise ValueError("GAT needs d_hidden and n_classes, or "
                                 "layers")
            layers = ((n_heads, d_hidden, True), (n_heads, n_classes, False))
        elif d_hidden is not None or n_classes is not None:
            raise ValueError("give GAT layers, or d_hidden and n_classes, "
                             "not both")
        self.layers = tuple(GATLayer(*spec) for spec in layers)
        if skip is not None and not 1 <= skip <= len(self.layers):
            raise ValueError(f"skip must name a layer in 1..."
                             f"{len(self.layers)}, got {skip}")
        self.skip = skip

        d = d_in
        for l, (nh, dh, concat) in enumerate(self.layers, 1):
            # the a vectors are drawn as (heads, width, 1), JAX's fans
            for name, shape in zip(_names(l), ((nh, d, dh), (nh, dh, 1),
                                               (nh, dh, 1))):
                w = glorot_uniform(shape, generator)
                self.register_parameter(name, nn.Parameter(
                    w if name[0] == "W" else w[..., 0]))
            d_out = nh * dh if concat else dh
            if l == skip and d_out != d:
                raise ValueError(f"the skip around layer {l} adds its "
                                 f"{d}-wide input to its {d_out}-wide "
                                 f"output")
            d = d_out

    def forward(self, ag: AttentionGraph, X) -> torch.Tensor:
        h = X
        for l, (nh, _, concat) in enumerate(self.layers, 1):
            W, a_s, a_d = (getattr(self, name) for name in _names(l))
            heads = [gat_head(ag, h, W[k], a_s[k], a_d[k])
                     for k in range(nh)]
            out = torch.cat([torch.nn.functional.elu(o) for o in heads],
                            dim=1) if concat else sum(heads) / nh
            h = out + h if l == self.skip else out
        return h


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
