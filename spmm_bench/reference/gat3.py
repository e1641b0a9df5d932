"""The plain reference of ``model.kind: "gat3"``, the three-layer GAT of
Veličković et al.'s inductive model (arXiv:1710.10903, §3.3).  Head k of
layer l, with W, a_s, a_d its weight and attention vectors, over the
edges (i, j) of A', each entry of the pattern once (its values are not
read):

    e_ij   = LeakyReLU(a_sᵀ W h_i + a_dᵀ W h_j)     (slope 0.2)
    α_ij   = softmax over the edges (i, ·) of e_ij
    out_i  = Σ_j α_ij W h_j

Layers 1 and 2 put each head through an ELU and concatenate the heads;
layer 2 adds its input to its output (the identity skip); layer 3
averages its heads.  Head counts and widths come from ``params``' shapes:
(W1, a1s, a1d, W2, a2s, a2d, W3, a3s, a3d), the order of
``models/gat3.py``'s weights, W (heads, d_in, width), a (heads, width).

The softmax is shifted by each row's maximum (a scatter max, detached)
and its row sums are an index add.  The aggregation runs over the edges
in blocks of at most ``common.BLOCK_ELEMS`` products with a backward of
its own (:class:`_Aggregate`) that gathers each block again, so that no
nnz × width operand outlives its block.  In ``"tf32"`` both operands of
every product are rounded to TF32 as ``common``'s are: the dense ones
(H·W and the score products H·W·a), the aggregation, its transposed
g_B and the per-edge dot products of g_α."""
from __future__ import annotations

import torch

from spmm_bench.reference.common import BLOCK_ELEMS, _operand, matmul

NEGATIVE_SLOPE = 0.2
SKIP = 2  # the layer (from 1) whose input is added to its output


def _edge_sum(dst, src, vals, B, rows: int, mode: str, block: int):
    """out[dst_e] += vals_e · B[src_e] over the edges, in blocks."""
    vals, B = _operand(vals, mode), _operand(B, mode)
    k = B.shape[1]
    out = torch.zeros((rows, k), dtype=B.dtype, device=B.device)
    step = max(1, block // max(k, 1))
    for s in range(0, len(dst), step):
        e = s + step
        out.index_add_(0, dst[s:e],
                       vals[s:e, None] * B.index_select(0, src[s:e]))
    return out


def _edge_dots(rows, cols, g, B, mode: str, block: int):
    """⟨g[rows_e], B[cols_e]⟩ for every edge, in blocks."""
    g, B = _operand(g, mode), _operand(B, mode)
    k = B.shape[1]
    out = torch.empty(len(rows), dtype=B.dtype, device=B.device)
    step = max(1, block // max(k, 1))
    for s in range(0, len(rows), step):
        e = s + step
        out[s:e] = (g.index_select(0, rows[s:e])
                    * B.index_select(0, cols[s:e])).sum(1)
    return out


class _Aggregate(torch.autograd.Function):
    """out_i = Σ over the edges (i, j) of α_ij · B_j; backward g_B by the
    transposed index add and g_α by per-edge dot products, each block's
    gathers made again."""

    @staticmethod
    def forward(ctx, A, alpha, B, mode, block):
        ctx.save_for_backward(alpha, B)
        ctx.A, ctx.mode, ctx.block = A, mode, block
        return _edge_sum(A.rows, A.cols, alpha, B, A.m, mode, block)

    @staticmethod
    def backward(ctx, g):
        alpha, B = ctx.saved_tensors
        A, mode, block = ctx.A, ctx.mode, ctx.block
        g_alpha = g_B = None
        if ctx.needs_input_grad[1]:
            g_alpha = _edge_dots(A.rows, A.cols, g, B, mode, block)
        if ctx.needs_input_grad[2]:
            g_B = _edge_sum(A.cols, A.rows, alpha, g, B.shape[0], mode,
                            block)
        return None, g_alpha, g_B, None, None


def aggregate(A, alpha, B, mode="f64", block: int = BLOCK_ELEMS):
    """Σ_j α_ij B_j for every row i of A' (edge weights ``alpha`` in the
    order of ``A.rows`` / ``A.cols``), differentiable in both."""
    return _Aggregate.apply(A, alpha, B, mode, block)


def edge_softmax(A, e) -> torch.Tensor:
    """Each row's softmax of the edge scores ``e``, shifted by the row's
    maximum."""
    mx = torch.full((A.m,), float("-inf"), dtype=e.dtype, device=e.device)
    mx = mx.scatter_reduce(0, A.rows, e.detach(), reduce="amax")
    ex = torch.exp(e - mx.index_select(0, A.rows))
    sums = torch.zeros(A.m, dtype=e.dtype, device=e.device).index_add(
        0, A.rows, ex)
    return ex / sums.index_select(0, A.rows)


def head(A, H, W, a_s, a_d, mode="f64") -> torch.Tensor:
    """One attention head's (m, width) output."""
    Hw = matmul(H, W, mode)
    s = matmul(Hw, torch.stack((a_s, a_d), 1), mode)
    e = torch.nn.functional.leaky_relu(
        s[:, 0].index_select(0, A.rows) + s[:, 1].index_select(0, A.cols),
        NEGATIVE_SLOPE)
    return aggregate(A, edge_softmax(A, e), Hw, mode)


def forward(A, X, params, mode="f64") -> torch.Tensor:
    """The logits."""
    h = X
    n_layers = len(params) // 3
    for l in range(1, n_layers + 1):
        W, a_s, a_d = params[3 * l - 3:3 * l]
        heads = [head(A, h, W[k], a_s[k], a_d[k], mode)
                 for k in range(W.shape[0])]
        out = torch.cat([torch.nn.functional.elu(o) for o in heads], 1) \
            if l < n_layers else sum(heads) / len(heads)
        h = out + h if l == SKIP else out
    return h
