"""The yardstick's arithmetic of a GAT (``model.kind: "gat3"``), counted
as :mod:`spmm_bench.arith` counts: the operations and bytes of the
problem, no pads, no elementwise work."""
from __future__ import annotations

from spmm_bench.arith import (
    ELEM, PEAK_FP32_FLOPS, PEAK_HBM_BYTES, dense_flops, spmm_flops,
)


def gat_train_step_flops(m: int, nnz: int, d_in: int, heads, widths,
                         combine) -> int:
    """A full-graph training step of a GAT whose layer l has ``heads[l]``
    heads of ``widths[l]`` columns, ``combine[l]`` "concat" or "mean".
    Each head of a layer with d-wide input and c-wide heads:

    - H·W, and W's gradient Hᵀ·g (2·m·d·c each); the gradient into H,
      g·Wᵀ, but in the first layer (X needs no gradient);
    - the score products H·W·[a_s a_d] (2·m·c·2) and their gradients into
      H·W and into the a vectors (2·m·c·2 each);
    - the aggregation A(α)·(H·W), its transposed A(α)ᵀ·g for g_B and the
      per-edge dot products ⟨g_i, (H·W)_j⟩ for g_α (2·nnz·c each).

    The ELUs, the skip's add, the LeakyReLU, the edge softmax, the loss
    and Adam are elementwise or reductions and are left out."""
    total, d = 0, d_in
    for layer, (h, c, how) in enumerate(zip(heads, widths, combine)):
        head = (2 * dense_flops(m, d, c) + (dense_flops(m, d, c) if layer
                                            else 0)
                + 3 * dense_flops(m, c, 2) + 3 * spmm_flops(nnz, c))
        total += h * head
        d = h * c if how == "concat" else c
    return total


def edge_dots_bytes(m: int, n: int, nnz: int, k: int) -> int:
    """Bytes g_vals[e] = ⟨g[row_e], B[col_e]⟩ must move: g (m × k) and B
    (n × k) read once, a row and a column index per edge read and the
    nnz dot products written once."""
    return (m * k + n * k + 3 * nnz) * ELEM


def edge_dots_least_s(m: int, n: int, nnz: int, k: int) -> float:
    """The least time of g_vals on the card: its bytes at the memory's
    peak or its 2·nnz·k operations at the float32 peak, whichever is
    longer."""
    return max(edge_dots_bytes(m, n, nnz, k) / PEAK_HBM_BYTES,
               spmm_flops(nnz, k) / PEAK_FP32_FLOPS)
