"""The yardstick's arithmetic of GAT's edge scores and edge softmax (one
head), counted as :mod:`spmm_bench.arith` counts: what the data needs
once.  The work is a few operations an edge (an add, the LeakyReLU, a
maximum, an exp, a sum and a division forward; a few products and sums
backward), under a twentieth of the bytes' time at the float32 peak, so
the bytes bound it."""
from __future__ import annotations

from spmm_bench.arith import ELEM, PEAK_HBM_BYTES


def edge_softmax_bytes(m: int, n: int, nnz: int) -> int:
    """The forward's bytes: s_src (m) and s_dst (n) read once, a column
    index an edge read and alpha (nnz) written once."""
    return (m + n + 2 * nnz) * ELEM


def edge_softmax_bwd_bytes(m: int, n: int, nnz: int) -> int:
    """The backward's bytes: alpha, its gradient and a column index an edge
    read, s_src and s_dst read, and the gradients in s_src (m) and s_dst
    (n) written once."""
    return (2 * m + 2 * n + 3 * nnz) * ELEM


def edge_softmax_least_s(m: int, n: int, nnz: int,
                         backward: bool = False) -> float:
    """The least time of one head's forward (or ``backward``) on the card:
    its bytes at the memory's peak."""
    by = edge_softmax_bwd_bytes if backward else edge_softmax_bytes
    return by(m, n, nnz) / PEAK_HBM_BYTES
