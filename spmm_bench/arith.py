"""The yardstick's arithmetic: published peaks, the operations and bytes
each piece of work needs, and the statistics the metrics take.

Counts are of the problem, not of any implementation: an SpMM needs
2·nnz·k operations and reads A's CSR (a column index and a value per
nonzero, a row pointer per row), B and writes C once, whatever a format
pads or re-reads.  A dense product X[m, d]·W[d, c] needs 2·m·d·c.
"""
from __future__ import annotations

import statistics

# NVIDIA H100 SXM5 80 GB, data sheet, dense, at its full 700 W limit
PEAK_FP32_FLOPS = 67e12   # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # HBM3 bytes a second
ELEM = 4                  # bytes of a float32 or an int32


def spmm_flops(nnz: int, k: int) -> int:
    """Operations of C = A·B with ``nnz`` nonzeros and ``k`` columns."""
    return 2 * nnz * k


def spmm_bytes(m: int, n: int, nnz: int, k: int) -> int:
    """Bytes an SpMM must move: A's CSR (nnz column indices and values,
    m + 1 row pointers), B (n × k) read once and C (m × k) written once."""
    return nnz * 2 * ELEM + (m + 1) * ELEM + n * k * ELEM + m * k * ELEM


def spmm_least_s(m: int, n: int, nnz: int, k: int) -> float:
    """The least time the card could take: bytes at the memory's peak or
    operations at the float32 peak, whichever is longer."""
    return max(spmm_bytes(m, n, nnz, k) / PEAK_HBM_BYTES,
               spmm_flops(nnz, k) / PEAK_FP32_FLOPS)


def dense_flops(m: int, d: int, c: int) -> int:
    """Operations of an [m, d]·[d, c] product."""
    return 2 * m * d * c


def gcn_forward_flops(m: int, nnz: int, d_in: int, d_hidden: int,
                      n_classes: int) -> int:
    """A 2-layer GCN forward, A·(X·W1) then A·(H·W2): two dense products
    and two SpMMs at the layers' output widths (bias and relu left out)."""
    return (dense_flops(m, d_in, d_hidden) + spmm_flops(nnz, d_hidden)
            + dense_flops(m, d_hidden, n_classes)
            + spmm_flops(nnz, n_classes))


def gcn_train_step_flops(m: int, nnz: int, d_in: int, d_hidden: int,
                         n_classes: int) -> int:
    """A full-graph training step: the forward, then the backward's two
    transposed SpMMs (at the same widths), W1's and W2's gradients
    (2·m·d·c each) and the gradient through W2 into H (2·m·d_hidden·c).
    X needs no gradient.  Adam's elementwise work is left out."""
    return (gcn_forward_flops(m, nnz, d_in, d_hidden, n_classes)
            + spmm_flops(nnz, d_hidden) + spmm_flops(nnz, n_classes)
            + dense_flops(m, d_in, d_hidden)
            + 2 * dense_flops(m, d_hidden, n_classes))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``, linear between the
    two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
