"""GAT's per-edge attention: one head's edge scores and their row-wise
softmax over the dynamic-value SpMM's pattern, forward and backward.

With the score vectors s_src = H·W·a_src (m) and s_dst = H·W·a_dst (n),
for every CSR edge e = (i, j):

    z_e = s_src[i] + s_dst[j],   a_e = LeakyReLU(z_e),
    α_e = exp(a_e − max_i) / Σ over row i of exp(a − max_i)

and from dα:  t_i = Σ over row i of α·dα,  dz_e = α_e·(dα_e − t_i)·(z_e > 0
? 1 : slope),  d s_src[i] = Σ over row i of dz,  d s_dst[j] = Σ over
column j of dz.

CUDA tensors run it on a hand-written kernel pair, ``csrc/edge_softmax.cu``
(a warp a CSR row of at most :data:`WARP_EDGES` edges, a block a longer
one; the backward's column sums over the plan's transposed order, split
the same way): :func:`edge_attention_rows` launches the forward once a
head, and :func:`edge_attention_rows_bwd` the backward's two kernels,
counted in their ``launches``; nothing is read on the host, no atomics,
and two launches give the same bits.  CPU tensors take the plain versions, counted
in ``plain_calls``: :func:`edge_attention_plain` (the gathers, LeakyReLU
and :func:`segment_softmax_plain`, the JAX package's composition) and
:func:`edge_attention_bwd_plain` (the formulas above in torch ops).

The functions read the pattern from ``plan``, a
:class:`.dyn_ell.DynEllPlan`: ``row_ptr``, ``cols``, ``rows`` and
``long_rows`` (CSR order), ``col_ptr``, ``perm`` and ``long_cols`` (the
transposed order).
"""
from __future__ import annotations

import torch

# the longest row (column) the kernels give a warp; a longer one is a
# block's, and the plan lists it (:func:`long_runs`)
WARP_EDGES = 256


def long_runs(ptr: torch.Tensor) -> torch.Tensor:
    """The runs ``ptr[i] .. ptr[i + 1]`` longer than :data:`WARP_EDGES`
    (i32, ascending), read once on the host when a plan is built."""
    return torch.nonzero(ptr[1:] - ptr[:-1] > WARP_EDGES).flatten().to(
        torch.int32)


def segment_softmax_plain(rows, deg, e) -> torch.Tensor:
    """Row-wise max-shifted softmax of CSR-order edge scores e[nnz] (rows:
    i64 [nnz] row ids, deg: i64 [m] row lengths) -> alpha[nnz].  The
    maximum is detached (the softmax does not change under a shift); the
    row sums are a segment reduction over the CSR runs, which sums each row
    in a fixed order.  Rows with no edges are never gathered, so their -inf
    maximum never propagates."""
    mx = torch.full((deg.shape[0],), float("-inf"), dtype=e.dtype,
                    device=e.device)
    mx = mx.scatter_reduce(0, rows, e.detach(), reduce="amax")
    ex = torch.exp(e - mx.index_select(0, rows))
    s = torch.segment_reduce(ex, "sum", lengths=deg)
    return ex / s.index_select(0, rows)


def edge_attention_plain(plan, s_src, s_dst,
                         negative_slope: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_attention_rows`: the scores
    gathered at the edges' endpoints, LeakyReLU, then
    :func:`segment_softmax_plain` (f32 [nnz], CSR order; differentiable)."""
    e = torch.nn.functional.leaky_relu(
        s_src.index_select(0, plan.rows)
        + s_dst.index_select(0, plan.cols), negative_slope)
    deg = (plan.row_ptr[1:] - plan.row_ptr[:-1]).long()
    return segment_softmax_plain(plan.rows, deg, e)


def edge_attention_bwd_plain(plan, alpha, g_alpha, s_src, s_dst,
                             negative_slope: float):
    """Plain PyTorch version of :func:`edge_attention_rows_bwd`: the
    module's backward formulas, the row and column sums by ``index_add_``.
    Returns (d s_src f32 [m], d s_dst f32 [n])."""
    rows, cols = plan.rows, plan.cols.long()
    z = s_src.index_select(0, rows) + s_dst.index_select(0, cols)
    t = alpha.new_zeros(plan.m).index_add_(0, rows, alpha * g_alpha)
    de = alpha * (g_alpha - t.index_select(0, rows))
    dz = torch.where(z > 0, de, de * negative_slope)
    return (alpha.new_zeros(plan.m).index_add_(0, rows, dz),
            alpha.new_zeros(plan.n).index_add_(0, cols, dz))


def _check(plan, **floats) -> bool:
    """A call's checks: each of ``floats`` (name -> (tensor, length)) f32,
    1-D of its length and on the plan's device.  True if the call launches
    the kernels (the card: each also contiguous), False for CPU tensors;
    any other device raises."""
    device = plan.cols.device
    for name, (x, n) in floats.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} lies on {x.device}, the plan on "
                             f"{device}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no edge-softmax kernel for device {device}")
    for name, (x, _) in floats.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def edge_attention_rows(plan, s_src, s_dst,
                        negative_slope: float) -> torch.Tensor:
    """alpha (f32 [nnz], CSR order): the row-wise softmax of the LeakyReLU
    edge scores of s_src (f32 [m]) and s_dst (f32 [n]).  CUDA tensors
    launch ``csrc/edge_softmax.cu``'s forward once (counted in
    ``edge_attention_rows.launches``); CPU tensors take
    :func:`edge_attention_plain` (counted in ``.plain_calls``).  A wrong
    shape, dtype or device raises."""
    if not _check(plan, s_src=(s_src, plan.m), s_dst=(s_dst, plan.n)):
        edge_attention_rows.plain_calls += 1
        return edge_attention_plain(plan, s_src, s_dst, negative_slope)
    from flex_tpu_torch import kernels

    alpha = torch.empty(plan.nnz, dtype=torch.float32, device=s_src.device)
    kernels.launch("edge_softmax", "flex_edge_softmax_fwd", s_src.device,
                   plan.row_ptr.data_ptr(), plan.cols.data_ptr(),
                   plan.long_rows.data_ptr(), plan.long_rows.shape[0],
                   WARP_EDGES, s_src.data_ptr(), s_dst.data_ptr(),
                   alpha.data_ptr(), plan.m, float(negative_slope))
    edge_attention_rows.launches += 1
    return alpha


edge_attention_rows.launches = 0
edge_attention_rows.plain_calls = 0


def edge_attention_rows_bwd(plan, alpha, g_alpha, s_src, s_dst,
                            negative_slope: float):
    """(d s_src f32 [m], d s_dst f32 [n]) from alpha and its gradient
    g_alpha (f32 [nnz], CSR order).  CUDA tensors launch
    ``csrc/edge_softmax.cu``'s backward (its row kernel, which writes dz
    into an nnz-long scratch, then its column kernel; one call counted in
    ``edge_attention_rows_bwd.launches``); CPU tensors take
    :func:`edge_attention_bwd_plain` (counted in ``.plain_calls``).  A
    wrong shape, dtype or device raises."""
    if not _check(plan, alpha=(alpha, plan.nnz), g_alpha=(g_alpha, plan.nnz),
                  s_src=(s_src, plan.m), s_dst=(s_dst, plan.n)):
        edge_attention_rows_bwd.plain_calls += 1
        return edge_attention_bwd_plain(plan, alpha, g_alpha, s_src, s_dst,
                                        negative_slope)
    from flex_tpu_torch import kernels

    dev = alpha.device
    dz = torch.empty(plan.nnz, dtype=torch.float32, device=dev)
    d_src = torch.empty(plan.m, dtype=torch.float32, device=dev)
    d_dst = torch.empty(plan.n, dtype=torch.float32, device=dev)
    kernels.launch("edge_softmax", "flex_edge_softmax_bwd", dev,
                   plan.row_ptr.data_ptr(), plan.cols.data_ptr(),
                   plan.long_rows.data_ptr(), plan.long_rows.shape[0],
                   plan.col_ptr.data_ptr(), plan.long_cols.data_ptr(),
                   plan.long_cols.shape[0], WARP_EDGES, plan.perm.data_ptr(),
                   alpha.data_ptr(), g_alpha.data_ptr(), s_src.data_ptr(),
                   s_dst.data_ptr(), dz.data_ptr(), d_src.data_ptr(),
                   d_dst.data_ptr(), plan.m, plan.n, float(negative_slope))
    edge_attention_rows_bwd.launches += 1
    return d_src, d_dst


edge_attention_rows_bwd.launches = 0
edge_attention_rows_bwd.plain_calls = 0
