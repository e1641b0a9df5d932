"""Dynamic-value SpMM: a static sparsity pattern, fresh edge values per
call, differentiable in both.

Counterpart of ``flex_tpu.ops.dyn_ell``: C = A(vals) · B, where ``vals``
(length nnz, CSR order) is an argument with a gradient.  Attention GNNs
(GAT) recompute the edge values every forward pass, so their pattern is
fixed but their values are not.

The JAX package assembles width-bucketed ELL value matrices from ``vals``
at every call, which costs it about twice the static ELL call.  Here no
assembly is needed: a CSR row's nonzeros are already one contiguous run,
so the row-unit kernel (:func:`.gespmm.gespmm_rows`, ``csrc/gespmm.cu``)
reads the resident CSR itself, with ``vals`` swapped in as its value
store.  Its tables (chunk r = row r at ``row_ptr[r]``, ``deg[r]`` long) are
built once at prepare time.

Backward (:class:`_DynSpmm`):
  - g_B = A(vals)ᵀ · g runs on the same kernel over the transposed
    pattern, whose tables and permutation ``perm`` (a stable sort of the
    edges by column) are built once; per call its values are
    ``vals[perm]``.
  - g_vals[e] = ⟨g[row_e], B[col_e]⟩ (:func:`edge_dots_rows`; the JAX
    package gets it from autodiff of XLA gathers, with no Pallas kernel)
    runs on the card in one launch of ``csrc/edge_dots.cu`` over the
    forward's tables: a unit's lanes hold g[row] in registers and read
    each B[col] straight from memory, so nothing nnz × k is built.

GAT's edge scores and softmax over the same pattern
(:meth:`DynEllPlan.edge_attention`, :class:`_EdgeAttention`) run on the
kernel pair of :mod:`.edge_softmax`, which reads the CSR's ``row_ptr``
and, for the backward's column sums, the transposed order's ``col_ptr``
and ``perm``.

CPU tensors take the kernels' plain versions (:func:`.gespmm.gespmm_rows`,
:func:`edge_dots_rows` and :mod:`.edge_softmax`'s wrappers dispatch on the
device); g_vals' is :func:`edge_dots_plain`, torch gathers in sub-batches
of edges.

Spans (:mod:`.utils.trace`): each kernel-7 call, forward and g_B, is a
``flex.spmm`` span (m, n, nnz, k: its output rows, B's rows, the
nonzeros, the width) and g_vals is a ``flex.edge_dots`` span (nnz, k);
the attention's forward is a ``flex.edge_softmax`` span and its backward
a ``flex.edge_softmax.bwd`` span (m, nnz), all with device seconds as the
ELL plan's ``flex.spmm``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.edge_softmax import (
    edge_attention_rows, edge_attention_rows_bwd, long_runs,
)
from flex_tpu_torch.ops.ell_spmm import DEFAULT_WIDTHS
from flex_tpu_torch.ops.gespmm import (
    RowTables, check_call, gespmm_rows, row_tables, rows_layout,
)
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import (
    DeviceCSR, resident_csr, rows_from_row_ptr,
)
from flex_tpu_torch.utils import trace as _trace


def _spmm_attrs(m: int, n: int, nnz: int, B):
    """A kernel-7 call's ``flex.spmm`` span: B's device, and the attrs of
    the ELL plan's span but its gather dtype."""
    return B.device, {"m": m, "n": n, "nnz": nnz, "k": B.shape[1]}


def _dots_attrs(nnz: int, g):
    """The ``flex.edge_dots`` span: g's device, the edges and the width."""
    return g.device, {"nnz": nnz, "k": g.shape[1]}


def _softmax_attrs(m: int, nnz: int, x):
    """The ``flex.edge_softmax`` spans: x's device, the rows and edges."""
    return x.device, {"m": m, "nnz": nnz}


@dataclasses.dataclass
class DynEllPlan:
    """The static structure; ``plan(vals, B)`` is A(vals) · B with fresh
    edge values (CSR order, length nnz)."""

    m: int
    n: int
    nnz: int
    rows: torch.Tensor   # i64 [nnz] CSR-order row ids
    cols: torch.Tensor   # i32 [nnz] CSR-order column ids (the CSR's own)
    fwd: RowTables       # over the CSR, its values; each call gives its own
    bwd: RowTables       # over the transposed pattern; no value store: each
    #                      call gives vals[perm]
    perm: torch.Tensor   # i64 [nnz]: transposed entry t is CSR entry perm[t]
    row_ptr: torch.Tensor  # i32 [m + 1]: row i is CSR entries row_ptr[i] ..
    #                        row_ptr[i + 1]
    col_ptr: torch.Tensor  # i32 [n + 1]: column j is transposed entries
    #                        col_ptr[j] .. col_ptr[j + 1]
    long_rows: torch.Tensor  # i32: the rows and the columns the edge-
    long_cols: torch.Tensor  # softmax kernels give a block (long_runs)
    max_gather_rows: int = 2 * 1024 * 1024

    def __call__(self, vals: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        if B.dim() != 2 or B.shape[0] != self.n:
            raise ValueError(f"B must be ({self.n}, k), got "
                             f"{tuple(B.shape)}")
        return _DynSpmm.apply(self, vals, B)

    def edge_dots(self, g: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """⟨g[row_e], B[col_e]⟩ for every edge e (f32 [nnz], CSR order):
        :func:`edge_dots_rows` on the forward's tables, the
        ``flex.edge_dots`` span."""
        if B.dim() != 2 or B.shape[0] != self.n:
            raise ValueError(f"B must be ({self.n}, k), got "
                             f"{tuple(B.shape)}")
        with _trace.span("flex.edge_dots", _dots_attrs, self.nnz, g) as sp:
            sp.begin()
            return edge_dots_rows(self.fwd, self.rows, g, B,
                                  self.max_gather_rows)

    def edge_attention(self, s_src: torch.Tensor, s_dst: torch.Tensor,
                       negative_slope: float = 0.2) -> torch.Tensor:
        """GAT's attention weights alpha (f32 [nnz], CSR order): the
        row-wise softmax of LeakyReLU(s_src[row] + s_dst[col]) for the
        score vectors s_src (f32 [m]) and s_dst (f32 [n]), differentiable
        in both (:class:`_EdgeAttention`, on :mod:`.edge_softmax`'s
        kernels for CUDA tensors and its plain versions for CPU
        tensors)."""
        return _EdgeAttention.apply(self, s_src, s_dst, negative_slope)


def edge_dots_layout(k: int) -> tuple[int, int]:
    """How the edge-dot kernel spreads a unit over a warp at width ``k``:
    (lanes G, kernel 7's :func:`.gespmm.rows_layout`: a whole warp at
    k > 64, else the smallest power of two with 4·G ≥ k; width, the columns
    a lane holds in each pass of G·width columns: 8 at 32 lanes and
    k > 128, so that k = 256 is one pass, else 4)."""
    lanes = rows_layout(k)[0]
    return lanes, 8 if lanes == 32 and k > 128 else 4


def edge_dots_plain(rows, cols, g, B,
                    max_gather_rows: int = 2 * 1024 * 1024) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_dots_rows`: g[rows] and B[cols]
    gathered in sub-batches of about ``max_gather_rows`` edges, multiplied
    and summed along k (f32 [len(rows)])."""
    if g.shape[1] % 4 == 0:
        # rows of a multiple of 16 bytes take PyTorch's vectorized row
        # gather, which on the card is several times slower on narrow rows
        # than the element gather of the same rows with a zero column added
        # (chip_smoke.py's [gat] line times both); the zero adds nothing to
        # the dot products
        g = torch.nn.functional.pad(g, (0, 1))
        B = torch.nn.functional.pad(B, (0, 1))
    nnz = rows.shape[0]
    out = g.new_empty(nnz)
    step = max(1, max_gather_rows)
    for s in range(0, nnz, step):
        r = rows[s:s + step]
        c = cols[s:s + step].long()
        out[s:s + step] = (g.index_select(0, r)
                           * B.index_select(0, c)).sum(1)
    return out


def edge_dots_rows(t: RowTables, rows: torch.Tensor, g: torch.Tensor,
                   B: torch.Tensor,
                   max_gather_rows: int = 2 * 1024 * 1024) -> torch.Tensor:
    """out[e] = ⟨g[rows[e]], B[t.cols[e]]⟩ for every entry e of ``t``'s
    store (f32 [T]), whose units cover it whole, as the dynamic plan's
    forward tables do; ``rows`` (i64 [T]) names each entry's row, g is
    f32 [t.m, k] and B f32 [n, k].

    CUDA tensors launch ``csrc/edge_dots.cu`` once (counted in
    ``edge_dots_rows.launches``; at k ≤ 64, in lane groups, also in
    ``.grouped_launches``), with the lanes of :func:`edge_dots_layout`:
    16-byte loads of g and B when k % 4 == 0 and both are aligned, else
    scalar loads; the sums' order is fixed by k, so two launches give the
    same bits; at k = 0 nothing is launched and the dots are 0.  CPU
    tensors take :func:`edge_dots_plain` (counted in ``.plain_calls``).
    Anything else raises."""
    if g.dim() != 2 or B.dim() != 2 or g.shape[1] != B.shape[1]:
        raise ValueError(f"g and B must be 2-D and of one width, got "
                         f"{tuple(g.shape)} and {tuple(B.shape)}")
    T, k = t.cols.shape[0], g.shape[1]
    if g.shape[0] != t.m:
        raise ValueError(f"g must have the tables' {t.m} rows, got "
                         f"{g.shape[0]}")
    if tuple(rows.shape) != (T,):
        raise ValueError(f"rows must have shape ({T},), got "
                         f"{tuple(rows.shape)}")
    if not check_call(t, "edge-dot", B, g=g, B=B):
        edge_dots_rows.plain_calls += 1
        return edge_dots_plain(rows, t.cols, g, B, max_gather_rows)
    if k == 0:  # empty dot products: the kernel would write nothing
        return torch.zeros(T, dtype=torch.float32, device=g.device)
    from flex_tpu_torch import kernels

    lanes, width = edge_dots_layout(k)
    out = torch.empty(T, dtype=torch.float32, device=g.device)
    kernels.launch("edge_dots", "flex_edge_dots", g.device,
                   t.cols.data_ptr(), t.row_start.data_ptr(),
                   t.units.data_ptr(), g.data_ptr(), B.data_ptr(),
                   out.data_ptr(), t.units.shape[0], k, lanes, width)
    edge_dots_rows.launches += 1
    edge_dots_rows.grouped_launches += lanes < 32
    return out


edge_dots_rows.launches = 0
edge_dots_rows.grouped_launches = 0
edge_dots_rows.plain_calls = 0


class _DynSpmm(torch.autograd.Function):
    """A(vals) · B with g_B = A(vals)ᵀ · g on the row-unit kernel and
    g_vals by :meth:`DynEllPlan.edge_dots`."""

    @staticmethod
    def forward(ctx, plan, vals, B):
        vals = vals.to(torch.float32).contiguous()
        B = B.contiguous()
        ctx.plan = plan
        ctx.save_for_backward(vals, B)
        with _trace.span("flex.spmm", _spmm_attrs, plan.m, plan.n,
                         plan.nnz, B) as sp:
            sp.begin()
            return gespmm_rows(plan.fwd, B, vals=vals)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        vals, B = ctx.saved_tensors
        g = g.contiguous()
        g_vals = g_B = None
        if ctx.needs_input_grad[1]:
            g_vals = plan.edge_dots(g, B)
        if ctx.needs_input_grad[2]:
            vals_t = vals.index_select(0, plan.perm)
            with _trace.span("flex.spmm", _spmm_attrs, plan.n, plan.m,
                             plan.nnz, g) as sp:
                sp.begin()
                g_B = gespmm_rows(plan.bwd, g, vals=vals_t)
        return None, g_vals, g_B


class _EdgeAttention(torch.autograd.Function):
    """alpha = softmax over each row of LeakyReLU(s_src[row] + s_dst[col]);
    only alpha is saved, the backward recomputes the scores.  The forward
    is the ``flex.edge_softmax`` span, the backward the
    ``flex.edge_softmax.bwd`` span."""

    @staticmethod
    def forward(ctx, plan, s_src, s_dst, negative_slope):
        ctx.plan, ctx.slope = plan, negative_slope
        with _trace.span("flex.edge_softmax", _softmax_attrs, plan.m,
                         plan.nnz, s_src) as sp:
            sp.begin()
            alpha = edge_attention_rows(plan, s_src, s_dst, negative_slope)
        ctx.save_for_backward(alpha, s_src, s_dst)
        return alpha

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        alpha, s_src, s_dst = ctx.saved_tensors
        with _trace.span("flex.edge_softmax.bwd", _softmax_attrs, plan.m,
                         plan.nnz, g) as sp:
            sp.begin()
            d_src, d_dst = edge_attention_rows_bwd(
                plan, alpha, g.contiguous(), s_src, s_dst, ctx.slope)
        return None, d_src, d_dst, None


def prepare_dyn_ell(g: CSRGraph, dev: DeviceCSR | None = None,
                    widths: tuple[int, ...] = DEFAULT_WIDTHS,
                    device=None) -> DynEllPlan:
    """Build the structure on the device from the resident CSR (``dev``, or
    ``g`` moved to ``device``: CUDA unless the caller names another).
    ``widths`` keeps the JAX signature: the row-unit kernel reads whole
    CSR rows, so no width ladder is needed and it is not read."""
    del widths
    dev = resident_csr(g, dev, device)
    d = dev.device
    m, n, nnz = g.m, g.n, g.nnz
    rows = rows_from_row_ptr(dev.row_ptr, nnz, m)
    deg = (dev.row_ptr[1:] - dev.row_ptr[:-1]).long()
    fwd = row_tables(dev.col, dev.vals, torch.arange(m, device=d),
                     dev.row_ptr[:m], deg, m)
    perm = torch.argsort(dev.col, stable=True)
    deg_t = torch.bincount(dev.col.long(), minlength=n)
    col_ptr = torch.zeros(n + 1, dtype=torch.int64, device=d)
    torch.cumsum(deg_t, 0, out=col_ptr[1:])
    start_t = col_ptr[:n]
    bwd = row_tables(rows.index_select(0, perm).to(torch.int32),
                     dev.vals[:0], torch.arange(n, device=d), start_t,
                     deg_t, n)
    col_ptr = col_ptr.to(torch.int32)
    return DynEllPlan(m=m, n=n, nnz=nnz, rows=rows, cols=dev.col, fwd=fwd,
                      bwd=bwd, perm=perm, row_ptr=dev.row_ptr,
                      col_ptr=col_ptr, long_rows=long_runs(dev.row_ptr),
                      long_cols=long_runs(col_ptr))


def spmm_dyn(g: CSRGraph, vals, B, **kwargs) -> torch.Tensor:
    """One-shot dynamic-value SpMM (prepare + call) on the device of
    ``kwargs`` (CUDA unless ``device`` names another)."""
    plan = prepare_dyn_ell(g, **kwargs)
    d = plan.cols.device

    def t(a):
        return (a if torch.is_tensor(a) else torch.from_numpy(
            np.asarray(a))).to(device=d, dtype=torch.float32)

    return plan(t(vals), t(B))
