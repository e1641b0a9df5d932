"""ELL SpMM: width-bucketed row chunks, with an optional
transposed-pattern backward.

Counterpart of ``flex_tpu.ops.ell_spmm``.  Each row is padded to the
smallest bucket width ≥ its degree; rows longer than the widest bucket
split into several chunks.  Per bucket the product is an exact-f32
multiply-reduce over gathered B rows; chunk partials reach their output
rows through a per-row gather (``chunk1``) plus a small fold of split
rows' extra chunks (``extras``).

The layout is built on the device from a resident CSR; the host supplies
only the static bucket sizes.  Plain PyTorch throughout: in the JAX
package this path is XLA, not a Pallas kernel.

Training: autograd differentiates the plain ops as they stand.  A plan
that carries a ``bwd_plan`` (:func:`with_bwd_plan`) instead computes
g_B = Aᵀ·g with the transposed pattern's own ELL forward.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, resident_csr

# Width ladder (~1.2x steps): padding rows are gathered like real ones, so
# bucket granularity sets the padding overhead.
DEFAULT_WIDTHS = (
    2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64,
    80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768,
    896, 1024, 1280, 1536, 1792, 2048,
)


def host_bucket_sizes(deg: np.ndarray, widths: tuple[int, ...]):
    """Static bucket sizes from a host degree array: returns
    (chunks_by_width dict, n_rows_last, padded_nnz)."""
    wmax = widths[-1]
    w_arr = np.asarray(widths, dtype=np.int64)
    wor = w_arr[np.minimum(np.searchsorted(w_arr, np.maximum(deg, 1)),
                           len(w_arr) - 1)]
    wor = np.where(deg > wmax, wmax, wor)
    n_chunks = np.where(deg > 0, -(-deg // wor), 0)
    by_w, padded, n_rows_last = {}, 0, 0
    for w in widths:
        mask = (wor == w) & (deg > 0)
        nc = int(n_chunks[mask].sum())
        if nc == 0:
            continue
        if w == wmax:
            n_rows_last = int(mask.sum())
        by_w[int(w)] = nc
        padded += nc * w
    return by_w, n_rows_last, padded


def ell_meta(deg: np.ndarray, widths: tuple[int, ...] = DEFAULT_WIDTHS):
    """Static layout of the buckets: (wmax, widths, ((w, n_chunks), ...),
    n_rows_last), plus the padded nnz."""
    by_w, n_rows_last, padded = host_bucket_sizes(
        np.asarray(deg, dtype=np.int64), widths)
    return (widths[-1], tuple(widths), tuple(by_w.items()), n_rows_last), padded


def _chunk_order(deg: torch.Tensor, widths) -> torch.Tensor:
    """One stable m-sized sort grouping rows by width bucket (empty rows
    last)."""
    w_arr = torch.tensor(widths, dtype=torch.int64, device=deg.device)
    wi = torch.searchsorted(w_arr, deg.clamp_min(1)).clamp_max(len(widths) - 1)
    wi = torch.where(deg > 0, wi, len(widths))
    return torch.sort(wi, stable=True).indices


def _bucket_layouts(row_ptr, deg, order, meta):
    """Per width bucket: (w, rows_b, starts, lengths).  Rows longer than
    the widest bucket expand to consecutive chunks."""
    wmax, _, bucket_meta, n_rows_last = meta
    dev = row_ptr.device
    off = 0
    for w, N in bucket_meta:
        if w == wmax and n_rows_last != N:
            # split bucket: N chunks come from n_rows_last distinct rows
            rl = order[off:off + n_rows_last]
            c = (deg[rl] + wmax - 1) // wmax
            idx = torch.repeat_interleave(
                torch.arange(n_rows_last, device=dev), c, output_size=N)
            ofs_ex = torch.cumsum(c, 0) - c  # exclusive chunk offset per row
            rows_b = rl[idx]
            local = torch.arange(N, device=dev) - ofs_ex[idx]
            starts = row_ptr[rows_b] + local * wmax
            lengths = (deg[rows_b] - local * wmax).clamp(0, wmax)
            off += n_rows_last
        else:
            rows_b = order[off:off + N]
            starts = row_ptr[rows_b]
            lengths = deg[rows_b].clamp_max(w)
            off += N
        yield w, rows_b, starts, lengths


def gather_chunks(col_pad, val_pad, starts, lengths, w: int):
    """One bucket's (cols i32 [N, w], vals f32 [N, w]): chunk c is the
    w-wide CSR run from ``starts[c]``, masked past ``lengths[c]`` (pads:
    column 0, value 0).  ``col_pad``/``val_pad`` are the CSR arrays with at
    least w trailing zeros, so a run may start at nnz."""
    ar = torch.arange(w, device=col_pad.device)
    idx = starts.long()[:, None] + ar
    mask = ar < lengths[:, None]
    return (torch.where(mask, col_pad[idx], 0),
            torch.where(mask, val_pad[idx], 0.0))


def ell_buckets_core(row_ptr, col, vals, *, meta):
    """Bucket arrays from a device CSR: returns (((cols i32 [N,w],
    vals f32 [N,w]), ...), chunk_row i32).  A bucket's chunk is a w-wide
    gather from ``starts[:, None] + arange(w)`` (each chunk's nnz are
    contiguous in CSR order), masked past its length."""
    wmax, widths, bucket_meta, _ = meta
    dev = col.device
    if not bucket_meta:  # empty residue
        return (), torch.zeros(0, dtype=torch.int32, device=dev)
    row_ptr = row_ptr.long()
    deg = row_ptr[1:] - row_ptr[:-1]
    order = _chunk_order(deg, widths)
    col_pad = torch.cat([col, col.new_zeros(wmax)])
    val_pad = torch.cat([vals, vals.new_zeros(wmax)])

    buckets, rows_parts = [], []
    for w, rows_b, starts, lengths in _bucket_layouts(row_ptr, deg, order,
                                                      meta):
        buckets.append(gather_chunks(col_pad, val_pad, starts, lengths, w))
        rows_parts.append(rows_b)
    return tuple(buckets), torch.cat(rows_parts).to(torch.int32)


def _gather_assembly_tables(chunk_row: torch.Tensor, *, m: int,
                            n_extras: int):
    """``chunk1[r]`` = row r's first chunk (sentinel n_chunks = no chunk);
    with split rows also (extra_idx, extra_first): the non-first chunks and
    the first chunk of their row, folded in before the gather."""
    n_chunks = chunk_row.shape[0]
    dev = chunk_row.device
    idx = torch.arange(n_chunks, device=dev)
    rows = chunk_row.long()
    chunk1 = torch.full((m,), n_chunks, dtype=torch.int64, device=dev)
    chunk1.scatter_reduce_(0, rows, idx, reduce="amin", include_self=True)
    if n_extras == 0:
        return chunk1.to(torch.int32), None
    extra_idx = idx[chunk1[rows] != idx]
    extra_first = chunk1[rows[extra_idx]]
    return chunk1.to(torch.int32), (extra_idx.to(torch.int32),
                                    extra_first.to(torch.int32))


def _ell_spmm(buckets, chunk_row, B, *, m, max_gather_rows, into=None,
              chunk1=None, extras=None):
    """buckets: tuple of (cols [N,w] i32, vals [N,w] f32), one per width.
    chunk_row: i32[total_chunks] output row per chunk (bucket-major).
    into: optional (m, k) f32 accumulator; it is updated IN PLACE and
      returned (the windowed call passes its own dense half, which saves
      an (m, k) temporary).
    ``max_gather_rows`` bounds the (N, w, k) gather temporary by splitting
    each bucket into sub-batches of ~max_gather_rows gathered rows."""
    k = B.shape[1]
    if into is not None and tuple(into.shape) != (m, k):
        raise ValueError(f"into shape {tuple(into.shape)} != ({m}, {k})")
    if not buckets:  # zero-nnz residue
        return into if into is not None else B.new_zeros((m, k))
    parts = []
    for cols, vals in buckets:
        N, w = cols.shape
        step = max(1, max_gather_rows // w)
        for s in range(0, N, step):
            c = cols[s:s + step]
            v = vals[s:s + step]
            Bg = B.index_select(0, c.reshape(-1)).view(c.shape[0], w, k)
            parts.append((v[:, :, None] * Bg).sum(dim=1))
    partial = torch.cat(parts)
    if chunk1 is None:
        if into is not None:
            return into.index_add_(0, chunk_row, partial)
        return B.new_zeros((m, k)).index_add_(0, chunk_row, partial)
    if extras is not None:
        ei, ef = extras
        partial.index_add_(0, ef, partial.index_select(0, ei))
    n_chunks = partial.shape[0]
    live = chunk1 < n_chunks
    res = torch.where(live[:, None],
                      partial.index_select(0, torch.where(live, chunk1, 0)),
                      0.0)
    return into.add_(res) if into is not None else res


@dataclasses.dataclass
class EllPlan:
    m: int
    buckets: tuple       # ((cols [N,w] i32, vals [N,w] f32), ...)
    chunk_row: torch.Tensor
    padded_nnz: int
    nnz: int
    max_gather_rows: int = 2 * 1024 * 1024
    chunk1: torch.Tensor | None = None  # i32[m] row -> first chunk
    extras: tuple | None = None         # (extra_idx, extra_first) split rows
    bwd_plan: "EllPlan | None" = None   # transposed pattern (training)

    def __call__(self, B: torch.Tensor, into: torch.Tensor | None = None
                 ) -> torch.Tensor:
        if self.bwd_plan is not None:
            return _EllApply.apply(self, B, into)
        return _ell_raw_call(self, B, into)


def _ell_raw_call(plan: EllPlan, B, into):
    return _ell_spmm(plan.buckets, plan.chunk_row, B, m=plan.m,
                     max_gather_rows=plan.max_gather_rows, into=into,
                     chunk1=plan.chunk1, extras=plan.extras)


class _EllApply(torch.autograd.Function):
    """``plan(B, into)`` with g_B = ``plan.bwd_plan(g)`` (A_resᵀ·g through
    the ELL forward of the transposed pattern) in place of autograd's
    scatter-add over the padded gathered rows; counterpart of the JAX
    package's ``_ell_apply_cv`` / ``_ell_apply_cv0``.  The cotangent of
    ``into`` is g; the plan gets none, so gradients wrt A's values are not
    propagated here (attach a ``bwd_plan`` only when A is a constant)."""

    @staticmethod
    def forward(ctx, plan, B, into):
        ctx.plan = plan
        ctx.has_into = into is not None
        if ctx.has_into:
            ctx.mark_dirty(into)  # the accumulator is updated in place
        return _ell_raw_call(plan, B, into)

    @staticmethod
    def backward(ctx, g):
        g_B = ctx.plan.bwd_plan(g.contiguous()) \
            if ctx.needs_input_grad[1] else None
        return None, g_B, g if ctx.has_into else None


def prepare_ell_device(row_ptr_dev, col_dev, vals_dev, *, m: int, nnz: int,
                       res_row_ptr_host: np.ndarray,
                       widths: tuple[int, ...] = DEFAULT_WIDTHS) -> EllPlan:
    """An :class:`EllPlan` from device CSR tensors: the host computes only
    the static bucket sizes from its copy of the row_ptr."""
    deg = np.diff(np.asarray(res_row_ptr_host, dtype=np.int64))
    meta, padded = ell_meta(deg, widths)
    buckets, chunk_row = ell_buckets_core(row_ptr_dev, col_dev, vals_dev,
                                          meta=meta)
    chunk1 = extras = None
    if buckets:
        n_extras = int(chunk_row.shape[0]) - int((deg > 0).sum())
        chunk1, extras = _gather_assembly_tables(chunk_row, m=m,
                                                 n_extras=n_extras)
    return EllPlan(m=m, buckets=buckets, chunk_row=chunk_row,
                   padded_nnz=padded, nnz=nnz, chunk1=chunk1, extras=extras)


def prepare_ell_transpose(plan: EllPlan, n: int) -> EllPlan:
    """Transposed-pattern EllPlan built on the device from ``plan``'s own
    buckets (so it works for the windowed hybrid's residue, whose CSR never
    exists as arrays of its own): flatten the padded (col, val, row)
    triples, sort by col, and feed the transposed CSR to
    :func:`prepare_ell_device`.  Padding entries ride along as (col 0,
    val 0) and count into transposed row 0's degree, as in the JAX
    package.  One O(n) device-to-host copy (the transposed row_ptr) is the
    only transfer."""
    if not plan.buckets:
        return EllPlan(m=n, buckets=(), padded_nnz=0, nnz=0,
                       chunk_row=plan.chunk_row.new_zeros(0))
    cols = torch.cat([c.reshape(-1) for c, _ in plan.buckets])
    vals = torch.cat([v.reshape(-1) for _, v in plan.buckets])
    offs, rows_parts = 0, []
    for c, _ in plan.buckets:
        N, w = c.shape
        rows_parts.append(plan.chunk_row[offs:offs + N].repeat_interleave(w))
        offs += N
    rows = torch.cat(rows_parts)
    t_row_ptr = torch.cat([cols.new_zeros(1, dtype=torch.int64), torch.cumsum(
        torch.bincount(cols, minlength=n), 0)])
    order = torch.sort(cols, stable=True).indices
    return prepare_ell_device(
        t_row_ptr, rows[order], vals[order], m=n, nnz=int(cols.shape[0]),
        res_row_ptr_host=t_row_ptr.cpu().numpy())


def with_bwd_plan(plan: EllPlan, n: int) -> EllPlan:
    """Copy of ``plan`` carrying the transposed-pattern backward plan
    (``n`` = B's row count); its call then goes through :class:`_EllApply`.
    Only valid when A's values are constants (a graph adjacency)."""
    return dataclasses.replace(plan, bwd_plan=prepare_ell_transpose(plan, n))


def prepare_ell(g: CSRGraph, dev: DeviceCSR | None = None,
                device=None) -> EllPlan:
    """Host: O(m) static bucket sizes.  Device: every bucket array."""
    dev = resident_csr(g, dev, device)
    return prepare_ell_device(dev.row_ptr, dev.col, dev.vals, m=g.m,
                              nnz=g.nnz, res_row_ptr_host=g.row_ptr)
