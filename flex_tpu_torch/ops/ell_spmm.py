"""ELL SpMM forward: width-bucketed row chunks.

Counterpart of ``flex_tpu.ops.ell_spmm``.  Each row is padded to the
smallest bucket width ≥ its degree; rows longer than the widest bucket
split into several chunks.  Per bucket the product is an exact-f32
multiply-reduce over gathered B rows; chunk partials reach their output
rows through a per-row gather (``chunk1``) plus a small fold of split
rows' extra chunks (``extras``).

The layout is built on the device from a resident CSR; the host supplies
only the static bucket sizes.  Plain PyTorch throughout: in the JAX
package this path is XLA, not a Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, plan_device

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
        ar = torch.arange(w, device=dev)
        idx = starts[:, None] + ar
        mask = ar < lengths[:, None]
        buckets.append((torch.where(mask, col_pad[idx], 0),
                        torch.where(mask, val_pad[idx], 0.0)))
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

    def __call__(self, B: torch.Tensor, into: torch.Tensor | None = None
                 ) -> torch.Tensor:
        return _ell_spmm(self.buckets, self.chunk_row, B, m=self.m,
                         max_gather_rows=self.max_gather_rows, into=into,
                         chunk1=self.chunk1, extras=self.extras)


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


def prepare_ell(g: CSRGraph, dev: DeviceCSR | None = None,
                device=None) -> EllPlan:
    """Host: O(m) static bucket sizes.  Device: every bucket array."""
    if dev is None:
        dev = DeviceCSR.from_graph(g, device)
    else:
        plan_device(dev, device)
    return prepare_ell_device(dev.row_ptr, dev.col, dev.vals, m=g.m,
                              nnz=g.nnz, res_row_ptr_host=g.row_ptr)
