"""ELL SpMM: width-bucketed row chunks, with an optional
transposed-pattern backward.

Counterpart of ``flex_tpu.ops.ell_spmm``.  Each row is padded to the
smallest bucket width ≥ its degree; rows longer than the widest bucket
split into several chunks.  Per bucket the product is an exact-f32
multiply-reduce over gathered B rows; chunk partials reach their output
rows through a per-row gather (``chunk1``) plus a small fold of split
rows' extra chunks (``extras``).

The layout is built on the device from a resident CSR; the host supplies
only the static bucket sizes.  The buckets are views of one flat store,
in which a row's chunks are consecutive and full but for the last, so the
plan also carries the row-unit kernel's tables (:class:`.gespmm.RowTables`).
In the JAX package this path is XLA, not a Pallas kernel.  Here CPU
tensors take the plain PyTorch version (:func:`_ell_spmm`, bucket by
bucket as the JAX package does); CUDA tensors run the row-unit kernel of
``csrc/gespmm.cu`` (:func:`.gespmm.gespmm_rows`), all buckets and split
rows in one call, added into ``into`` in place, in a fixed order.

``b_dtype="bfloat16"`` is the JAX package's fast gather mode: B is cast to
bf16 once per call, its rows are gathered in bf16 and their products with
the f32 values are summed in f32 (on the card, kernel 7's bf16 instance);
the output, and ``into``, stay f32.  A plan's transposed backward plan
inherits it.

Training: on the CPU autograd differentiates the plain ops as they
stand.  A plan that carries a ``bwd_plan`` (:func:`with_bwd_plan`, the
transposed pattern without the forward's pad entries) computes g_B = Aᵀ·g
with that pattern's own forward, on the card through the same kernel;
without one the card's first backward builds that plan and keeps it.  A
call through which no gradient can flow (``torch.no_grad()``) skips
autograd.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.gespmm import (
    RowTables, gespmm_rows, row_tables, to_bf16_padded, unit_entries,
)
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import (
    DeviceCSR, dense_operand, resident_csr,
)
from flex_tpu_torch.utils import trace as _trace

# Width ladder (~1.2x steps): padding rows are gathered like real ones, so
# bucket granularity sets the padding overhead.
DEFAULT_WIDTHS = (
    2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64,
    80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768,
    896, 1024, 1280, 1536, 1792, 2048,
)


def ell_padded_nnz(degrees: np.ndarray,
                   widths: tuple[int, ...] = DEFAULT_WIDTHS) -> int:
    """Padded nnz of the width-bucketed layout, from the degrees alone:
    the static input to the autotuner's ELL time model."""
    w_arr = np.asarray(widths, dtype=np.int64)
    deg = degrees[degrees > 0].astype(np.int64)
    if not len(deg):
        return 0
    wor = w_arr[np.minimum(np.searchsorted(w_arr, deg), len(w_arr) - 1)]
    full = deg > w_arr[-1]
    pad = np.where(full, -(-deg // w_arr[-1]) * w_arr[-1], wor)
    return int(pad.sum())


B_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_b_dtype(b_dtype: str) -> None:
    """The gather dtypes of the JAX package: ``"float32"``, and
    ``"bfloat16"``, which casts B once per call, gathers bf16 rows and
    sums their products in f32.  Anything else raises."""
    if b_dtype not in B_DTYPES:
        raise ValueError(f"unknown b_dtype {b_dtype!r}")


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


def ell_meta(deg: np.ndarray, widths: tuple[int, ...] = DEFAULT_WIDTHS,
             bucket_alloc: dict | None = None):
    """Static layout of the buckets: (wmax, widths, ((w, n_alloc, n_real),
    ...), n_rows_last), plus the padded nnz.  ``bucket_alloc`` (width →
    allocated chunk count ≥ the real count) pads every live width of it to
    that count, so the shards of a sharded plan share bucket shapes; pad
    chunks hold no entry and point at row 0."""
    with _trace.setup_span("flex.build.meta"):
        by_w, n_rows_last, padded = host_bucket_sizes(
            np.asarray(deg, dtype=np.int64), widths)
        if bucket_alloc is None:
            bucket_meta = tuple((w, nc, nc) for w, nc in by_w.items())
        else:
            bucket_meta = tuple(
                (int(w), int(bucket_alloc[int(w)]), by_w.get(int(w), 0))
                for w in widths if bucket_alloc.get(int(w), 0) > 0)
            padded = sum(a * w for w, a, _ in bucket_meta)
    return (widths[-1], tuple(widths), bucket_meta, n_rows_last), padded


def ell_scatter_layout(deg: np.ndarray, widths: tuple[int, ...],
                       bucket_alloc: dict | None = None):
    """Host O(m) layout of the scatter-assembled ELL: returns (bucket_meta,
    H, chunk_row, padded_total) where

    - bucket_meta: (w, n_alloc, n_real) per live width, ascending, in
      the enumeration of :func:`host_bucket_sizes` / :func:`_chunk_order`
      (stable by width bucket, row-ascending within one, split rows on
      consecutive chunks);
    - H[r] (int32[m]): row r's first slot in the bucket-major padded flat
      array MINUS its exclusive residue-count prefix, so residue entry i
      lands at ``H[row(i)] + miss_rank(i)`` (a row's chunks are
      w-contiguous, so base + t falls in chunk t//w at offset t%w);
    - chunk_row (int32[total_chunks]): output row per chunk.
    Copy of the JAX package's ``ell_scatter_layout``.  ``bucket_alloc``
    (width → allocated chunk count ≥ the real count, as in
    :func:`ell_meta`) adds pad chunks after each bucket's real ones, which
    point at row 0; every width it names is live."""
    deg = np.asarray(deg, dtype=np.int64)
    m = len(deg)
    wmax = widths[-1]
    w_arr = np.asarray(widths, dtype=np.int64)
    wor = w_arr[np.minimum(np.searchsorted(w_arr, np.maximum(deg, 1)),
                           len(w_arr) - 1)]
    wor = np.where(deg > wmax, wmax, wor)
    live = deg > 0
    bucket_meta = []
    H = np.zeros(m, dtype=np.int64)
    chunk_rows = []
    excl = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(deg, out=excl[1:])  # exclusive residue-count prefix per row
    off = 0
    for w in widths:
        mask = live & (wor == w)
        rows_b = np.nonzero(mask)[0]
        n_chunks_per = -(-deg[rows_b] // w) if w == wmax \
            else np.ones(len(rows_b), dtype=np.int64)
        nc = int(n_chunks_per.sum())
        n_alloc = nc if bucket_alloc is None \
            else int(bucket_alloc.get(int(w), 0))
        if n_alloc < nc:
            raise ValueError(f"bucket_alloc[{w}] = {n_alloc} < {nc} chunks")
        if not n_alloc:
            continue
        bucket_meta.append((int(w), n_alloc, nc))
        base = off + (np.cumsum(n_chunks_per) - n_chunks_per) * w
        H[rows_b] = base - excl[rows_b]
        chunk_rows.append(np.repeat(rows_b, n_chunks_per))
        chunk_rows.append(np.zeros(n_alloc - nc, np.int64))
        off += n_alloc * w
    chunk_row = (np.concatenate(chunk_rows) if chunk_rows
                 else np.zeros(0, np.int64)).astype(np.int32)
    return tuple(bucket_meta), H.astype(np.int32), chunk_row, off


def _chunk_order(deg: torch.Tensor, widths) -> torch.Tensor:
    """One stable m-sized sort grouping rows by width bucket (empty rows
    last)."""
    w_arr = torch.tensor(widths, dtype=torch.int64, device=deg.device)
    wi = torch.searchsorted(w_arr, deg.clamp_min(1)).clamp_max(len(widths) - 1)
    wi = torch.where(deg > 0, wi, len(widths))
    return torch.sort(wi, stable=True).indices


def _bucket_layouts(row_ptr, deg, order, nnz: int, meta):
    """Per width bucket: (w, rows_b, starts, lengths), ``n_alloc`` chunks
    each.  Rows longer than the widest bucket expand to consecutive chunks;
    the ``n_alloc - N`` pad chunks after the real ones start at ``nnz``,
    hold nothing and point at row 0."""
    wmax, _, bucket_meta, n_rows_last = meta
    dev = row_ptr.device
    off = 0
    for w, n_alloc, N in bucket_meta:
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
        if n_alloc > N:
            pad = n_alloc - N
            rows_b = torch.cat([rows_b, rows_b.new_zeros(pad)])
            starts = torch.cat([starts, starts.new_full((pad,), nnz)])
            lengths = torch.cat([lengths, lengths.new_zeros(pad)])
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


def ell_buckets_core(row_ptr, col_dev, vals_dev, *, meta):
    """Bucket arrays from a device CSR: returns (((cols i32 [N,w],
    vals f32 [N,w]), ...), chunk_row i32, rows), ``rows`` the
    :class:`.gespmm.RowTables` of the flat store the buckets are views of
    (None for an empty residue).  A bucket's chunk is a w-wide gather from
    ``starts[:, None] + arange(w)`` (each chunk's nnz are contiguous in CSR
    order), masked past its length."""
    wmax, widths, bucket_meta, _ = meta
    dev = col_dev.device
    if not bucket_meta:  # empty residue
        return (), torch.zeros(0, dtype=torch.int32, device=dev), None
    with _trace.setup_span("flex.build.buckets"):
        row_ptr = row_ptr.long()
        deg = row_ptr[1:] - row_ptr[:-1]
        order = _chunk_order(deg, widths)
        col_pad = torch.cat([col_dev, col_dev.new_zeros(wmax)])
        val_pad = torch.cat([vals_dev, vals_dev.new_zeros(wmax)])

        total = sum(w * n_alloc for w, n_alloc, _ in bucket_meta)
        flat_c = torch.empty(total, dtype=torch.int32, device=dev)
        flat_v = torch.empty(total, dtype=torch.float32, device=dev)
        buckets, rows_parts, offs, lens, base = [], [], [], [], 0
        for w, rows_b, starts, lengths in _bucket_layouts(
                row_ptr, deg, order, col_dev.shape[0], meta):
            N = rows_b.shape[0]
            c, v = flat_c[base:base + N * w].view(N, w), \
                flat_v[base:base + N * w].view(N, w)
            gc, gv = gather_chunks(col_pad, val_pad, starts, lengths, w)
            c.copy_(gc)
            v.copy_(gv)
            buckets.append((c, v))
            rows_parts.append(rows_b)
            offs.append(base + torch.arange(N, device=dev) * w)
            lens.append(lengths)
            base += N * w
        chunk_row = torch.cat(rows_parts).to(torch.int32)
        chunk_off, chunk_len = torch.cat(offs), torch.cat(lens)
    return tuple(buckets), chunk_row, row_tables(
        flat_c, flat_v, chunk_row, chunk_off, chunk_len, deg.shape[0])


def _gather_assembly_tables(chunk_row: torch.Tensor, *, m: int,
                            n_extras: int):
    """``chunk1[r]`` = row r's first chunk (sentinel n_chunks = no chunk);
    with split rows also (extra_idx, extra_first): the non-first chunks and
    the first chunk of their row, folded in before the gather."""
    with _trace.setup_span("flex.build.assembly"):
        n_chunks = chunk_row.shape[0]
        dev = chunk_row.device
        idx = torch.arange(n_chunks, device=dev)
        rows = chunk_row.long()
        chunk1 = torch.full((m,), n_chunks, dtype=torch.int64, device=dev)
        chunk1.scatter_reduce_(0, rows, idx, reduce="amin",
                               include_self=True)
        if n_extras == 0:
            return chunk1.to(torch.int32), None
        extra_idx = idx[chunk1[rows] != idx]
        extra_first = chunk1[rows[extra_idx]]
        return chunk1.to(torch.int32), (extra_idx.to(torch.int32),
                                        extra_first.to(torch.int32))


def _ell_spmm(buckets, chunk_row, B, *, m, max_gather_rows, into=None,
              chunk1=None, extras=None, b_dtype="float32"):
    """buckets: tuple of (cols [N,w] i32, vals [N,w] f32), one per width.
    chunk_row: i32[total_chunks] output row per chunk (bucket-major).
    into: optional (m, k) f32 accumulator; it is updated IN PLACE and
      returned (the windowed call passes its own dense half, which saves
      an (m, k) temporary).
    b_dtype: the gather dtype; ``"bfloat16"`` casts B once and gathers bf16
      rows, whose products with the f32 values are summed in f32.  The
      output is f32 either way.
    ``max_gather_rows`` bounds the (N, w, k) gather temporary by splitting
    each bucket into sub-batches of ~max_gather_rows gathered rows."""
    k = B.shape[1]
    if into is not None and tuple(into.shape) != (m, k):
        raise ValueError(f"into shape {tuple(into.shape)} != ({m}, {k})")
    if not buckets:  # zero-nnz residue
        return into if into is not None else torch.zeros(
            (m, k), dtype=torch.float32, device=B.device)
    B = B.to(B_DTYPES[b_dtype])
    parts = []
    for cols, vals in buckets:
        N, w = cols.shape
        step = max(1, max_gather_rows // w)
        for s in range(0, N, step):
            c = cols[s:s + step]
            v = vals[s:s + step]
            Bg = B.index_select(0, c.reshape(-1)).view(c.shape[0], w, k)
            parts.append((v[:, :, None] * Bg.float()).sum(dim=1))
    partial = torch.cat(parts)
    if chunk1 is None:
        if into is None:
            into = partial.new_zeros((m, k))
        return into.index_add_(0, chunk_row, partial)
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
    # the row-unit kernel's tables over the buckets' flat store (None only
    # for an empty residue, which takes the plain path)
    rows: RowTables | None = None
    b_dtype: str = "float32"  # gather dtype (:func:`check_b_dtype`)
    # without a bwd_plan: the one the first backward builds (_EllApply)
    _kept_bwd: "EllPlan | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __call__(self, B: torch.Tensor, into: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """Through :class:`_EllApply` only if a gradient can reach B or
        ``into`` (and not on the CPU without a ``bwd_plan``)."""
        grad = torch.is_grad_enabled() and (
            B.requires_grad or (into is not None and into.requires_grad))
        if not grad or (self.bwd_plan is None and B.device.type == "cpu"):
            return _ell_raw_call(self, B, into)
        return _EllApply.apply(self, B, into)

    def traffic_model(self, k: int) -> dict:
        """Predicted bytes per call of the JAX package's byte model (the
        reference's dataVolume/NPerf model, ``flex.cu:5505-5540``): the
        take→materialise→reduce chain reads B rows, writes the gather
        output, re-reads it for the multiply-reduce, writes chunk partials,
        and scatter-adds them into C.  The row-unit kernel moves none of
        the gather output or partials (PERF.md has its own bound).  A B
        element is 2 bytes under ``b_dtype="bfloat16"``."""
        bb = 2 if self.b_dtype == "bfloat16" else 4
        n_chunks = int(self.chunk_row.shape[0])
        by = (3 * self.padded_nnz * k * bb
              + 2 * n_chunks * k * 4
              + self.m * k * 4)
        return {"bytes": int(by), "gathered_rows": self.padded_nnz}

    @property
    def views(self) -> tuple:
        return tuple((0, c.shape[0], c.shape[1]) for c, _ in self.buckets)

    @property
    def stats(self) -> dict:
        return {
            "padded_nnz": self.padded_nnz,
            "pad_ratio": self.padded_nnz / max(self.nnz, 1),
            "n_chunks": int(self.chunk_row.shape[0]),
            "views": self.views,
        }


def ell_spmm_plain(plan: EllPlan, B, into=None):
    """The plain PyTorch version of the plan's product (what CPU tensors
    take): :func:`_ell_spmm` on the plan's buckets, on any device."""
    return _ell_spmm(plan.buckets, plan.chunk_row, B, m=plan.m,
                     max_gather_rows=plan.max_gather_rows, into=into,
                     chunk1=plan.chunk1, extras=plan.extras,
                     b_dtype=plan.b_dtype)


def _spmm_attrs(plan: EllPlan, B):
    """The ``flex.spmm`` span's device and attrs: the plan's rows and real
    nonzeros, B's rows and columns, the gather dtype."""
    shape = B.shape
    return B.device, {"m": plan.m, "n": shape[0], "nnz": plan.nnz,
                      "k": shape[1], "dtype": plan.b_dtype}


def _ell_raw_call(plan: EllPlan, B, into):
    with _trace.span("flex.spmm", _spmm_attrs, plan, B) as sp:
        if B.device.type == "cpu" or not plan.buckets:
            return ell_spmm_plain(plan, B, into)
        # a bf16 plan casts B once, into rows padded to 16 bytes;
        # gespmm_rows then launches kernel 7's bf16 instance, whose output
        # is f32.  The cast, or else the launch, is the first device work.
        sp.begin()
        Bc = to_bf16_padded(B) if plan.b_dtype == "bfloat16" \
            else B.to(torch.float32)
        return gespmm_rows(plan.rows, Bc, into=into)


class _EllApply(torch.autograd.Function):
    """``plan(B, into)`` through the row-unit kernel on the card (the plain
    version on the CPU), with g_B = A_resᵀ·g (the JAX package's
    ``_ell_apply_cv`` / ``_ell_apply_cv0``) through ``plan.bwd_plan`` or
    else the plan :func:`with_bwd_plan` attaches, built at the first
    backward and kept: on the card in a fixed order.  The cotangent of
    ``into`` is g; the plan gets none, so gradients wrt A's values are not
    propagated here, as in the JAX package."""

    @staticmethod
    def forward(ctx, plan, B, into):
        ctx.plan = plan
        ctx.n = B.shape[0]
        ctx.has_into = into is not None
        if ctx.has_into:
            ctx.mark_dirty(into)  # the accumulator is updated in place
        return _ell_raw_call(plan, B, into)

    @staticmethod
    def backward(ctx, g):
        g_B = None
        if ctx.needs_input_grad[1]:
            plan = ctx.plan
            bwd = plan.bwd_plan
            if bwd is None:
                bwd = plan._kept_bwd
                if bwd is None or bwd.m != ctx.n:
                    bwd = plan._kept_bwd = prepare_ell_transpose(
                        plan, ctx.n, keep_pads=False)
            g_B = bwd(g.contiguous())
        return None, g_B, g if ctx.has_into else None


def prepare_ell_device(row_ptr_dev, col_dev, vals_dev, *, m: int, nnz: int,
                       res_row_ptr_host: np.ndarray,
                       widths: tuple[int, ...] = DEFAULT_WIDTHS,
                       b_dtype: str = "float32",
                       bucket_alloc: dict | None = None) -> EllPlan:
    """An :class:`EllPlan` from device CSR tensors: the host computes only
    the static bucket sizes from its copy of the row_ptr.  ``bucket_alloc``
    (width → allocated chunk count ≥ the real count) pads the buckets to
    common shapes, as the sharded plans do (:func:`ell_meta`); the pad
    chunks point at row 0, so such a plan has no gather assembly
    (``chunk1``), as in the JAX package."""
    check_b_dtype(b_dtype)
    with _trace.setup_span("flex.build", m=m, nnz=nnz):
        deg = np.diff(np.asarray(res_row_ptr_host, dtype=np.int64))
        meta, padded = ell_meta(deg, widths, bucket_alloc)
        buckets, chunk_row, rows = ell_buckets_core(row_ptr_dev, col_dev,
                                                    vals_dev, meta=meta)
        chunk1 = extras = None
        if buckets and bucket_alloc is None:
            n_extras = int(chunk_row.shape[0]) - int((deg > 0).sum())
            chunk1, extras = _gather_assembly_tables(chunk_row, m=m,
                                                     n_extras=n_extras)
        return EllPlan(m=m, buckets=buckets, chunk_row=chunk_row,
                       padded_nnz=padded, nnz=nnz, chunk1=chunk1,
                       extras=extras, rows=rows, b_dtype=b_dtype)


def prepare_ell_transpose(plan: EllPlan, n: int,
                          keep_pads: bool = True) -> EllPlan:
    """Transposed-pattern EllPlan built on the device from ``plan``'s own
    buckets (so it works for the windowed hybrid's residue, whose CSR never
    exists as arrays of its own): flatten the padded (col, val, row)
    triples, sort by col, and feed the transposed CSR to
    :func:`prepare_ell_device`.  Padding entries ride along as (col 0,
    val 0) and count into transposed row 0's degree, as in the JAX
    package; ``keep_pads=False`` drops them (the same g_B, other tables).
    One O(n) device-to-host copy (the transposed row_ptr) is the only
    transfer besides the row tables' own.  The plan inherits ``b_dtype``,
    so a bf16 plan's g_B gathers the cotangent in bf16."""
    if not plan.buckets:
        return EllPlan(m=n, buckets=(), padded_nnz=0, nnz=0,
                       chunk_row=plan.chunk_row.new_zeros(0),
                       b_dtype=plan.b_dtype)
    # its own flex.build span holds the device-side sort and the row_ptr's
    # copy to the host, besides the inner build's
    nnz = plan.padded_nnz if keep_pads else plan.nnz
    with _trace.setup_span("flex.build", m=n, nnz=nnz):
        cols = torch.cat([c.reshape(-1) for c, _ in plan.buckets])
        vals = torch.cat([v.reshape(-1) for _, v in plan.buckets])
        offs, rows_parts = 0, []
        for c, _ in plan.buckets:
            N, w = c.shape
            rows_parts.append(
                plan.chunk_row[offs:offs + N].repeat_interleave(w))
            offs += N
        rows = torch.cat(rows_parts)
        if not keep_pads:
            _, real = unit_entries(plan.rows)
            cols, vals, rows = cols[real], vals[real], rows[real]
        counts = torch.bincount(cols, minlength=n)
        t_row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        order = torch.sort(cols, stable=True).indices
        return prepare_ell_device(
            t_row_ptr, rows[order], vals[order], m=n, nnz=int(cols.shape[0]),
            res_row_ptr_host=t_row_ptr.cpu().numpy(), b_dtype=plan.b_dtype)


def with_bwd_plan(plan: EllPlan, n: int) -> EllPlan:
    """Copy of ``plan`` carrying the transposed-pattern backward plan
    (``n`` = B's row count), built now rather than at the first backward;
    on the CPU its call then goes through :class:`_EllApply` too.  Only
    valid when A's values are constants (a graph adjacency).  The
    backward plan leaves out the forward's pad entries
    (``prepare_ell_transpose(keep_pads=False)``): the same g_B, and on an
    H100 its kernel ran 17 % faster on the reddit_posts residue, whose pads
    all land in transposed row 0.  So its tables differ from the JAX
    package's ``with_bwd_plan``, by design."""
    return dataclasses.replace(plan, bwd_plan=prepare_ell_transpose(
        plan, n, keep_pads=False))


def prepare_ell(g: CSRGraph, dev: DeviceCSR | None = None,
                widths: tuple[int, ...] = DEFAULT_WIDTHS,
                b_dtype: str = "float32", device=None) -> EllPlan:
    """Host: O(m) static bucket sizes for the width ladder ``widths``.
    Device: every bucket array.  ``b_dtype`` is the gather dtype
    (:func:`check_b_dtype`)."""
    check_b_dtype(b_dtype)
    dev = resident_csr(g, dev, device)
    return prepare_ell_device(dev.row_ptr, dev.col, dev.vals, m=g.m,
                              nnz=g.nnz, res_row_ptr_host=g.row_ptr,
                              widths=tuple(widths), b_dtype=b_dtype)


def spmm_ell(g: CSRGraph, B, device=None, **kw) -> torch.Tensor:
    """:func:`prepare_ell` (``kw``), then the call on B (NumPy or a
    tensor, moved to the plan's device)."""
    dev = resident_csr(g, kw.pop("dev", None), device)
    return prepare_ell(g, dev=dev, **kw)(dense_operand(B, dev.device))
