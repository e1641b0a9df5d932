"""GE-SpMM-style row-parallel CSR SpMM: the independent second-opinion
baseline, and the row-unit kernel that also runs the windowed plan's ELL
residue.

Counterpart of ``flex_tpu.ops.gespmm``.  Every row goes through one code
path: it is cut into chunks of at most ``w`` nonzeros, padded to ``w``;
C[r, :] = Σ over the row's chunks and entries of vals · B[cols].

- :func:`prepare_gespmm` computes the O(chunks) metadata on the host and
  builds the ``[N, w]`` arrays on the device from the resident CSR, with
  the ELL buckets' own gather (:func:`.ell_spmm.gather_chunks`), and the
  kernel's row tables (:func:`row_tables`).
- :func:`gespmm_rows` computes whole output rows: the hand-written CUDA
  kernel ``csrc/gespmm.cu`` for CUDA tensors, :func:`gespmm_rows_plain`
  for CPU tensors.  The JAX package's kernel computes chunk partials and
  scatter-adds them outside; here a row's chunks are summed in the kernel,
  in a fixed order, so two calls give the same bits.

The kernel reads any flat store of chunks in which a row's chunks are
consecutive and full but for the last, so a row's nonzeros are one
contiguous run: GE-SpMM's ``[N, w]`` arrays and the ELL buckets laid end
to end (:mod:`.ell_spmm`).  :class:`RowTables` is what it reads: the store,
each row's first entry in it and the work units, each at most
:data:`ROW_UNIT_ENTRIES` nonzeros of one row.  Pads outside a row's run
are never read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.operands import check_kernel_operands, check_operands
from flex_tpu_torch.ops.units import row_units
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, resident_csr

CH = 8  # the chunk count is padded to a multiple of CH, as in the JAX plan
# most nonzeros in one unit of the row-unit kernel: 8 chunks of GE-SpMM's
# w = 32, one warp's work
ROW_UNIT_ENTRIES = 256


@dataclasses.dataclass
class RowTables:
    """What the row-unit kernel reads.  Row r's nonzeros are
    ``cols/vals[row_start[r] + lo .. row_start[r] + hi)`` over its units
    (r, lo, hi, part); a row of one unit has part -1, the units of a longer
    row write partial rows ``part`` that ``splits`` (r, part_lo, part_hi)
    adds up."""
    cols: torch.Tensor       # i32 [T] the flat store of chunks
    vals: torch.Tensor       # f32 [T]
    row_start: torch.Tensor  # i32 [m]
    units: torch.Tensor      # i32 [U, 4] (row, lo, hi, part)
    splits: torch.Tensor     # i32 [S, 3] (row, part_lo, part_hi)
    n_parts: int

    @property
    def m(self) -> int:
        return int(self.row_start.shape[0])


def row_tables(cols, vals, chunk_row, chunk_off, chunk_len, m: int,
               chunk: int = ROW_UNIT_ENTRIES) -> RowTables:
    """:class:`RowTables` of a flat store ``cols``/``vals`` whose chunk c
    starts at ``chunk_off[c]``, holds ``chunk_len[c]`` nonzeros and belongs
    to row ``chunk_row[c]`` (rows ≥ ``m`` are pad chunks and are skipped).
    Built on the store's device; one O(m) copy of the row lengths to the
    host cuts the units.  Raises if a row's chunks are not one contiguous
    run of the store."""
    T = int(cols.shape[0])
    if T >= 2**31:
        raise ValueError("the row-unit kernel's store is int32-indexed: it "
                         "must hold < 2^31 entries")
    dev = cols.device
    live = (chunk_row.long() < m) & (chunk_len > 0)
    rows = chunk_row.long()[live]
    off = chunk_off.long()[live]
    ln = chunk_len.long()[live]
    start = torch.full((m,), T, dtype=torch.int64, device=dev)
    start.scatter_reduce_(0, rows, off, reduce="amin")
    end = torch.zeros(m, dtype=torch.int64, device=dev)
    end.scatter_reduce_(0, rows, off + ln, reduce="amax")
    length = torch.zeros(m, dtype=torch.int64, device=dev).scatter_add_(
        0, rows, ln)
    has = length > 0
    length_h, gap = torch.stack(
        [length, torch.where(has, end - start - length, 0)]).cpu().numpy()
    if gap.any():
        raise ValueError("a row's chunks are not one contiguous run of the "
                         "flat store")
    units, splits = row_units(length_h, chunk)
    return RowTables(cols=cols, vals=vals,
                     row_start=torch.where(has, start, 0).to(torch.int32),
                     units=torch.from_numpy(units).to(dev),
                     splits=torch.from_numpy(splits).to(dev),
                     n_parts=int((units[:, 3] >= 0).sum()))


def chunk_lengths(cols, vals, chunk_row):
    """Chunk lengths as a bucket's (cols [N, w], vals [N, w]) arrays show
    them: a chunk followed by another of its row is full; the last chunk of
    a row runs to its last entry that is not a pad (column 0, value 0), so
    an explicit zero at column 0 that ends a row reads as a pad (it adds
    nothing).  For plans whose build did not keep the lengths."""
    N, w = cols.shape
    nz = (cols != 0) | (vals != 0)
    pos = torch.arange(1, w + 1, device=cols.device)
    last = torch.where(nz, pos, 0).amax(dim=1)
    row = chunk_row.long()
    is_last = torch.ones(N, dtype=torch.bool, device=cols.device)
    is_last[:-1] = row[1:] != row[:-1]
    return torch.where(is_last, last, w)


def tables_from_buckets(buckets, chunk_row, m: int) -> RowTables:
    """:class:`RowTables` of (non-empty) bucket arrays alone (lengths by
    :func:`chunk_lengths`): the buckets are laid end to end in a new flat
    store, bucket-major as ``chunk_row`` runs."""
    dev = chunk_row.device
    offs, lens, base, o = [], [], 0, 0
    for c, v in buckets:
        N, w = c.shape
        offs.append(base + torch.arange(N, device=dev, dtype=torch.int64) * w)
        lens.append(chunk_lengths(c, v, chunk_row[o:o + N]))
        base += N * w
        o += N
    return row_tables(torch.cat([c.reshape(-1) for c, _ in buckets]),
                      torch.cat([v.reshape(-1) for _, v in buckets]),
                      chunk_row, torch.cat(offs), torch.cat(lens), m)


def unit_entries(t: RowTables):
    """Every nonzero the units cover: (row, flat index) as i64 tensors, in
    unit order."""
    u = t.units.long()
    lens = u[:, 2] - u[:, 1]
    total = int(lens.sum())
    rows = torch.repeat_interleave(u[:, 0], lens, output_size=total)
    first = t.row_start.long()[u[:, 0]] + u[:, 1] - (torch.cumsum(lens, 0)
                                                     - lens)
    idx = torch.repeat_interleave(first, lens, output_size=total) \
        + torch.arange(total, device=u.device)
    return rows, idx


def gespmm_rows_plain(t: RowTables, B, into=None,
                      max_gather_rows: int = 1 << 21):
    """Plain PyTorch version of :func:`gespmm_rows`: every covered nonzero's
    vals · B[cols] scatter-added into its row (in sub-batches of about
    ``max_gather_rows`` gathered rows), then added into ``into`` when
    given.  A bf16 B is widened to f32 row by row as it is gathered.
    Returns f32 [m, k]."""
    rows, idx = unit_entries(t)
    out = torch.zeros((t.m, B.shape[1]), dtype=torch.float32,
                      device=B.device)
    for s in range(0, len(idx), max_gather_rows):
        e = idx[s:s + max_gather_rows]
        out.index_add_(0, rows[s:s + max_gather_rows], t.vals[e, None]
                       * B.index_select(0, t.cols[e].long()).float())
    return into.add_(out) if into is not None else out


def _rows_call(t: RowTables, B, into, symbol: str):
    """Checks, then the plain version on the CPU or ``symbol`` of
    ``csrc/gespmm.cu`` on the card; returns (out, launched)."""
    if B.dim() != 2:
        raise ValueError(f"B must be 2-D, got {tuple(B.shape)}")
    m, k = t.m, B.shape[1]
    floats = {"vals": t.vals}
    if into is not None:
        if tuple(into.shape) != (m, k):
            raise ValueError(f"into shape {tuple(into.shape)} != ({m}, {k})")
        floats["into"] = into
    check_operands({"cols": (t.cols, t.vals.shape[0]), "row_start": (
        t.row_start, m), "units": (t.units, (t.units.shape[0], 4)),
        "splits": (t.splits, (t.splits.shape[0], 3))}, floats)
    if B.device != t.vals.device:
        raise ValueError(f"arguments lie on several devices: "
                         f"{ {B.device, t.vals.device} }")
    if B.device.type == "cpu":
        return gespmm_rows_plain(t, B, into), False
    if B.device.type != "cuda":
        raise ValueError(f"no gespmm kernel for device {B.device}")
    check_kernel_operands(("units",), cols=t.cols, row_start=t.row_start,
                          units=t.units, splits=t.splits, B=B, **floats)
    if t.cols.numel() and B.shape[0] == 0:
        raise ValueError("B has no rows for cols to point at")
    from flex_tpu_torch import kernels

    out = into if into is not None else torch.empty(
        (m, k), dtype=torch.float32, device=B.device)
    scratch = torch.empty((t.n_parts, k), dtype=torch.float32,
                          device=B.device)
    kernels.launch("gespmm", symbol, B.device,
                   t.cols.data_ptr(), t.vals.data_ptr(),
                   t.row_start.data_ptr(), t.units.data_ptr(),
                   t.splits.data_ptr(), B.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), t.units.shape[0], t.splits.shape[0], k,
                   int(into is not None))
    return out, True


def gespmm_rows(t: RowTables, B, into=None):
    """C[r, :] = Σ over row r's nonzeros of vals · B[cols, :] for every row
    of ``t`` (f32 [m, k]); with ``into`` (f32 [m, k]) the sums are added to
    it IN PLACE and it is returned.

    B is f32, or bf16, which goes to :func:`gespmm_rows_bf16`; any other
    dtype raises.  CUDA tensors launch ``csrc/gespmm.cu`` (and count the
    launch in ``gespmm_rows.launches``): the units, then the pass that adds
    the split rows' partial rows, both in a fixed order.  CPU tensors take
    :func:`gespmm_rows_plain`.  Anything else raises."""
    if B.dtype == torch.bfloat16:
        return gespmm_rows_bf16(t, B, into)
    if B.dtype != torch.float32:
        raise ValueError(f"B must be float32 or bfloat16, got {B.dtype}")
    out, launched = _rows_call(t, B, into, "flex_gespmm_rows")
    gespmm_rows.launches += launched
    return out


gespmm_rows.launches = 0


def gespmm_rows_bf16(t: RowTables, B, into=None):
    """:func:`gespmm_rows` with B in bf16 (the JAX package's
    ``b_dtype="bfloat16"`` gather): bf16 rows of B, widened to f32, times
    the f32 values, summed in f32; out and ``into`` are f32.  CUDA tensors
    launch kernel 7's bf16 instance (``flex_gespmm_rows_bf16``, counted in
    ``gespmm_rows_bf16.launches``), whose sums run in the f32 instance's
    order; CPU tensors take :func:`gespmm_rows_plain`."""
    if B.dtype != torch.bfloat16:
        raise ValueError(f"B must be bfloat16, got {B.dtype}")
    out, launched = _rows_call(t, B, into, "flex_gespmm_rows_bf16")
    gespmm_rows_bf16.launches += launched
    return out


gespmm_rows_bf16.launches = 0


@dataclasses.dataclass
class GeSpmmPlan:
    m: int
    w: int
    cols: torch.Tensor       # i32 [N, w] (N a multiple of CH; pads -> row 0)
    vals: torch.Tensor       # f32 [N, w] (pads are 0)
    chunk_row: torch.Tensor  # i32 [N] (pad chunks point at dump row m)
    nnz: int
    padded_nnz: int
    # the kernel's tables over cols/vals; None = derive them at each call
    rows: RowTables | None = None

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        t = self.rows if self.rows is not None else tables_from_buckets(
            ((self.cols, self.vals),), self.chunk_row, self.m)
        return gespmm_rows(t, B)

    @property
    def stats(self) -> dict:
        return {
            "n_chunks": int(self.cols.shape[0]),
            "w": self.w,
            "padded_nnz": self.padded_nnz,
            "pad_ratio": self.padded_nnz / max(self.nnz, 1),
        }

    def traffic_model(self, k: int) -> dict:
        """Byte model (the JAX package's): one (1, k) row of B per padded
        slot, plus C.  The row-unit kernel reads no pad, so it moves less."""
        by = self.padded_nnz * k * 4 + 2 * self.m * k * 4
        return {"bytes": int(by), "gathered_rows": self.padded_nnz}


def prepare_gespmm(g: CSRGraph, w: int = 32, dev: DeviceCSR | None = None,
                   device=None) -> GeSpmmPlan:
    """Single fixed chunk width; rows longer than ``w`` split into several
    chunks, the chunk count is padded to a multiple of CH.  The host ships
    only O(chunks) metadata; each chunk is a contiguous CSR run, gathered
    on the device."""
    from flex_tpu_torch.ops.ell_spmm import gather_chunks

    if w < 1:
        raise ValueError(f"chunk width must be positive, got w={w}")
    dev = resident_csr(g, dev, device)
    deg = g.degrees.astype(np.int64)
    n_chunks = np.where(deg > 0, -(-deg // w), 0)
    rows_rep = np.repeat(np.arange(g.m, dtype=np.int64), n_chunks)
    total = len(rows_rep)
    cum0 = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    local = np.arange(total, dtype=np.int64) - np.repeat(cum0, n_chunks)

    N = max(-(-total // CH) * CH, CH)
    starts = np.full(N, g.nnz, np.int32)  # pads slice the zero pad region
    lengths = np.zeros(N, np.int32)
    chunk_row = np.full(N, g.m, np.int32)  # pads -> dump row
    starts[:total] = g.row_ptr[rows_rep] + local * w
    lengths[:total] = np.minimum(deg[rows_rep] - local * w, w)
    chunk_row[:total] = rows_rep

    meta = torch.from_numpy(np.stack([starts, lengths, chunk_row])).to(
        dev.device)
    cols, vals = gather_chunks(
        torch.cat([dev.col, dev.col.new_zeros(w)]),
        torch.cat([dev.vals, dev.vals.new_zeros(w)]), meta[0], meta[1], w)
    rows = row_tables(cols.view(-1), vals.view(-1), meta[2],
                      torch.arange(N, device=dev.device) * w, meta[1], g.m)
    return GeSpmmPlan(m=g.m, w=w, cols=cols, vals=vals, chunk_row=meta[2],
                      nnz=g.nnz, padded_nnz=N * w, rows=rows)


def spmm_gespmm(g: CSRGraph, B: torch.Tensor, **kwargs) -> torch.Tensor:
    return prepare_gespmm(g, **kwargs)(B)
