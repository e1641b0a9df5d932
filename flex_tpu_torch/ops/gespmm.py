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

from flex_tpu_torch.ops.operands import (
    check_interpret, check_kernel_operands, check_operands,
)
from flex_tpu_torch.ops.units import row_units
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, resident_csr
from flex_tpu_torch.utils import trace as _trace

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
    adds up.  Empty ``vals``: each call gives them (``gespmm_rows(vals=)``).
    The tables check themselves once, when made (on a CUDA device also
    what the kernels' raw pointers need, ``units`` read by float4); a call
    checks only what changes between calls (:func:`check_call`)."""
    cols: torch.Tensor       # i32 [T] the flat store of chunks
    vals: torch.Tensor       # f32 [T], or [0]: values given per call
    row_start: torch.Tensor  # i32 [m]
    units: torch.Tensor      # i32 [U, 4] (row, lo, hi, part)
    splits: torch.Tensor     # i32 [S, 3] (row, part_lo, part_hi)
    n_parts: int

    def __post_init__(self):
        T = self.cols.shape[0]
        check_operands({"cols": (self.cols, T),
                        "row_start": (self.row_start, self.m),
                        "units": (self.units, (self.units.shape[0], 4)),
                        "splits": (self.splits, (self.splits.shape[0], 3))},
                       {"vals": self.vals})
        if tuple(self.vals.shape) not in ((T,), (0,)):
            raise ValueError(f"vals must be float32[{T}] or empty, got "
                             f"{list(self.vals.shape)}")
        if self.cols.device.type == "cuda":
            check_kernel_operands(("units",), cols=self.cols, vals=self.vals,
                                  row_start=self.row_start, units=self.units,
                                  splits=self.splits)

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
    with _trace.setup_span("flex.build.row_tables"):
        T = int(cols.shape[0])
        if T >= 2**31:
            raise ValueError("the row-unit kernel's store is int32-indexed: "
                             "it must hold < 2^31 entries")
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
            raise ValueError("a row's chunks are not one contiguous run of "
                             "the flat store")
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
                      max_gather_rows: int = 1 << 21, vals=None):
    """Plain PyTorch version of :func:`gespmm_rows`: every covered nonzero's
    vals · B[cols] scatter-added into its row (in sub-batches of about
    ``max_gather_rows`` gathered rows), then added into ``into`` when
    given.  ``vals`` replaces the tables' values.  A bf16 B is widened to
    f32 row by row as it is gathered.  Returns f32 [m, k]."""
    vals = t.vals if vals is None else vals
    rows, idx = unit_entries(t)
    out = torch.zeros((t.m, B.shape[1]), dtype=torch.float32,
                      device=B.device)
    for s in range(0, len(idx), max_gather_rows):
        e = idx[s:s + max_gather_rows]
        out.index_add_(0, rows[s:s + max_gather_rows], vals[e, None]
                       * B.index_select(0, t.cols[e].long()).float())
    return into.add_(out) if into is not None else out


def check_call(t: RowTables, kernel: str, B, /, row_strided=(),
               **floats) -> bool:
    """A call's checks: ``floats`` float32, they and B (the rows ``cols``
    names) on the tables' device, on the card what ``kernel``'s pointers
    need.  True if the call launches it, False for CPU tensors."""
    for name, x in floats.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    devices = {t.cols.device, B.device} | {x.device for x in floats.values()}
    if len(devices) != 1:
        raise ValueError(f"arguments lie on several devices: {devices}")
    if B.device.type == "cpu":
        return False
    if B.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {B.device}")
    check_kernel_operands((), row_strided, **{"B": B, **floats})
    if t.cols.shape[0] and B.shape[0] == 0:
        raise ValueError("B has no rows for cols to point at")
    return True


def _rows_call(t: RowTables, B, into, vals, symbol: str, row_strided=(),
               extra=()):
    """Checks of what changes between calls (B, ``into``, the call's
    ``vals``: the callers check B's dtype and rank), then the plain
    version on the CPU or ``symbol`` of ``csrc/gespmm.cu`` on the card,
    with the ints ``extra`` after its others; returns (out, launched).
    ``row_strided=("B",)`` lets B be a column slice of a wider buffer."""
    m, k, T = t.m, B.shape[1], t.cols.shape[0]
    if into is not None and tuple(into.shape) != (m, k):
        raise ValueError(f"into shape {tuple(into.shape)} != ({m}, {k})")
    v = t.vals if vals is None else vals
    if tuple(v.shape) != (T,):
        raise ValueError(f"vals must have shape ({T},), got {tuple(v.shape)}"
                         + (": the tables hold none" if vals is None else ""))
    floats = {n: x for n, x in (("into", into), ("vals", vals))
              if x is not None}
    if not check_call(t, "gespmm", B, row_strided, **floats):
        return gespmm_rows_plain(t, B, into, vals=v), False
    from flex_tpu_torch import kernels

    out = into if into is not None else torch.empty(
        (m, k), dtype=torch.float32, device=B.device)
    scratch = torch.empty((t.n_parts, k), dtype=torch.float32,
                          device=B.device)
    kernels.launch("gespmm", symbol, B.device,
                   t.cols.data_ptr(), v.data_ptr(),
                   t.row_start.data_ptr(), t.units.data_ptr(),
                   t.splits.data_ptr(), B.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), t.units.shape[0], t.splits.shape[0], k,
                   int(into is not None), *extra)
    return out, True


def gespmm_rows(t: RowTables, B, into=None, vals=None):
    """C[r, :] = Σ over row r's nonzeros of vals · B[cols, :] for every row
    of ``t`` (f32 [m, k]); with ``into`` (f32 [m, k]) the sums are added to
    it IN PLACE and it is returned.  ``vals`` (f32 [T]) replaces the
    tables' values for this call; tables without values need it.

    B is f32, or bf16, which goes to :func:`gespmm_rows_bf16`; any other
    dtype raises.  CUDA tensors launch ``csrc/gespmm.cu`` (and count the
    launch in ``gespmm_rows.launches``): the units, then the pass that adds
    the split rows' partial rows, both in a fixed order.  The units' lanes
    follow k (:func:`rows_layout`): a warp a unit for k > 64
    (``flex_gespmm_rows``), else lane groups (``flex_gespmm_rows_grouped``,
    also counted in ``gespmm_rows.grouped_launches``); both read B by
    16-byte loads when k % 4 == 0 and the rows are aligned, else by scalar
    loads, and give the same bits.  CPU tensors take
    :func:`gespmm_rows_plain`.  Anything else raises."""
    if B.dtype == torch.bfloat16:
        return gespmm_rows_bf16(t, B, into, vals)
    if B.dtype != torch.float32:
        raise ValueError(f"B must be float32 or bfloat16, got {B.dtype}")
    if B.dim() != 2:
        raise ValueError(f"B must be 2-D, got {tuple(B.shape)}")
    lanes = rows_layout(B.shape[1])[0]
    if lanes == 32:
        out, launched = _rows_call(t, B, into, vals, "flex_gespmm_rows")
    else:
        out, launched = _rows_call(t, B, into, vals,
                                   "flex_gespmm_rows_grouped",
                                   extra=(lanes,))
        gespmm_rows.grouped_launches += launched
    gespmm_rows.launches += launched
    return out


gespmm_rows.launches = 0
gespmm_rows.grouped_launches = 0


def rows_layout(k: int) -> tuple[int, int]:
    """How kernel 7's f32 instance spreads a unit over a warp at width
    ``k``: (lanes G, the smallest power of two with 4·G ≥ k, capped at 32:
    below 32 the lanes of one unit, 4 columns each (``rows_group_kernel``),
    at 32 a whole warp (``rows_kernel``, any k); units_per_warp, 32 / G)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    lanes = 1
    while 4 * lanes < k and lanes < 32:
        lanes *= 2
    return lanes, 32 // lanes


def bf16_layout(k: int) -> tuple[int, int, int]:
    """How kernel 7's bf16 instance reads B at width ``k``: (ldb, the row
    stride of the padded cast, k rounded up to 8 elements = 16 bytes;
    lanes_per_row G, the smallest power of two with 8·G ≥ min(k, 128), the
    lanes that read one B row, 8 columns each; units_per_warp, 32 / G)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    ldb = -(-k // 8) * 8
    lanes = 1
    while 8 * lanes < min(k, 128):
        lanes *= 2
    return ldb, lanes, 32 // lanes


def to_bf16_padded(B: torch.Tensor) -> torch.Tensor:
    """B cast to bf16 as the ``[n, k]`` view of a new ``[n, ldb]`` buffer
    (:func:`bf16_layout`) whose pad columns are zero: every row of the
    view starts on a 16-byte boundary, so the bf16 instance reads it with
    16-byte loads at any k.  One pass over B, as a plain cast."""
    n, k = B.shape
    ldb = bf16_layout(k)[0]
    buf = torch.empty((n, ldb), dtype=torch.bfloat16, device=B.device)
    buf[:, k:].zero_()
    buf[:, :k].copy_(B)
    return buf[:, :k]


def gespmm_rows_bf16(t: RowTables, B, into=None, vals=None):
    """:func:`gespmm_rows` with B in bf16 (the JAX package's
    ``b_dtype="bfloat16"`` gather): bf16 rows of B, widened to f32, times
    the f32 values, summed in f32; out and ``into`` are f32.  B is
    contiguous or row-strided (a column slice of a wider buffer, as
    :func:`to_bf16_padded` makes).  CUDA tensors launch kernel 7's bf16
    instance (``flex_gespmm_rows_bf16``, counted in
    ``gespmm_rows_bf16.launches``) with B's row stride and the lanes of
    :func:`bf16_layout`: 16-byte loads when the rows are 16-byte aligned,
    else 2-byte loads, and the f32 instance's sums in its order either
    way.  CPU tensors take :func:`gespmm_rows_plain`."""
    if B.dtype != torch.bfloat16:
        raise ValueError(f"B must be bfloat16, got {B.dtype}")
    if B.dim() != 2:
        raise ValueError(f"B must be 2-D, got {tuple(B.shape)}")
    n, k = B.shape
    ldb = B.stride(0) if n > 1 else k
    if B.device.type == "cuda" and n and k % 8 and ldb % 8 == 0 \
            and B.data_ptr() % 16 == 0:
        # 16-byte loads read the last row's pad up to column round_up(k, 8)
        have = (B.untyped_storage().data_ptr()
                + B.untyped_storage().nbytes() - B.data_ptr()) // 2
        if have < (n - 1) * ldb + bf16_layout(k)[0]:
            raise ValueError("B's storage ends inside its last row's pad "
                             "(16-byte loads would read past it)")
    out, launched = _rows_call(t, B, into, vals, "flex_gespmm_rows_bf16",
                               row_strided=("B",),
                               extra=(ldb, bf16_layout(k)[1]))
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
    rows: RowTables          # the kernel's tables over cols/vals

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        return gespmm_rows(self.rows, B)

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
                   interpret: bool | None = None, device=None,
                   **_unused) -> GeSpmmPlan:
    """Single fixed chunk width; rows longer than ``w`` split into several
    chunks, the chunk count is padded to a multiple of CH.  The host ships
    only O(chunks) metadata; each chunk is a contiguous CSR run, gathered
    on the device.  As in the JAX signature, ``interpret`` is accepted and
    ignored (:func:`.operands.check_interpret`), and so is any other
    keyword (the common ones of the harness and command line, such as
    ``tm``)."""
    from flex_tpu_torch.ops.ell_spmm import gather_chunks

    check_interpret(interpret)
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
