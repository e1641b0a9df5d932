"""Panel SpMM: hub rows as weighted row sums, tail rows as dense panels.

Counterpart of ``flex_tpu.ops.panel_spmm``, on the same host build:

- **Hub rows** (degree ≥ ``hub_threshold``) barely reuse B rows within a
  panel, so they are not densified.  Each is cut into ``hub_width``-wide
  chunks, consecutive and full but for the last.  The JAX package takes
  each chunk's weighted sum and a segment sum; here the chunk store is
  read by the row-unit kernel (:func:`.gespmm.gespmm_rows`, kernel 7 of
  ``csrc/gespmm.cu``), which sums each hub row in one deterministic
  launch, straight into C.  The tables' lengths come from the degrees, so
  no pad is read.
- **Tail rows** are grouped into ``tm``-row panels (:mod:`..tiling.panels`);
  each panel gathers its deduplicated B rows once and multiplies a
  host-densified A block [tm, u] against them.  Panels are bucketed by
  unique-column count into power-of-2 widths; per bucket one
  ``torch.bmm`` (in sub-batches of at most ``MAX_GATHER_ROWS`` gathered
  rows) whose panels are copied into their rows of C in place.  The JAX
  package computes this product with ``einsum`` outside any Pallas kernel.

No two writers share a row: panels tile the tail, and a hub row is summed
by its own units.  Products run in full float32 (TF32 stays off); the JAX
``precision`` argument has no counterpart.

  plan = prepare_panel(g, ...)   # host format build + upload (tPre)
  C    = plan(B)                 # gathers + batched products (tElap)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.gespmm import RowTables, gespmm_rows, row_tables
from flex_tpu_torch.sparse.csr import CSRGraph, repeat_arange
from flex_tpu_torch.sparse.device import (
    DeviceCSR, resident_csr, resolve_device,
)

# most B rows one gather materialises (temporary = rows · k · 4 bytes);
# larger gathers are split into sequential sub-batches, as in the JAX plan
MAX_GATHER_ROWS = 2 * 1024 * 1024


@dataclasses.dataclass
class PanelPlan:
    m: int
    tm: int
    n_hub_rows: int
    n_panels: int
    hub_cols: torch.Tensor       # i32 [Nh, hub_width] (pads: column 0)
    hub_vals: torch.Tensor       # f32 [Nh, hub_width] (pads: 0)
    hub_chunk_row: torch.Tensor  # i32 [Nh]
    # per width bucket: (a_dense f32 [P, tm, u], ucols i32 [P, u],
    # panel ids i64 [P])
    buckets: tuple
    hub_rows: RowTables | None   # kernel 7's tables over the hub chunks
    gathered_rows: int           # Σ gathered B rows per call

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        if B.dim() != 2 or B.dtype != torch.float32:
            raise ValueError(f"B must be a 2-D float32 tensor, got "
                             f"{B.dtype}{list(B.shape)}")
        k = B.shape[1]
        n_rows = max(self.m, self.n_hub_rows + self.n_panels * self.tm)
        C = B.new_zeros((n_rows, k))
        tail = C[self.n_hub_rows:self.n_hub_rows + self.n_panels * self.tm
                 ].view(self.n_panels, self.tm * k)
        for a_dense, ucols, ids in self.buckets:
            P, tm, u = a_dense.shape
            step = max(1, MAX_GATHER_ROWS // u)
            for s in range(0, P, step):
                Bp = B[ucols[s:s + step].long()]            # [p, u, k]
                tail.index_copy_(0, ids[s:s + step], torch.bmm(
                    a_dense[s:s + step], Bp).view(-1, tm * k))
        if self.hub_rows is not None:
            gespmm_rows(self.hub_rows, B, into=C[:self.n_hub_rows])
        return C[:self.m]

    @property
    def stats(self) -> dict:
        return {
            "n_hub_chunks": int(self.hub_cols.shape[0]),
            "n_hub_rows": self.n_hub_rows,
            "n_panels": self.n_panels,
            "n_buckets": len(self.buckets),
            "a_dense_bytes": sum(a.numel() * 4 for a, _, _ in self.buckets),
            "gathered_rows": self.gathered_rows,
        }

    def traffic_model(self, k: int) -> dict:
        """Byte model (the JAX package's): dense A buckets read once;
        gathered (deduplicated) B rows follow the take → materialise →
        reduce chain; C written once."""
        by = (self.stats["a_dense_bytes"]
              + 3 * self.gathered_rows * k * 4
              + self.m * k * 4)
        return {"bytes": int(by), "gathered_rows": self.gathered_rows}


def hub_chunks(g: CSRGraph, n_hubs: int, hub_width: int):
    """The hub rows' nonzeros cut into ``hub_width``-wide chunks, as the
    JAX plan builds them: (cols i32 [Nh, w], vals f32 [Nh, w], chunk_row
    i32 [Nh], chunk_len i64 [Nh]).  Row r's chunks are consecutive, full
    but for the last."""
    deg = g.degrees[:n_hubs].astype(np.int64)
    per = -(-deg // hub_width)
    Nh = int(per.sum())
    cols = np.zeros((Nh, hub_width), dtype=np.int32)
    vals = np.zeros((Nh, hub_width), dtype=np.float32)
    chunk_row = np.repeat(np.arange(n_hubs, dtype=np.int32), per)
    e = int(g.row_ptr[n_hubs])
    rows = repeat_arange(deg, total=e)
    pos = np.arange(e) - g.row_ptr[rows]
    chunk_start = np.cumsum(per) - per
    chunk = chunk_start[rows] + pos // hub_width
    cols[chunk, pos % hub_width] = g.col[:e]
    vals[chunk, pos % hub_width] = g.vals[:e]
    local = np.arange(Nh) - chunk_start[chunk_row]
    chunk_len = np.minimum(deg[chunk_row] - local * hub_width, hub_width)
    return cols, vals, chunk_row, chunk_len


def prepare_panel(
    g: CSRGraph,
    tm: int = 128,
    hub_threshold: int = 512,
    hub_width: int = 2048,
    u_bucket_min: int = 128,
    dev: DeviceCSR | None = None,
    device=None,
    **_unused,
) -> PanelPlan:
    """Build the panel plan on the host and move it to the device (``dev``'s
    when given, else ``device``: CUDA unless the caller names another).
    Requires the hub rows (degree ≥ ``hub_threshold``) to form a prefix,
    as a DEG ordering leaves them.  Other keywords of the JAX signature
    (``precision``) are accepted and ignored."""
    from flex_tpu_torch.tiling.panels import build_panels

    # the plan reads the host CSR; ``dev`` only names the device
    device = (resident_csr(g, dev, device).device if dev is not None
              else resolve_device(device))
    deg = g.degrees
    is_hub = deg >= hub_threshold
    n_hubs = int(is_hub.sum())
    if not bool(is_hub[:n_hubs].all()):
        raise NotImplementedError(
            "prepare_panel requires hub rows to form a prefix; apply the "
            "'deg' ordering first (flex_tpu_torch.reorder.reorder(g, 'deg'))")

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    h_cols, h_vals, h_row, h_len = hub_chunks(g, n_hubs, hub_width)
    hub_cols, hub_vals, hub_row = to_dev(h_cols), to_dev(h_vals), to_dev(
        h_row)
    hub_rows = None
    if n_hubs:
        hub_rows = row_tables(
            hub_cols.view(-1), hub_vals.view(-1), hub_row,
            torch.arange(len(h_row), device=device) * hub_width,
            to_dev(h_len), n_hubs)

    # tail: tm-row panels over rows [n_hubs, m)
    e0 = int(g.row_ptr[n_hubs])
    tail = CSRGraph(row_ptr=g.row_ptr[n_hubs:] - e0, col=g.col[e0:],
                    vals=g.vals[e0:], name=g.name, order=g.order)
    buckets = []
    gathered = len(h_row) * hub_width
    n_panels = 0
    if tail.m > 0 and tail.nnz > 0:
        pf = build_panels(tail, tm=tm, u_align=8)
        n_panels = pf.n_panels
        u_len = pf.u_len.astype(np.int64)
        width = np.maximum(
            u_bucket_min,
            2 ** np.ceil(np.log2(np.maximum(u_len, 1))).astype(np.int64),
        )
        for u_pad in np.unique(width):
            sel = np.where(width == u_pad)[0]
            u_pad = int(u_pad)
            P = len(sel)
            a_dense = np.zeros((P, tm, u_pad), dtype=np.float32)
            ucols = np.zeros((P, u_pad), dtype=np.int32)
            ucols[:, :] = pf.ucols[sel, :1]  # pad: the panel's first column
            take_w = min(u_pad, pf.u_pad)
            ucols[:, :take_w] = pf.ucols[sel, :take_w]
            # add.at: padding sentinels land on (0, 0) with value 0 and must
            # not clobber a real nonzero stored there
            np.add.at(
                a_dense,
                (np.repeat(np.arange(P), pf.e_pad), pf.e_row[sel].ravel(),
                 pf.e_slot[sel].ravel()),
                pf.e_val[sel].ravel(),
            )
            buckets.append((to_dev(a_dense), to_dev(ucols),
                            to_dev(sel.astype(np.int64))))
            gathered += P * u_pad
    return PanelPlan(m=g.m, tm=tm, n_hub_rows=n_hubs, n_panels=n_panels,
                     hub_cols=hub_cols, hub_vals=hub_vals,
                     hub_chunk_row=hub_row, buckets=tuple(buckets),
                     hub_rows=hub_rows, gathered_rows=gathered)


def spmm_panel(g: CSRGraph, B: torch.Tensor, **kwargs) -> torch.Tensor:
    return prepare_panel(g, **kwargs)(B)
