"""Row-panel tiling (host, NumPy): CSR → per-panel unique-column format.

Copy of ``flex_tpu.tiling.panels``; the same graph gives the same arrays.
Rows are grouped into fixed-height panels; each panel records its sorted
unique column ids (the rows of B it needs) and its nonzeros as
(local_row, slot into the unique columns, value).  A panel owns its
output rows outright, so no two panels write the same row.

All arrays are padded to static shapes:
  - unique columns padded (repeating the last real column) to a per-format
    width ``u_pad``; padded slots point at a real B row but carry zero values.
  - nnz per panel padded to ``e_pad`` with (row 0, slot 0, val 0) sentinels.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph, repeat_arange


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class PanelFormat:
    """Static-shape row-panel format.

    Attributes:
      tm: panel height (rows).
      ucols: int32[n_panels, u_pad] — sorted unique columns per panel,
        right-padded by repeating the last valid entry.
      u_len: int32[n_panels] — valid unique-column count per panel.
      e_row: int32[n_panels, e_pad] — local row (0..tm) of each nonzero.
      e_slot: int32[n_panels, e_pad] — index into ucols of each nonzero.
      e_val: float32[n_panels, e_pad] — value (0 for padding).
      e_len: int32[n_panels] — valid nnz per panel.
    """

    tm: int
    m: int
    n: int
    nnz: int
    ucols: np.ndarray
    u_len: np.ndarray
    e_row: np.ndarray
    e_slot: np.ndarray
    e_val: np.ndarray
    e_len: np.ndarray

    @property
    def n_panels(self) -> int:
        return self.ucols.shape[0]

    @property
    def u_pad(self) -> int:
        return self.ucols.shape[1]

    @property
    def e_pad(self) -> int:
        return self.e_row.shape[1]

    # -- diagnostics ---------------------------------------------------------

    @property
    def gather_bytes(self) -> int:
        """B bytes a gather-per-panel kernel reads (f32, per feature col 4B)."""
        return int(self.u_len.sum()) * 4

    def dense_a(self, dtype=np.float32) -> np.ndarray:
        """Materialise per-panel dense A blocks [n_panels, tm, u_pad]
        (the batched product's operand; memory Σ tm·u_pad·itemsize)."""
        A = np.zeros((self.n_panels, self.tm, self.u_pad), dtype=dtype)
        p = np.repeat(np.arange(self.n_panels), self.e_pad).reshape(
            self.n_panels, self.e_pad
        )
        # add.at: padding sentinels land on (0, 0) with value 0 and must not
        # clobber a real nonzero stored there.
        np.add.at(A, (p, self.e_row, self.e_slot), self.e_val)
        return A

    def validate(self, g: CSRGraph) -> None:
        """Full reconstruction check: the panels hold exactly the graph's
        (row, col, val) entries."""
        import scipy.sparse as sp

        rows = (
            np.repeat(np.arange(self.n_panels), self.e_pad) * self.tm
            + self.e_row.ravel()
        )
        cols = self.ucols[
            np.repeat(np.arange(self.n_panels), self.e_pad), self.e_slot.ravel()
        ]
        vals = self.e_val.ravel()
        keep = vals != 0
        got = sp.coo_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=(self.n_panels * self.tm, g.n)
        ).tocsr()
        want = sp.csr_matrix(
            (g.vals, g.col.astype(np.int64), g.row_ptr), shape=(g.m, g.n)
        )
        want.resize(got.shape)
        diff = got - want
        # Zero-valued stored entries can't be distinguished from padding; the
        # reconstruction must still match exactly as a matrix.
        max_diff = abs(diff).max() if diff.nnz else 0
        assert max_diff == 0, f"panel reconstruction mismatch (max {max_diff})"
        assert int(self.e_len.sum()) == g.nnz


def build_panels(
    g: CSRGraph, tm: int = 128, u_align: int = 8, e_align: int = 8
) -> PanelFormat:
    """Vectorised CSR → panel conversion (host preprocessing, counted as
    tPre): O(nnz log nnz) in NumPy sorts."""
    m, n, nnz = g.m, g.n, g.nnz
    n_panels = max(-(-m // tm), 1)
    rows = repeat_arange(g.degrees, total=nnz)
    cols = g.col.astype(np.int64)
    panel = rows // tm

    # Sort nnz by (panel, col) to find per-panel unique columns.
    order = np.lexsort((cols, panel))
    p_s, c_s = panel[order], cols[order]
    new_run = np.ones(nnz, dtype=bool)
    if nnz:
        new_run[1:] = (c_s[1:] != c_s[:-1]) | (p_s[1:] != p_s[:-1])
    u_len = np.bincount(p_s[new_run], minlength=n_panels).astype(np.int32)
    u_pad = max(_round_up(int(u_len.max()) if n_panels else 0, u_align), u_align)

    # slot index of each (sorted) nnz = running count of uniques in its panel
    run_id = np.cumsum(new_run) - 1  # global unique-run index
    first_run_of_panel = np.zeros(n_panels, dtype=np.int64)
    np.cumsum(u_len[:-1], out=first_run_of_panel[1:])
    slot_sorted = run_id - first_run_of_panel[p_s]

    # unique column table
    ucols = np.zeros((n_panels, u_pad), dtype=np.int32)
    urun_panel = p_s[new_run]
    urun_slot = slot_sorted[new_run]
    ucols[urun_panel, urun_slot] = c_s[new_run]
    # pad by repeating the last valid column (keeps gathers in-bounds)
    pad_mask = (
        np.arange(u_pad, dtype=np.int32)[None, :] >= u_len[:, None]
    )
    last_col = ucols[np.arange(n_panels), np.maximum(u_len - 1, 0)]
    ucols = np.where(pad_mask, last_col[:, None], ucols)

    # scatter slots back to original nnz order, then lay out per-panel edges
    slot = np.empty(nnz, dtype=np.int64)
    slot[order] = slot_sorted

    e_len = np.bincount(panel, minlength=n_panels).astype(np.int32)
    e_pad = max(_round_up(int(e_len.max()) if n_panels else 0, e_align), e_align)

    # position of each nnz within its panel (CSR order preserved)
    first_nnz_of_panel = np.zeros(n_panels, dtype=np.int64)
    np.cumsum(e_len[:-1].astype(np.int64), out=first_nnz_of_panel[1:])
    pos_in_panel = np.arange(nnz, dtype=np.int64) - first_nnz_of_panel[panel]

    e_row = np.zeros((n_panels, e_pad), dtype=np.int32)
    e_slot = np.zeros((n_panels, e_pad), dtype=np.int32)
    e_val = np.zeros((n_panels, e_pad), dtype=np.float32)
    e_row[panel, pos_in_panel] = (rows - panel * tm).astype(np.int32)
    e_slot[panel, pos_in_panel] = slot.astype(np.int32)
    e_val[panel, pos_in_panel] = g.vals

    return PanelFormat(
        tm=tm, m=m, n=n, nnz=nnz,
        ucols=ucols, u_len=u_len,
        e_row=e_row, e_slot=e_slot, e_val=e_val, e_len=e_len,
    )
