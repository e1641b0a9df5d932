"""Tiling occupancy and data-volume statistics (host, NumPy).

Copy of ``flex_tpu.tiling.stats``: pure functions of (graph, tile shape)
that measure how well an ordering densifies (bm × bn) tiles.  The
autotuner reads them (:func:`tile_stats`), and :func:`data_volume_est`
predicts each strategy's memory traffic before anything touches a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph, repeat_arange


@dataclasses.dataclass(frozen=True)
class TileStats:
    """Occupancy of a (bm × bn) blocking of the matrix."""

    bm: int
    bn: int
    n_blocks: int            # nonempty blocks
    n_row_panels: int
    nnz: int
    occupancy: float         # nnz / (n_blocks · bm · bn)
    blocks_per_panel_max: int
    blocks_per_panel_avg: float
    panel_nnz_max: int
    panel_nnz_imbalance: float  # max/avg − 1
    col_span_p99: int        # 99th-pct column span of a row panel
    unique_cols_per_panel_avg: float  # B-row reuse factor inside a panel

    @property
    def flop_inflation(self) -> float:
        """Dense-block FLOPs over effective FLOPs (padding waste)."""
        return (self.n_blocks * self.bm * self.bn) / max(self.nnz, 1)

    def hbm_bytes_bsr(self, k: int, a_bytes: int = 4, b_bytes: int = 4) -> int:
        """Predicted device-memory traffic of a BSR-style kernel: every
        nonempty block reads its dense A block plus a (bn × k) slab of B;
        C written once.  The name is the JAX package's."""
        a_traffic = self.n_blocks * self.bm * self.bn * a_bytes
        b_traffic = self.n_blocks * self.bn * k * b_bytes
        c_traffic = self.n_row_panels * self.bm * k * 4
        return a_traffic + b_traffic + c_traffic


def tile_stats(g: CSRGraph, bm: int, bn: int = 128) -> TileStats:
    rows = repeat_arange(g.degrees, total=g.nnz)
    brow = rows // bm
    bcol = g.col.astype(np.int64) // bn
    n_bcols = -(-g.n // bn)
    n_panels = -(-g.m // bm)

    keys = brow * n_bcols + bcol
    uniq = np.unique(keys)
    n_blocks = len(uniq)

    blocks_per_panel = np.bincount((uniq // n_bcols).astype(np.int64), minlength=n_panels)
    panel_nnz = np.bincount(brow, minlength=n_panels)

    # Column span + unique-column count per panel.
    col_span = np.zeros(n_panels, dtype=np.int64)
    uniq_cols = np.zeros(n_panels, dtype=np.int64)
    if g.nnz:
        order = np.lexsort((g.col, brow))
        sb, sc = brow[order], g.col.astype(np.int64)[order]
        starts = np.searchsorted(sb, np.arange(n_panels))
        ends = np.searchsorted(sb, np.arange(n_panels) + 1)
        nonempty = ends > starts
        first = np.where(nonempty, starts, 0)
        last = np.where(nonempty, ends - 1, 0)
        col_span = np.where(nonempty, sc[last] - sc[first] + 1, 0)
        # unique columns: count boundaries within each panel's sorted run
        new_col = np.ones(g.nnz, dtype=bool)
        new_col[1:] = (sc[1:] != sc[:-1]) | (sb[1:] != sb[:-1])
        uniq_cols = np.bincount(sb[new_col], minlength=n_panels)

    avg_nnz = panel_nnz.mean() if n_panels else 0.0
    return TileStats(
        bm=bm,
        bn=bn,
        n_blocks=n_blocks,
        n_row_panels=n_panels,
        nnz=g.nnz,
        occupancy=g.nnz / max(n_blocks * bm * bn, 1),
        blocks_per_panel_max=int(blocks_per_panel.max()) if n_panels else 0,
        blocks_per_panel_avg=float(blocks_per_panel.mean()) if n_panels else 0.0,
        panel_nnz_max=int(panel_nnz.max()) if n_panels else 0,
        panel_nnz_imbalance=float(panel_nnz.max() / avg_nnz - 1.0) if avg_nnz else 0.0,
        col_span_p99=int(np.percentile(col_span, 99)) if n_panels else 0,
        unique_cols_per_panel_avg=float(uniq_cols.mean()) if n_panels else 0.0,
    )


def data_volume_est(g: CSRGraph, k: int, strategy: str, bm: int = 8, bn: int = 128) -> dict:
    """Byte-model comparison across kernel strategies.  Returns bytes and
    the implied arithmetic intensity (2·nnz·k FLOPs / bytes)."""
    eff_flops = 2 * g.nnz * k
    if strategy == "xla":
        # the gather materialises nnz×k, the multiply reads and writes it,
        # the scatter-add reads it
        b = g.nnz * k * 4 * 4 + g.m * k * 4
    elif strategy == "bsr":
        b = tile_stats(g, bm, bn).hbm_bytes_bsr(k)
    elif strategy == "ideal":
        b = g.nnz * 8 + g.n * k * 4 + g.m * k * 4  # A once, B once, C once
    else:
        raise ValueError(strategy)
    return {"bytes": int(b), "ai": eff_flops / b, "eff_flops": eff_flops}
