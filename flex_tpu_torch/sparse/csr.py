"""CSR sparse-matrix container and graph statistics (host side, NumPy).

Copy of ``flex_tpu.sparse.csr``: :class:`CSRGraph` is an immutable host
container that the loaders, the reordering and format-selection passes and
the command line consume; tensors are made only when a format is built on
a device.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Per-dataset GCN label widths (the GCN output width ``c``).
DATASET_LABEL_WIDTH = {
    "polblogs": 2,
    "cora": 7,
    "citeseer": 6,
    "pubmed": 3,
    "ppi": 121,
    "reddit": 41,
    "flickr": 7,
    "yelp": 100,
    "amazon": 107,
}
DEFAULT_LABEL_WIDTH = 100


def indicator_cumsum(starts, total: int, dtype=np.int64) -> np.ndarray:
    """Segment ids per element from segment start offsets: zeros with +1
    scattered at each start (duplicates from empty segments accumulate),
    then a running sum.  Runs at memory bandwidth."""
    out = np.zeros(total, dtype=dtype)
    s = np.asarray(starts, dtype=np.int64)
    # a start AT offset 0 still counts (leading empty segment); only clip
    # past-end starts (trailing empty segments)
    np.add.at(out, s[s < total], 1)
    np.cumsum(out, out=out)
    return out


def repeat_arange(counts, dtype=np.int64, total: int | None = None
                  ) -> np.ndarray:
    """``np.repeat(np.arange(len(counts)), counts)`` without np.repeat,
    whose per-element repeat loop runs far below memory bandwidth."""
    counts = np.asarray(counts)
    if total is None:
        total = int(counts.sum())
    if len(counts) == 0 or total == 0:
        return np.zeros(0, dtype=dtype)
    return indicator_cumsum(np.cumsum(counts[:-1], dtype=np.int64),
                            total, dtype=dtype)


def repeat_values(values, counts, total: int | None = None) -> np.ndarray:
    """``np.repeat(values, counts)`` for large outputs: one gather through
    :func:`repeat_arange`."""
    values = np.asarray(values)
    return values[repeat_arange(counts, dtype=np.int64, total=total)]


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Directedness and degree statistics."""

    n_edges_one_way: int
    n_edges_asymmetric: int
    n_nodes_zero_out: int
    n_nodes_zero_in: int
    n_nodes_zero_deg: int
    n_unit_rows: int  # rows with exactly one nonzero

    @property
    def is_directed(self) -> bool:
        return self.n_edges_one_way > 0


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """A square sparse matrix in CSR, treated as a graph adjacency.

    Attributes:
      row_ptr: int64[m+1] row offsets.
      col:     int32[nnz] column indices (sorted ascending within each row
               after any reordering pass).
      vals:    float32[nnz] edge weights.
      name:    dataset name (sets the GCN label width ``c``).
      order:   vertex-order abbreviation, "OVO" = original vertex order.
    """

    row_ptr: np.ndarray
    col: np.ndarray
    vals: np.ndarray
    name: str = "unnamed"
    order: str = "OVO"

    def __post_init__(self):
        if self.row_ptr.ndim != 1 or self.col.ndim != 1:
            raise ValueError("row_ptr and col must be 1-D")
        if self.col.shape != self.vals.shape:
            raise ValueError("col and vals differ in shape")
        if int(self.row_ptr[-1]) != len(self.col):
            raise ValueError("row_ptr[-1] != nnz")

    @property
    def m(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def n(self) -> int:
        return self.m  # square

    @property
    def nnz(self) -> int:
        return len(self.col)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    @property
    def label_width(self) -> int:
        """GCN output width ``c`` for this dataset."""
        return DATASET_LABEL_WIDTH.get(self.name, DEFAULT_LABEL_WIDTH)

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    @property
    def avg_degree(self) -> float:
        return self.nnz / max(self.m, 1)

    @staticmethod
    def from_arrays(row_ptr, col, vals, name="unnamed", order="OVO") -> "CSRGraph":
        return CSRGraph(
            row_ptr=np.asarray(row_ptr, dtype=np.int64),
            col=np.asarray(col, dtype=np.int32),
            vals=np.asarray(vals, dtype=np.float32),
            name=name,
            order=order,
        )

    @staticmethod
    def from_coo(rows, cols, vals, m, name="unnamed", order="OVO") -> "CSRGraph":
        rows = np.asarray(rows, dtype=np.int64)
        order_idx = np.lexsort((np.asarray(cols), rows))
        rows, cols, vals = (rows[order_idx], np.asarray(cols)[order_idx],
                            np.asarray(vals)[order_idx])
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        row_ptr[1:] = np.bincount(rows, minlength=m)
        np.cumsum(row_ptr, out=row_ptr)
        return CSRGraph.from_arrays(row_ptr, cols, vals, name=name, order=order)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.vals, self.col.astype(np.int64), self.row_ptr), shape=self.shape
        )

    def _edge_keys(self):
        """(fwd, rev) int64 edge keys, fwd pre-sorted when cols are sorted
        within rows."""
        m, nnz = self.m, self.nnz
        rows = repeat_arange(self.degrees, total=nnz)
        fwd = np.empty(nnz, np.int64)
        np.multiply(rows, m, out=fwd)
        np.add(fwd, self.col, out=fwd)
        rev = np.empty(nnz, np.int64)
        np.multiply(self.col, m, out=rev, dtype=np.int64, casting="unsafe")
        np.add(rev, rows, out=rev)
        return fwd, rev

    @cached_property
    def pattern_is_symmetric(self) -> bool:
        """Exact structural symmetry (values ignored): the multiset of
        (dst, src) keys equals the (src, dst) keys."""
        m, nnz = self.m, self.nnz
        if nnz == 0:
            return True
        if not np.array_equal(np.bincount(self.col, minlength=m),
                              self.degrees):
            return False
        fwd, rev = self._edge_keys()
        if not np.all(fwd[:-1] <= fwd[1:]):
            fwd.sort()
        rev.sort()
        return bool(np.array_equal(fwd, rev))

    @cached_property
    def stats(self) -> GraphStats:
        """One-way edges, asymmetric weights and zero-degree nodes, by
        looking up each edge's reverse among the sorted edge keys.  The
        queries go in the reverse keys' sorted order: sorted queries
        advance through the table sequentially."""
        m, nnz = self.m, self.nnz
        if nnz:
            fwd_keys, rev_keys = self._edge_keys()
            if np.all(fwd_keys[:-1] <= fwd_keys[1:]):
                sorted_keys, sorted_vals = fwd_keys, self.vals
            else:
                sort_idx = np.argsort(fwd_keys, kind="stable")
                sorted_keys = fwd_keys[sort_idx]
                sorted_vals = self.vals[sort_idx]
            qi = np.argsort(rev_keys, kind="stable")
            rev_q = rev_keys[qi]
            pos_c = np.minimum(np.searchsorted(sorted_keys, rev_q), nnz - 1)
            has_rev = sorted_keys[pos_c] == rev_q
            n_one_way = int(nnz - has_rev.sum())
            n_asym = int((has_rev
                          & (sorted_vals[pos_c] != self.vals[qi])).sum())
        else:
            n_one_way = n_asym = 0

        z_out = self.degrees == 0
        z_in = np.bincount(self.col, minlength=m) == 0
        return GraphStats(
            n_edges_one_way=n_one_way,
            n_edges_asymmetric=n_asym,
            n_nodes_zero_out=int(z_out.sum()),
            n_nodes_zero_in=int(z_in.sum()),
            n_nodes_zero_deg=int((z_out & z_in).sum()),
            n_unit_rows=int((self.degrees == 1).sum()),
        )

    def degree_histogram(self, bounds=(2, 4, 8, 16)) -> np.ndarray:
        """Rows per degree bucket [0, b0), [b0, b1), ..., [b_last, inf)."""
        d = self.degrees
        edges = [0, *bounds, np.iinfo(np.int64).max]
        return np.array(
            [int(((d >= lo) & (d < hi)).sum()) for lo, hi in zip(edges, edges[1:])]
        )

    def __repr__(self):
        return (
            f"CSRGraph({self.name!r}, order={self.order}, m={self.m}, "
            f"nnz={self.nnz}, avg_deg={self.avg_degree:.2f})"
        )
