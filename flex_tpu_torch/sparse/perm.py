"""Vertex-permutation application with invariant checks (host, NumPy).

Copy of ``flex_tpu.sparse.perm``: given ``perm[new_id] = old_id``,
symmetrically permute rows and columns, sort each row's columns ascending,
and run a checksum test that the two graphs match.
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph, repeat_arange, repeat_values


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """old→new map from a new→old map (raises unless a bijection)."""
    n = len(perm)
    # explicit range check: fancy indexing would silently wrap negatives
    if n and (int(perm.min()) < 0 or int(perm.max()) >= n):
        raise ValueError("perm entries out of range [0, n)")
    inv = np.full(n, -1, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    if (inv < 0).any():
        raise ValueError("perm is not a bijection")
    return inv


def apply_vertex_order(
    g: CSRGraph, perm: np.ndarray, order_abbr: str, check: bool = True
) -> CSRGraph:
    """Return ``P A P^T`` with per-row sorted columns.

    Args:
      g: input graph.
      perm: int[n] with ``perm[new] = old``.
      order_abbr: ordering tag for the result (e.g. "RBD").
      check: run the graph-match invariants.
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = g.m
    if len(perm) != n:
        raise ValueError(f"perm has {len(perm)} entries, graph has {n} rows")
    old_to_new = invert_permutation(perm)

    new_deg = g.degrees[perm]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_deg, out=row_ptr[1:])

    # gather index: new row r takes old edges g.row_ptr[perm[r]] .. +deg
    src_start = g.row_ptr[perm]
    gather = repeat_values(src_start - row_ptr[:-1], new_deg, total=g.nnz
                           ) + np.arange(g.nnz, dtype=np.int64)
    col_new = old_to_new[g.col[gather]]
    vals_new = g.vals[gather]

    # sort columns within each row: stable argsort of the fused row*n+col key
    key = repeat_arange(new_deg, total=g.nnz)
    np.multiply(key, n, out=key)
    np.add(key, col_new, out=key)
    sort_idx = np.argsort(key, kind="stable")
    del key
    col_new = col_new[sort_idx].astype(np.int32)
    vals_new = vals_new[sort_idx]

    out = CSRGraph(
        row_ptr=row_ptr, col=col_new, vals=vals_new, name=g.name, order=order_abbr
    )
    if check:
        check_permutation_invariants(g, out, old_to_new)
    return out


def check_permutation_invariants(
    old: CSRGraph, new: CSRGraph, old_to_new: np.ndarray
) -> None:
    """Per-destination weighted edge-multiplicity checksums must match
    under the relabeling."""
    if old.nnz != new.nnz or old.m != new.m:
        raise AssertionError("permuted graph changed shape")
    n = old.m

    old_rows = repeat_arange(old.degrees, total=old.nnz)
    new_rows = repeat_arange(new.degrees, total=new.nnz)

    inc_old = old_rows & 0xF
    # new row r corresponds to old row perm[r]; weight by the OLD row id
    new_to_old = np.empty(n, dtype=np.int64)
    new_to_old[old_to_new] = np.arange(n, dtype=np.int64)
    inc_new = new_to_old[new_rows] & 0xF

    chk_old = np.bincount(old.col, weights=inc_old, minlength=n)
    chk_new = np.bincount(new.col, weights=inc_new, minlength=n)
    if not np.array_equal(chk_old, chk_new[old_to_new]):
        raise AssertionError("permutation edge-multiplicity checksum mismatch")

    chkw_old = np.bincount(old.col, weights=old.vals.astype(np.float64), minlength=n)
    chkw_new = np.bincount(new.col, weights=new.vals.astype(np.float64), minlength=n)
    if not np.allclose(chkw_old, chkw_new[old_to_new], rtol=1e-10, atol=1e-9):
        raise AssertionError("permutation weight checksum mismatch")
