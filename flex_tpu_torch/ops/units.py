"""Work units of the unit kernels: host tables that cut long ranges (a
panel's steps, a block rank's slots, a row's nonzeros) into pieces of a
few, one CUDA block or warp each, so no long range holds the card behind
one owner.  NumPy only; the kernels' modules move the tables to the
device."""
from __future__ import annotations

import numpy as np


def work_units(ptr: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """Cut the ranges ``ptr[i] .. ptr[i+1]`` (a panel's steps, a block rank's
    slots) into consecutive units of at most ``chunk``, as evenly as the
    count allows.  Returns

      units   int32[n_units, 4]  (owner i, lo, hi, part): a unit of an owner
              with one unit has part -1 and writes the output tile; the
              others write partial tile ``part``; an owner's parts are
              consecutive and in range order.  An empty range keeps one
              empty unit, so its output tile is written (as zeros).
      splits  int32[n_split, 3]  (owner, part_lo, part_hi) for every owner
              with several units: its output tile is the sum of those
              partial tiles, taken in that order.
    """
    ptr = np.asarray(ptr, np.int64)
    length = np.diff(ptr)
    per = np.maximum(-(-length // chunk), 1)
    owner = np.repeat(np.arange(len(per)), per)
    start = np.cumsum(per) - per
    j = np.arange(len(owner)) - start[owner]
    L, c = length[owner], per[owner]
    multi = c > 1
    part = np.where(multi, np.cumsum(multi) - 1, -1)
    units = np.stack([owner, ptr[owner] + j * L // c,
                      ptr[owner] + (j + 1) * L // c, part], axis=1)
    split = np.flatnonzero(per > 1)
    part_lo = part[start[split]]
    splits = np.stack([split, part_lo, part_lo + per[split]], axis=1)
    return units.astype(np.int32), splits.astype(np.int32)


def row_units(row_len: np.ndarray, chunk: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`work_units` of rows of ``row_len`` nonzeros each, with every
    unit's (lo, hi) counted from its row's first nonzero: the row-unit
    kernel adds the row's start in its flat store."""
    ptr = np.concatenate([[0], np.cumsum(np.asarray(row_len, np.int64))])
    if ptr[-1] >= 2**31:
        raise ValueError("the row-unit tables are int32: nnz must be < 2^31")
    units, splits = work_units(ptr, chunk)
    units[:, 1:3] -= ptr[units[:, 0]].astype(np.int32)[:, None]
    return units, splits
