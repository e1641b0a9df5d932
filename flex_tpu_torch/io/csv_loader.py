"""3-line CSV ⇄ CSR loader and the dense feature operand (host, NumPy).

Copy of ``flex_tpu.io.csv_loader``.  File format: a CSR matrix stored as
three comma-separated lines, row_ptr, col, vals.  A file without the
value line, or named ``amazon``, gets U[-1, 1) values drawn from ``seed``
(the amazon file ships only the first two lines).
"""
from __future__ import annotations

import os

import numpy as np

from flex_tpu_torch.io.native import parse_number_line
from flex_tpu_torch.sparse.csr import CSRGraph


def load_csv(path: str, seed: int = 0) -> CSRGraph:
    """Load a 3-line CSV CSR file; the graph's name is the file's basename
    up to its first dot.  Lines are parsed by the C++ parser where it
    builds (:mod:`.native`), else by NumPy."""
    name = os.path.basename(path).split(".")[0]
    with open(path, "rb") as f:
        row_ptr = parse_number_line(f.readline().strip(), np.int64)
        col = parse_number_line(f.readline().strip(), np.int64)
        vals_line = f.readline().strip()

    if name == "amazon" or not vals_line:
        rng = np.random.default_rng(seed)
        vals = (2.0 * rng.random(len(col)) - 1.0).astype(np.float32)
    else:
        vals = parse_number_line(vals_line, np.float32)

    if len(col) != len(vals):
        raise ValueError(f"{path}: col/vals length mismatch {len(col)} vs {len(vals)}")
    return CSRGraph.from_arrays(row_ptr, col, vals, name=name)


def save_csv(g: CSRGraph, path: str) -> None:
    """Write ``g`` as a 3-line CSV.  Values go through ``{:g}``, which
    keeps six significant digits, so a round trip of arbitrary float32
    values is not exact (as in the JAX package)."""
    with open(path, "w") as f:
        f.write(",".join(map(str, g.row_ptr.tolist())) + "\n")
        f.write(",".join(map(str, g.col.tolist())) + "\n")
        f.write(",".join(f"{v:g}" for v in g.vals.tolist()) + "\n")


def make_features(g: CSRGraph, k: int, seed: int = 1, debug: bool = False) -> np.ndarray:
    """The dense operand B: n×k random U[-1,1) features (row-index
    features with ``debug=True``, for hand-checking)."""
    if debug:
        return np.broadcast_to(
            np.arange(g.n, dtype=np.float32)[:, None], (g.n, k)
        ).copy()
    rng = np.random.default_rng(seed)
    return (2.0 * rng.random((g.n, k)) - 1.0).astype(np.float32)
