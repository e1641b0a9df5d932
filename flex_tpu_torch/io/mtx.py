"""MatrixMarket (.mtx) → CSRGraph (host).

Copy of ``flex_tpu.io.mtx``: reads an MTX file (coordinate or array,
general or symmetric) with SciPy, drops explicit zeros, and gives the same
CSR container the 3-line CSV loader gives.
"""
from __future__ import annotations

import os

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph


def load_mtx(path: str, name: str | None = None) -> CSRGraph:
    import scipy.io
    import scipy.sparse as sp

    mat = scipy.io.mmread(path)  # symmetric, skew and pattern storage
    if not sp.issparse(mat):
        mat = sp.coo_matrix(mat)
    mat = mat.tocoo()
    n = max(mat.shape)
    vals = np.asarray(mat.data, dtype=np.float32)
    keep = vals != 0  # pattern matrices come back as ones
    if name is None:
        name = os.path.basename(path).split(".")[0]
    return CSRGraph.from_coo(
        mat.row[keep], mat.col[keep], vals[keep], n, name=name
    )


def mtx_to_csv(mtx_path: str, csv_path: str) -> CSRGraph:
    """MTX → 3-line CSV CSR on disk; returns the graph."""
    from flex_tpu_torch.io.csv_loader import save_csv

    g = load_mtx(mtx_path)
    save_csv(g, csv_path)
    return g
