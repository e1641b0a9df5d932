"""Ordering file I/O (host).

Copy of ``flex_tpu.reorder.inout``: persist a computed vertex order so an
expensive pass (gorder, rabbit on a large graph) runs once and is
reloaded afterwards.
"""
from __future__ import annotations

import numpy as np


def save_order(perm: np.ndarray, path: str) -> None:
    np.save(path if path.endswith(".npy") else path + ".npy",
            np.asarray(perm, dtype=np.int64))


def load_order(path: str) -> np.ndarray:
    from flex_tpu_torch.sparse.perm import invert_permutation

    perm = np.load(path if path.endswith(".npy") else path + ".npy")
    invert_permutation(perm)  # validates the bijection
    return perm.astype(np.int64)
