"""How empty are the windowed format's dense tiles at sub-window grain?

Counterpart of ``experiments/subtile_occupancy.py`` (NumPy only, no card
work): on the headline graph (:func:`..bench.headline.load_graph`), for
``window_select(tm=256, W=128, min_count=mc)`` at mc = 64, 32 and 16, the
share of non-empty strips of 8, 16, 32 and 64 rows among all the kept
windows' strips (sentinel pads included), and the dense bytes a format
that stored only those strips would hold.  The script read a ``/tmp`` npz.

    python -m flex_tpu_torch.experiments.subtile_occupancy
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.ops.window_spmm import window_select
from flex_tpu_torch.sparse.device import resolve_device

MCS = (64, 32, 16)
SUBS = (8, 16, 32, 64)


def strip_lines(g, tm: int = 256, W: int = 128, mcs=MCS, subs=SUBS) -> list:
    """The script's lines: (mc, strip height) -> non-empty strips."""
    lines = []
    for mc in mcs:
        sel = window_select(g, tm=tm, W=W, min_count=mc)
        nblk = sel["nblk"]
        slot = sel["slot"]

        rows = np.repeat(np.arange(g.m, dtype=np.int64), g.degrees)
        pan = rows // tm
        blk = g.col.astype(np.int64) // W
        key = pan * nblk + blk
        j1 = slot[key].astype(np.int64)
        hit = j1 > 0
        # global window id = pstep0[p]*G + (j-1)  (steps are G windows)
        Gs = sel["G"]
        wid = (sel["pstep0"][pan[hit]] * Gs + (j1[hit] - 1))
        n_windows = sel["total_steps"] * Gs  # includes sentinel pads
        for sub in subs:
            strips = tm // sub
            skey = wid * strips + (rows[hit] % tm) // sub
            nonempty = len(np.unique(skey))
            frac = nonempty / (n_windows * strips)
            lines.append(
                f"mc={mc} cov={sel['coverage']:.3f} "
                f"dense={sel['dense_bytes']/2**30:.2f}GiB sub={sub}: "
                f"nonempty strips {nonempty}/{n_windows * strips} "
                f"= {frac:.3f}  -> packed bytes "
                f"{sel['dense_bytes']*frac/2**30:.2f} GiB")
    return lines


def main(device=None, graph=None) -> dict:
    """The script's lines on ``graph``.  Returns them under "lines"."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.bench.headline import load_graph

        graph = load_graph()
    lines = strip_lines(graph)
    for line in lines:
        p(line)
    return {"device": banner(dev), "lines": lines}


if __name__ == "__main__":
    main()
