"""Host model of the window structure of an ordered graph.

Counterpart of ``experiments/analyze_windows.py`` (NumPy only, no card
work).  For each (tm, W, min_count) of the script it prints coverage, the
kept windows a panel (p50 / p90 / p99 / max), the compact and fixed-J
dense A bytes, the B bytes fetched again after a per-panel sort of block
ids, the residue's padded nonzeros and a time model

    t_dense = (A_bytes + B_fetch_bytes + 2·C_bytes) / BW
    t_res   = res_padded_nnz · ELL_NS

then the panel method's sampled unique columns.  ``BW`` = 250e9 B/s and
``ELL_NS`` = 7.3e-9 s are the constants as the script has them, measured
on the TPU (its HBM stream and its f32 ELL cost a padded nonzero at
k = 128); the model's times are the TPU's, not the card's, and no card
figure is added to it.  The graph is the headline's
(:func:`..bench.headline.load_graph`) unless one is given; the script
read a ``/tmp`` npz named on its command line.

    python -m flex_tpu_torch.experiments.analyze_windows
"""
from __future__ import annotations

import numpy as np

from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.ops.ell_spmm import ell_padded_nnz
from flex_tpu_torch.sparse.device import resolve_device

BW = 250e9       # the TPU's measured HBM stream
ELL_NS = 7.3e-9  # the TPU's measured cost a padded nonzero, ELL f32 k=128
TMS, WS, MCS = (128, 256), (128, 256), (64, 128, 192, 256)

ell_padded = ell_padded_nnz  # the kernel's own padded-nnz model


def window_rows(g, k: int = 128) -> list:
    """The script's (tm, W, mc) lines, in its order."""
    m, nnz = g.m, g.nnz
    rows_of = np.repeat(np.arange(m, dtype=np.int64), g.degrees)
    lines = []
    for tm in TMS:
        P = -(-m // tm)
        for W in WS:
            nblk = -(-g.n // W)
            key = (rows_of // tm) * nblk + (g.col.astype(np.int64) // W)
            cnt_flat = np.bincount(key, minlength=P * nblk)
            cnt = cnt_flat.reshape(P, nblk)
            for mc in MCS:
                valid = cnt >= mc
                nb_per = valid.sum(1)
                NB = int(nb_per.sum())
                if NB == 0:
                    continue
                covered = int(cnt[valid].sum())
                cov = covered / nnz
                Jmax = int(nb_per.max())
                ids = np.where(valid, np.arange(nblk)[None, :],
                               np.int64(nblk))
                ids.sort(axis=1)
                refetch = 0
                for j in range(min(Jmax, 64)):
                    col_j = ids[:, j]
                    refetch += 1 + int((np.diff(col_j) != 0).sum())
                hit = valid.reshape(-1)[key]
                res_deg = g.degrees - np.bincount(rows_of[hit], minlength=m)
                res_pad = ell_padded(res_deg)
                t_res = res_pad * ELL_NS
                A_fix = P * tm * min(Jmax, 16) * W * 4
                A_cmp = NB * tm * W * 4
                B_fetch = refetch * W * k * 4
                C = m * k * 4
                t_dense = (A_cmp + B_fetch + 2 * C) / BW
                t = t_dense + t_res
                q = np.percentile(nb_per, [50, 90, 99])
                lines.append(
                    f"tm={tm} W={W} mc={mc}: cov={cov:.3f} NB={NB} "
                    f"J(p50/90/99/max)={q[0]:.0f}/{q[1]:.0f}/{q[2]:.0f}/"
                    f"{Jmax} "
                    f"A_cmp={A_cmp/1e9:.2f}GB A_fixJ16={A_fix/1e9:.2f}GB "
                    f"Bf={B_fetch/1e9:.2f}GB res={res_pad/1e6:.1f}Mpad "
                    f"t={t*1e3:.0f}ms ({t_dense*1e3:.0f}+{t_res*1e3:.0f}) "
                    f"-> {2*nnz*k/t/1e9:.0f} GF/s")
    return lines


def panel_rows(g) -> list:
    """The panel method's economics: sampled unique columns a panel."""
    m, nnz = g.m, g.nnz
    lines = []
    for tm in TMS:
        P = -(-m // tm)
        u = np.array([
            len(np.unique(g.col[g.row_ptr[min(q * tm, m)]:
                                g.row_ptr[min((q + 1) * tm, m)]]))
            for q in range(0, P, max(P // 200, 1))
        ])
        seg = np.diff(np.r_[g.row_ptr[::tm], nnz])
        lines.append(f"panel tm={tm}: sampled unique-cols mean={u.mean():.0f} "
                     f"p90={np.percentile(u, 90):.0f} "
                     f"reuse~{seg.mean()/max(u.mean(), 1):.2f}")
    return lines


def main(device=None, graph=None, k: int = 128) -> dict:
    """The script's lines on ``graph``.  Returns them under "lines"."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.bench.headline import load_graph

        graph = load_graph()
    g = graph
    p(f"{g.name}: m={g.m} nnz={g.nnz}")
    p(f"model constants, the TPU's as the script has them: BW={BW:.3g} B/s, "
      f"ELL_NS={ELL_NS:.3g} s")
    base_ell = ell_padded(g.degrees) * ELL_NS
    lines = [f"pure-ELL model: padded={ell_padded(g.degrees)} "
             f"t={base_ell*1e3:.1f}ms "
             f"-> {2*g.nnz*k/base_ell/1e9:.0f} GF/s"]
    lines += window_rows(g, k) + panel_rows(g)
    for line in lines:
        p(line)
    return {"device": banner(dev), "lines": lines}


if __name__ == "__main__":
    main()
