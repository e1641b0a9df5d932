"""Autotuner: pick the SpMM strategy per matrix.

Counterpart of ``flex_tpu.bench.autotune``.  :func:`suggest` is a static
time model built from the format statistics (no device needed), with the
JAX package's candidates and eligibility gates: the tiny-graph cut,
band's window-density and bytes gates, the windowed coverage gate on the
budgeted :func:`..ops.window_spmm.window_select`, panel's hub-prefix,
reuse and row-count gates; GE-SpMM is never suggested.  :func:`autotune`
is the measured search, the ground truth when it matters.

The rates below are the card's, measured by ``chip_smoke.py``'s
``[autotune]`` phase on the reddit_posts rbdeg graph at k = 128 and 41,
on an NVIDIA H100 80GB HBM3 at its 700.00 W power limit (nvidia-smi name
and power limit).  The port runs at the caller's k (no padding to 128
lanes), so each path's cost at another k is interpolated linearly in k
between its two measured widths (:func:`_k_factor`).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Sequence

import numpy as np

from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.tiling.stats import tile_stats

_CAL_K = 128      # the width at which the per-item rates below hold
_CAL_K_LO = 41    # the second width the chip run measured

# Each rate: chip_smoke.py's [autotune] line on an NVIDIA H100 80GB HBM3,
# 700.00 W (nvidia-smi name and power limit), reddit_posts rbdeg.
# Kernel 7 over the ELL plan: 1.3916 ms for 26,093,788 padded nonzeros at
# k = 128, seconds per padded nonzero; its time at k = 41 over that.
ELL_S_PER_PAD = 5.333e-11
ELL_K41_RATIO = 0.7124
# The windowed dense half: kernel 1 at k = 128, 11.27 ms over 48,708 kept
# windows (a step's G windows, sentinels included), seconds per window;
# kernel 4 (the transposed plan) at k = 41 over kernel 1 at k = 128.
WIN_S_PER_WINDOW = 2.3145e-7
WIN_K41_RATIO = 0.3916
# FP32 torch.bmm (TF32 off) on (1024, 128, 512) x (1024, 512, 128), the
# shape of panel's tail products, FLOP/s; index_select of 4 M rows of B
# (128 floats), bytes read and written per second.
BMM_FLOPS = 4.083e13
GATHER_BYTES = 1.711e12
# One ELL call on rmat_graph(1024, 8192): the larger of its CUDA-event time
# and the host's time per call, seconds.
FIXED_OVERHEAD = 5.95e-5


@dataclasses.dataclass
class Suggestion:
    method: str
    reason: str
    prep_kwargs: dict
    model: dict | None = None  # predicted seconds per candidate


def _k_factor(k: int, ratio_k41: float) -> float:
    """Cost at width k over the cost at k = 128: the line through the two
    measured widths (ratio ``ratio_k41`` at k = 41, 1 at k = 128),
    floored at a tenth."""
    slope = (1.0 - ratio_k41) / (_CAL_K - _CAL_K_LO)
    return max(ratio_k41 + slope * (k - _CAL_K_LO), 0.1)


def _t_ell(degrees, k: int = 128) -> float:
    from flex_tpu_torch.ops.ell_spmm import ell_padded_nnz

    return (ell_padded_nnz(degrees) * ELL_S_PER_PAD
            * _k_factor(k, ELL_K41_RATIO))


def suggest(
    g: CSRGraph, k: int = 128, tm: int = 128, hub_threshold: int = 512,
    win_tm: int = 256, win_W: int = 128, win_min_count: int = 48,
    dev=None, max_dense_bytes: int | None = None,
) -> Suggestion:
    """Static time-model decision from format statistics.  Candidates: xla
    (tiny graphs), band (contiguous windows), windowed (community blocks
    plus residue), panel (deduplicated-gather dense tail after a
    hub-prefix ordering), ell (the default).  ``dev`` goes to
    :func:`..ops.window_spmm.window_select`, which ignores it."""
    if g.nnz < 50_000:
        return Suggestion("xla", "tiny graph: dispatch-bound", {})

    # band: every panel's columns inside one narrow window; prepare_band's
    # own window model, so eligibility and the format cannot drift
    from flex_tpu_torch.ops.pallas_band import panel_window_stats

    band_tm = max(tm, 256)
    _, w_pad, band_density, band_bytes = panel_window_stats(g, band_tm)
    if band_density >= 0.02 and band_bytes < (4 << 30):
        return Suggestion(
            "band",
            f"window={w_pad} density={band_density:.3f}: contiguous path",
            {"tm": band_tm},
        )

    model: dict[str, float] = {"ell": _t_ell(g.degrees, k) + FIXED_OVERHEAD}

    # windowed: prepare_windowed's own selection, so the model and the built
    # format agree, thresholds included; budgeted, so the count gate rises
    # until the dense array fits
    win_kwargs = {"tm": win_tm, "W": win_W, "min_count": win_min_count}
    from flex_tpu_torch.ops.window_spmm import (
        MAX_DENSE_BYTES, MIN_COVERAGE, window_select,
    )

    if max_dense_bytes is None:
        max_dense_bytes = MAX_DENSE_BYTES
    sel = window_select(g, dev=dev, max_dense_bytes=max_dense_bytes,
                        **win_kwargs)
    if sel["coverage"] >= MIN_COVERAGE:
        n_win = sel["total_steps"] * sel["G"]
        # residue padded nnz ≈ n_res × the fine ladder's ~1.12 pad ratio
        model["windowed"] = (
            n_win * WIN_S_PER_WINDOW * _k_factor(k, WIN_K41_RATIO)
            + sel["n_res"] * 1.12 * ELL_S_PER_PAD
            * _k_factor(k, ELL_K41_RATIO)
            + FIXED_OVERHEAD)

    # panel: dense A over each panel's deduplicated columns, hub rows
    # apart; needs a hub-prefix ordering (deg), high B-row reuse, and the
    # row counts at which the JAX package validated its model
    st = tile_stats(g, bm=tm)
    deg = g.degrees
    hub_prefix_ok = bool(
        (np.diff((deg >= hub_threshold).astype(np.int8)) <= 0).all()
    )
    if hub_prefix_ok:
        u_avg = st.unique_cols_per_panel_avg
        n_p = st.n_row_panels
        gathered = n_p * u_avg
        a_bytes = n_p * tm * (1.3 * u_avg) * 4  # ~bucket padding
        t_panel = ((a_bytes + 3 * gathered * k * 4) / GATHER_BYTES
                   + n_p * tm * u_avg * k * 2 / BMM_FLOPS
                   + FIXED_OVERHEAD)
        reuse = g.nnz / max(gathered, 1)
        if reuse >= 2.0 and g.m <= 100_000:
            model["panel"] = t_panel

    method = min(model, key=model.get)
    kw = {}
    if method == "windowed":
        kw = dict(win_kwargs, sel=sel)
        if k < 128 and win_W % 128 == 0:
            # the narrow-k kernel: faster than the row-major one at k = 41
            # and 32 on the card (PERF.md)
            kw["transposed"] = True
    elif method == "panel":
        kw = {"tm": tm, "hub_threshold": hub_threshold}
    pretty = ", ".join(f"{m}={t*1e3:.3f}ms" for m, t in sorted(model.items()))
    return Suggestion(method, f"time model: {pretty}", kw, model=model)


def autotune(
    g: CSRGraph,
    k: int = 128,
    methods: Sequence[str] = ("ell", "windowed", "panel", "xla", "bcoo"),
    iters: int = 3,
    check: bool = False,
    device=None,
):
    """Measured search: benchmark each candidate on ``device`` (CUDA unless
    the caller names another), return the BenchResults fastest first.  A
    candidate whose format refuses the graph, or that runs out of memory,
    is reported on stderr and left out."""
    import torch

    from flex_tpu_torch.bench.harness import bench_spmm
    from flex_tpu_torch.sparse.device import DeviceCSR

    dev = DeviceCSR.from_graph(g, device)  # one upload for every candidate
    results = []
    for method in methods:
        try:
            results.append(bench_spmm(g, k, method=method, iters=iters,
                                      check=check, dev=dev))
        except (ValueError, NotImplementedError,
                torch.cuda.OutOfMemoryError) as e:
            print(f"autotune: {method} failed: {e}", file=sys.stderr)
    results.sort(key=lambda r: r.t_elap)
    return results
