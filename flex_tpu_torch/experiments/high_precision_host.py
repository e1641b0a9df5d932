"""Error study: could the windowed plan's dense half run at a lower
precision and still pass ``res_check``?

Counterpart of ``experiments/high_precision_host.py``.  On the headline
graph (reddit_posts rbdeg, :func:`..bench.headline.load_graph`) the
nonzeros that ``window_select(tm=256, W=128, min_count=64,
max_dense_bytes=6 GiB)`` covers are the dense half's; the rest (the
residue) is exact f32 in every variant.  B is the script's (uniform in
[-1, 1), NumPy seed 0).  Three variants of the dense half, each summed in
f32 in nonzero order and added to the exact residue, are held to an f64
gold with ``res_check`` (per row eps32 · row_nnz · 4):

- ``f32 dense (HIGHEST analog)``: a·b in f32;
- ``HIGH 3-pass dense``: hi(a)hi(b) + hi(a)lo(b) + lo(a)hi(b), each
  product exact in f32 (:func:`split_hi_lo`), the TPU's HIGH;
- ``DEFAULT 1-pass dense (control)``: hi(a)hi(b), the TPU's DEFAULT.

The arithmetic runs in torch on ``device`` (the card unless the caller
names another), in chunks of nonzeros: all 23.4 M × 128 products at once
would take 24 GB in f64.  On the CPU the sums are sequential in nonzero
order, the script's ``np.add.at``; on the card ``index_add_`` adds them in
no fixed order, which ``res_check``'s tolerance absorbs.  The script
pinned its JAX to the CPU and rounded with ml_dtypes; here bf16 rounding is
torch's (nearest even, as ml_dtypes rounds) and no graph is read from
``/tmp``.

    python -m flex_tpu_torch.experiments.high_precision_host
"""
from __future__ import annotations

import time

import numpy as np
import torch

from flex_tpu_torch.experiments import banner, p
from flex_tpu_torch.ops.window_spmm import _host_panel_key, window_select
from flex_tpu_torch.sparse.device import resolve_device
from flex_tpu_torch.utils.check import res_check

CHUNK = 1 << 21   # nonzeros a chunk: 2 M × 128 f64 products = 2 GB


def split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) f32: hi = bf16(x), lo = bf16(x − hi), rounded to nearest
    even and widened back."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi, lo


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scatter_rows(out: torch.Tensor, rows: torch.Tensor, product,
                 chunk: int = CHUNK) -> torch.Tensor:
    """out[rows[i]] += product(i0, i1)[i − i0] for every nonzero i, in
    chunks [i0, i1) in order."""
    for i0 in range(0, rows.shape[0], chunk):
        i1 = min(i0 + chunk, rows.shape[0])
        out.index_add_(0, rows[i0:i1], product(i0, i1))
    return out


def covered_mask(g, tm: int = 256, W: int = 128, min_count: int = 64,
                 max_dense_bytes: int = 6 << 30) -> np.ndarray:
    """bool [nnz]: the nonzeros inside the selection's kept windows."""
    sel = window_select(g, tm=tm, W=W, min_count=min_count,
                        max_dense_bytes=max_dense_bytes)
    key_h = _host_panel_key(g, tm, W, sel["P"], sel["nblk"])
    return sel["slot"][key_h] != 0


def main(device=None, graph=None, k: int = 128, seed: int = 0,
         chunk: int = CHUNK) -> dict:
    """The script's three checks on ``graph`` (the headline graph by
    default).  Returns coverage and, per variant, n_bad, err_frac, max_err
    and seconds."""
    dev = resolve_device(device)
    p(banner(dev))
    if graph is None:
        from flex_tpu_torch.bench.headline import load_graph

        graph = load_graph()
    g = graph
    m, nnz, n = g.m, g.nnz, g.n
    covered_h = covered_mask(g)
    p(f"coverage {covered_h.mean():.3f} ({covered_h.sum()/1e6:.2f}M of "
      f"{nnz/1e6:.2f}M nnz on the MXU)")
    rng = np.random.default_rng(seed)
    B = torch.from_numpy((2.0 * rng.random((n, k)) - 1.0).astype(
        np.float32)).to(dev)
    rows_all = torch.from_numpy(np.repeat(np.arange(m), np.diff(
        g.row_ptr.astype(np.int64)))).to(dev)
    col_all = torch.from_numpy(g.col.astype(np.int64)).to(dev)
    vals_all = torch.from_numpy(g.vals.astype(np.float32)).to(dev)
    covered = torch.from_numpy(covered_h).to(dev)

    t0 = time.time()
    B64, v64 = B.double(), vals_all.double()
    gold = scatter_rows(
        torch.zeros((m, k), dtype=torch.float64, device=dev), rows_all,
        lambda i0, i1: v64[i0:i1, None] * B64[col_all[i0:i1]], chunk)
    del B64, v64
    gold32 = gold.float().cpu().numpy()
    del gold
    p(f"f64 gold: {time.time()-t0:.0f}s")
    deg = np.diff(g.row_ptr)

    unc = ~covered
    rr, cr, vr = rows_all[unc], col_all[unc], vals_all[unc]
    rc, cc, vc = rows_all[covered], col_all[covered], vals_all[covered]
    del rows_all, col_all, vals_all
    res = {"device": banner(dev),
           "coverage": float(covered_h.mean()), "covered_nnz":
           int(covered_h.sum()), "nnz": nnz}

    def run_check(tag, c_dense):
        # the exact residue, added after the dense half
        c = scatter_rows(c_dense, rr,
                         lambda i0, i1: vr[i0:i1, None] * B[cr[i0:i1]], chunk)
        r = res_check(gold32, c.cpu().numpy(), deg)
        p(f"  {tag}: n_bad={r.n_bad} err_frac={r.err_frac:.2e} "
          f"max_err={r.max_err:.3g}")
        return r

    a_hi, a_lo = split_hi_lo(vc)
    b_hi, b_lo = split_hi_lo(B)
    variants = (
        ("f32 dense (HIGHEST analog)", "highest",
         lambda i0, i1: vc[i0:i1, None] * B[cc[i0:i1]]),
        ("HIGH 3-pass dense", "high",
         lambda i0, i1: (a_hi[i0:i1, None] * b_hi[cc[i0:i1]]
                         + a_hi[i0:i1, None] * b_lo[cc[i0:i1]]
                         + a_lo[i0:i1, None] * b_hi[cc[i0:i1]])),
        ("DEFAULT 1-pass dense (control)", "default",
         lambda i0, i1: a_hi[i0:i1, None] * b_hi[cc[i0:i1]]),
    )
    for tag, key, product in variants:
        t0 = time.time()
        c = scatter_rows(torch.zeros((m, k), dtype=torch.float32,
                                     device=dev), rc, product, chunk)
        r = run_check(tag, c)
        _sync(dev)
        secs = time.time() - t0
        p(f"  ({secs:.0f}s)")
        res[key] = {"n_bad": r.n_bad, "err_frac": r.err_frac,
                    "max_err": r.max_err, "seconds": secs}
        del c
    return res


if __name__ == "__main__":
    main()
