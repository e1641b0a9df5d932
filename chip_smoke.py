#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only
    python3 chip_smoke.py --profile  # also trace two train steps

Phases:
  1. environment: card name and power limit, torch/CUDA versions; TF32 off.
  2. build every CUDA kernel of the package from ``flex_tpu_torch/csrc``.
  3. each kernel (forward, g_A, g_B; transposed forward, band v2 and v1,
     GE-SpMM partials) against its plain PyTorch version on random tables
     at its path's shapes (k = 128 and k = 41), with the tolerance stated
     there.
  4. the forward path at full size: reddit_posts(seed=0) -> rbdeg ->
     window_select(tm=256, W=128, min_count=64, max_dense_bytes=6 GiB) ->
     prepare_windowed on cuda -> plan(B), B = make_features(g, 128),
     checked with res_check against SciPy (err_frac <= 1e-4).
  5. the forward kernel on that path's own tensors, at k = 128 and at the
     train step's k = 41: max error against the plain version, kernel /
     plain / bound / library times.
  6. the gradient path at full size: loss = (plan(B) * co).sum() with B and
     plan.A requiring grad; the backward launches the g_A and g_B kernels;
     g_B against SciPy's A^T.co (res_check err_frac <= 1e-4), g_A against
     its plain version; once more with ``with_training_bwd``.
  7. the training path at full size: GCN(128 -> 128 -> 41) through
     ``make_train_step`` with Adam(1e-2), 2 warm-up and 5 timed steps; the
     parameter gradients of the first step against the same loss taken
     through the plain versions on the card; the launch counts per step, a
     finite and falling loss, ms/step, peak memory and the step's split.
  8. the two backward kernels on the main path's own tensors, as in 5
     (g_B at k = 128 and k = 41).
  9. the transposed windowed plan at full size: the same graph, ordering
     and selection, ``prepare_windowed(transposed=True)`` through
     ``bench_spmm`` at k = 41 and k = 32 (err_frac <= 1e-4), the
     transposed kernel against plain on its tensors, its time beside the
     row-major kernel's at the same k.
 10. GE-SpMM at full size on that graph (w = 32, k = 128 and 41).
 11. the baselines ``"xla"`` and ``"bcoo"`` at full size (k = 128).
 12. band at full size: banded_graph(262144, 256, 64.0, seed=2), tm = 256,
     k = 128, the three impls through ``bench_spmm``, both band kernels
     against plain on the plans' tensors.
Phase 3 also holds the transposed, band and GE-SpMM kernels to their plain
versions on random tables.  Each path is driven with the launch counts
set to 0 just before it and read just after.
Then one JSON line {"kernels": [...]}, the card's name and power limit, and
last {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without a CUDA card the script exits 2 and prints no
result.  The ordered graph is cached under flex_tpu_torch/_build/.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

CACHE_VERSION = 1
EXPECT_M, EXPECT_NNZ = 232_965, 23_446_803
K = 128
EPS32 = float(np.finfo(np.float32).eps)

# Published dense peaks (NVIDIA data sheets): FP32 outside the tensor
# cores, and device-memory rate.  Keyed by a substring of the card name.
PEAKS = {
    "H100 PCIe": {"fp32": 51e12, "bytes": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "bytes": 3.9e12},
    "H100": {"fp32": 67e12, "bytes": 3.35e12},  # SXM5 80GB HBM3
}


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> dict:
    for key, p in PEAKS.items():
        if key in name:
            return p
    raise RuntimeError(f"no published peak rates for card {name!r}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_flops: float, peaks: dict) -> tuple[float, str]:
    t_b = n_bytes / peaks["bytes"] * 1e3
    t_f = n_flops / peaks["fp32"] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: window kernel vs plain on random tables
# ---------------------------------------------------------------------------

def random_window_case(torch, rng, steps_per_panel, n, dev, TM=256, G=4,
                       W=128, k=K, sentinel_frac=0.2, trailing_empty=2):
    """Random step tables: panels with the given step counts (then
    ``trailing_empty`` panels with none), block ids sorted within a panel
    and including the last, partial block; a fraction of sentinels."""
    nblk = -(-n // W)
    S = int(sum(steps_per_panel))
    out_panel = np.repeat(np.arange(len(steps_per_panel)), steps_per_panel)
    first = np.zeros(S, np.int32)
    starts = np.concatenate([[0], np.cumsum(steps_per_panel)[:-1]])
    first[starts] = 1
    win = np.sort(rng.integers(0, nblk, (S, G)), axis=1)
    win[::7, -1] = nblk - 1                       # rows >= n read as zero
    win[rng.random((S, G)) < sentinel_frac] = nblk
    n_panels = len(steps_per_panel) + trailing_empty
    ptr = np.concatenate([[0], np.cumsum(steps_per_panel),
                          np.full(trailing_empty, S)]).astype(np.int32)
    t = {
        "first": torch.from_numpy(first).to(dev),
        "out_panel": torch.from_numpy(out_panel.astype(np.int32)).to(dev),
        "win_step": torch.from_numpy(win.reshape(-1).astype(np.int32)).to(dev),
        "A": (torch.rand((S, TM, G * W), device=dev) * 2 - 1),
        "B": (torch.rand((n, k), device=dev) * 2 - 1),
    }
    return t, n_panels, W, torch.from_numpy(ptr).to(dev)


def _worst(torch, err, tol):
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max()), \
        bool((err > tol).any())


def hold_to_plain(torch, name, label, out, ref, absprod, L):
    """|kernel - plain| <= 2·L·eps32·(|a|·|b|) elementwise, L the
    contraction length (a tensor that broadcasts, or a number): the
    worst-case f32 rounding of two length-L sums taken in different
    orders.  Returns max_abs_err."""
    tol = 2 * L * EPS32 * absprod.double()
    max_err, ratio, bad = _worst(torch, (out.double() - ref.double()).abs(),
                                 tol)
    if bad or not bool(torch.isfinite(out).all()) or out.shape != ref.shape:
        raise AssertionError(f"{name} kernel disagrees with plain on {label}:"
                             f" max_abs_err={max_err:.3e} ratio={ratio:.3f}")
    log(f"[kernel-vs-plain] {name} {label}: max_abs_err={max_err:.3e} "
        f"worst err/bound={ratio:.4f} ok")
    return max_err


def check_window_kernel(torch, t, n_panels, W, ptr, label):
    """Kernel 1 against its plain version; L = the panel's contraction
    length (steps·G·W)."""
    from flex_tpu_torch.ops.window_spmm import (
        window_spmm_fwd, window_spmm_fwd_plain,
    )

    args = (t["first"], t["out_panel"], t["win_step"])
    C_k = window_spmm_fwd(*args, t["A"], t["B"], n_panels=n_panels, W=W,
                          panel_step_ptr=ptr)
    C_p = window_spmm_fwd_plain(*args, t["A"], t["B"], n_panels=n_panels,
                                W=W)
    absprod = window_spmm_fwd_plain(*args, t["A"].abs(), t["B"].abs(),
                                    n_panels=n_panels, W=W)
    TM, GW = t["A"].shape[1], t["A"].shape[2]
    L = ((ptr[1:] - ptr[:-1]).double() * GW).repeat_interleave(TM)[:, None]
    return hold_to_plain(torch, "window_spmm", label, C_k, C_p, absprod, L)


def check_window_kernel_ks(torch, t, n_panels, W, ptr, label, ks=(K, 41)):
    """The forward kernel on one random-table case at each k: k = 41 masks
    columns of the kernel's 128-wide tile."""
    n = t["B"].shape[0]
    for k in ks:
        B = t["B"] if k == t["B"].shape[1] else \
            torch.rand((n, k), device=t["A"].device) * 2 - 1
        check_window_kernel(torch, dict(t, B=B), n_panels, W, ptr,
                            f"{label} k={k}")


def bwd_slot_tables(win_step, out_panel, n, W, G):
    """The block-sorted slot tables of the backward for given step tables,
    as tensors beside ``win_step``; None when no window is real."""
    from flex_tpu_torch.ops.window_spmm import bwd_device_tables

    d = bwd_device_tables(win_step.cpu().numpy(), out_panel.cpu().numpy(),
                          max(-(-n // W), 1), G, W, win_step.device)
    if d["bwd_tabs"] is None:
        return None
    return {"slot_s": d["bwd_tabs"][0], "slot_g": d["bwd_tabs"][1],
            "slot_ptr": d["slot_ptr"], "n_blk_used": d["n_blk_used"]}


def check_gA_kernel(torch, out_panel, win_step, g, B, TM, W, label,
                    chunk=1024):
    """|gA_kernel - gA_plain| <= 2·k·eps32·(|g|·|B|ᵀ) elementwise (k is the
    contraction length; sentinel tiles must be exactly zero).  The plain
    version runs ``chunk`` steps at a time to bound its temporaries.
    Returns (g_A, max_abs_err)."""
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gA_plain,
    )

    S, k = out_panel.shape[0], B.shape[1]
    G = win_step.shape[0] // S
    gA = window_bwd_gA(out_panel, win_step, g, B, TM=TM, W=W)
    torch.cuda.synchronize()
    g_abs, B_abs = g.abs(), B.abs()
    max_err = ratio = 0.0
    bad = not bool(torch.isfinite(gA).all())
    for lo in range(0, S, chunk):
        sl = (out_panel[lo:lo + chunk], win_step[lo * G:(lo + chunk) * G])
        ref = window_bwd_gA_plain(*sl, g, B, TM=TM, W=W)
        tol = 2 * k * EPS32 * window_bwd_gA_plain(*sl, g_abs, B_abs, TM=TM,
                                                  W=W).double()
        e, r, b = _worst(torch, (gA[lo:lo + chunk].double() - ref.double()
                                 ).abs(), tol)
        max_err, ratio, bad = max(max_err, e), max(ratio, r), bad or b
    if bad:
        raise AssertionError(f"g_A kernel disagrees with plain on {label}: "
                             f"max_abs_err={max_err:.3e} ratio={ratio:.3f}")
    log(f"[kernel-vs-plain] window_bwd_gA {label}: max_abs_err={max_err:.3e} "
        f"worst err/bound={ratio:.4f} ok")
    return gA, max_err


def check_gB_kernel(torch, tabs, out_panel, A, g, W, label):
    """|gB_kernel - gB_plain| <= 2·L·eps32·(|A|ᵀ·|g|) elementwise, L = the
    block's contraction length (its slots · TM).  Returns max_abs_err."""
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gB, window_bwd_gB_plain,
    )

    kw = dict(W=W, n_blk_used=tabs["n_blk_used"])
    args = (tabs["slot_s"], tabs["slot_g"], tabs["slot_ptr"], out_panel)
    out = window_bwd_gB(*args, A, g, **kw)
    torch.cuda.synchronize()
    ref = window_bwd_gB_plain(*args, A, g, **kw)
    absprod = window_bwd_gB_plain(*args, A.abs(), g.abs(), **kw)
    ptr = tabs["slot_ptr"]
    L = ((ptr[1:] - ptr[:-1]).double() * A.shape[1]).repeat_interleave(W)
    return hold_to_plain(torch, "window_bwd_gB", label, out, ref, absprod,
                         L[:, None])


def check_bwd_kernels(torch, t, n_panels, W, label, ks=(K, 41)):
    """Both backward kernels on one random-table case, at each k."""
    TM, GW = t["A"].shape[1], t["A"].shape[2]
    n = t["B"].shape[0]
    tabs = bwd_slot_tables(t["win_step"], t["out_panel"], n, W, GW // W)
    for k in ks:
        g = torch.rand((n_panels * TM, k), device=t["A"].device) * 2 - 1
        B = t["B"] if k == t["B"].shape[1] else \
            torch.rand((n, k), device=g.device) * 2 - 1
        check_gA_kernel(torch, t["out_panel"], t["win_step"], g, B, TM, W,
                        f"{label} k={k}")
        if tabs is not None:
            check_gB_kernel(torch, tabs, t["out_panel"], t["A"], g, W,
                            f"{label} k={k}")


def check_window_t_kernel(torch, first, out_panel, win_step, A_T, B_T,
                          n_panels, W, ptr, label):
    """Kernel 4 against its plain version; L = the panel's steps·G·W."""
    from flex_tpu_torch.ops.window_spmm import (
        window_spmm_t_fwd, window_spmm_t_fwd_plain,
    )

    args = (first, out_panel, win_step)
    kw = dict(n_panels=n_panels, W=W)
    out = window_spmm_t_fwd(*args, A_T, B_T, panel_step_ptr=ptr, **kw)
    torch.cuda.synchronize()
    ref = window_spmm_t_fwd_plain(*args, A_T, B_T, **kw)
    absprod = window_spmm_t_fwd_plain(*args, A_T.abs(), B_T.abs(), **kw)
    S, GW, TM = A_T.shape
    L = ((ptr[1:] - ptr[:-1]).double() * GW).repeat_interleave(TM)[None, :]
    return hold_to_plain(torch, "window_spmm_t_fwd", label, out, ref,
                         absprod, L)


def check_band_kernels(torch, rng, P, TM, W, n, k, label, dev="cuda"):
    """Kernels 5 and 6 on random band tables: windows anywhere in B,
    including ones that run past n (B rows >= n read as zero)."""
    from flex_tpu_torch.ops.pallas_band import (
        band_spmm_v1, band_spmm_v1_plain, band_spmm_v2, band_spmm_v2_plain,
    )

    B = torch.rand((n, k), device=dev) * 2 - 1
    a = [torch.rand((P, TM, W), device=dev) * 2 - 1 for _ in range(2)]
    iW = rng.integers(0, -(-n // W), P)
    iW[::3] = -(-n // W) - 1            # the right half lies beyond n
    iW = torch.from_numpy(iW.astype(np.int32)).to(dev)
    out = band_spmm_v2(a[0], a[1], iW, B)
    torch.cuda.synchronize()
    e2 = hold_to_plain(
        torch, "band_spmm_v2", label, out, band_spmm_v2_plain(*a, iW, B),
        band_spmm_v2_plain(a[0].abs(), a[1].abs(), iW, B.abs()), 2 * W)
    ws = rng.integers(0, -(-n // 128), P)
    ws[::3] = -(-n // 128) - 1          # the window runs past n
    ws = torch.from_numpy(ws.astype(np.int32)).to(dev)
    out = band_spmm_v1(a[0], ws, B)
    torch.cuda.synchronize()
    e1 = hold_to_plain(
        torch, "band_spmm_v1", label, out, band_spmm_v1_plain(a[0], ws, B),
        band_spmm_v1_plain(a[0].abs(), ws, B.abs()), W)
    return e2, e1


def hub_and_empty_graph(rng, m=5000, w=32):
    """A zero-degree row, rows shorter than, equal to and longer than the
    chunk width, one hub row of 40 chunks; the chunk count is not a
    multiple of 8, so the plan has pad chunks."""
    from flex_tpu_torch.sparse.csr import CSRGraph

    deg = rng.integers(0, 3 * w, m)
    deg[:4] = (0, w, w + 1, 40 * w - 5)
    deg[-1] = 0
    if int((-(-deg // w)).sum()) % 8 == 0:
        deg[5] += w
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, len(rows))
    vals = (2 * rng.random(len(rows)) - 1).astype(np.float32)
    return CSRGraph.from_coo(rows, cols, vals, m, name="hub_and_empty")


def check_gespmm_kernel(torch, cols, vals, B, label):
    """Kernel 7 against its plain version; L = the chunk width."""
    from flex_tpu_torch.ops.gespmm import (
        gespmm_partials, gespmm_partials_plain,
    )

    out = gespmm_partials(cols, vals, B)
    torch.cuda.synchronize()
    return hold_to_plain(
        torch, "gespmm_partials", label, out,
        gespmm_partials_plain(cols, vals, B),
        gespmm_partials_plain(cols, vals.abs(), B.abs()), cols.shape[1])


def check_plan_against_scipy(g, plan, B, gold, label, limit=1e-4):
    """plan(B) on the card against SciPy under res_check."""
    from flex_tpu_torch.utils.check import res_check

    import torch

    C = plan(torch.from_numpy(B).cuda())
    if tuple(C.shape) != gold.shape or not bool(C.isfinite().all()):
        raise AssertionError(f"{label}: output {tuple(C.shape)} is not a "
                             f"finite {gold.shape} tensor")
    chk = res_check(gold, C.cpu().numpy(), g.degrees)
    if chk.err_frac > limit:
        raise AssertionError(f"{label}: err_frac={chk.err_frac} > {limit}")
    log(f"[plan-vs-scipy] {label}: err_frac={chk.err_frac} "
        f"max_err={chk.max_err:.3e} ok")
    return chk.err_frac


def phase_new_kernels_vs_plain(torch, dev="cuda"):
    """Kernels 4-7 against their plain versions on random tables, at
    k = 128 and k = 41 (and the transposed kernel's own k = 32)."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.io.synth import banded_graph
    from flex_tpu_torch.ops.gespmm import prepare_gespmm
    from flex_tpu_torch.ops.pallas_band import prepare_band
    from flex_tpu_torch.ops.ref import spmm_scipy

    rng = np.random.default_rng(2)
    # kernel 4: sentinels, a 48-step panel, trailing empty panels, n % W != 0
    steps = np.concatenate([[1, 48], rng.integers(1, 16, 30)])
    for TM in (256, 128):
        t, n_panels, W, ptr = random_window_case(
            torch, rng, steps, 30_000 + 37, dev, TM=TM)
        A_T = t["A"].transpose(1, 2).contiguous()
        for k in (K, 41, 32):
            B_T = torch.rand((k, t["B"].shape[0]), device=dev) * 2 - 1
            check_window_t_kernel(
                torch, t["first"], t["out_panel"], t["win_step"], A_T, B_T,
                n_panels, W, ptr,
                f"S={int(steps.sum())} panels={n_panels} TM={TM} k={k}")
        del t, A_T
    # kernels 5 and 6: TM a multiple of the 128-row tile or not, W = 768
    # (the full-size band's) and 128, n % W != 0
    for P, TM, W in ((40, 256, 768), (9, 200, 128), (5, 8, 256)):
        for k in (K, 41):
            check_band_kernels(torch, rng, P, TM, W, 20_000 + 77, k,
                               f"P={P} TM={TM} W={W} k={k}", dev=dev)
    # m % tm != 0 through the plans, against SciPy
    gb = banded_graph(5000, 300, 40.0, seed=3)
    for k in (K, 41):
        Bb = make_features(gb, k)
        gold = spmm_scipy(gb, Bb)
        for impl in ("pallas2", "pallas"):
            check_plan_against_scipy(
                gb, prepare_band(gb, device=dev, tm=256, impl=impl), Bb, gold,
                f"band impl={impl} m=5000 tm=256 k={k}")
    # kernel 7: pad chunks, a zero-degree row, rows longer than w
    gh = hub_and_empty_graph(rng)
    for w in (32, 7):
        plan = prepare_gespmm(gh, w=w, device=dev)
        if int((plan.chunk_row == gh.m).sum()) == 0:
            raise AssertionError("the gespmm case has no pad chunk")
        for k in (K, 41):
            Bh = make_features(gh, k)
            check_gespmm_kernel(torch, plan.cols, plan.vals,
                                torch.from_numpy(Bh).to(dev),
                                f"hub+empty N={plan.cols.shape[0]} w={w} k={k}")
            check_plan_against_scipy(gh, plan, Bh, spmm_scipy(gh, Bh),
                                     f"gespmm w={w} k={k}")


def phase_kernels_vs_plain(torch, dev="cuda"):
    rng = np.random.default_rng(0)
    # a 1-step panel, a 64-step panel, a spread of others, trailing empties;
    # n % W != 0
    steps = np.concatenate([[1, 64], rng.integers(1, 24, 60), [1]])
    t, n_panels, W, ptr = random_window_case(torch, rng, steps, 50_000 + 37, dev)
    label = f"S={int(steps.sum())} panels={n_panels} n=50037"
    check_window_kernel_ks(torch, t, n_panels, W, ptr, label)
    check_bwd_kernels(torch, t, n_panels, W, label)
    # all-sentinel panel and a tiny graph with a single partial block
    steps = np.array([3, 2])
    t, n_panels, W, ptr = random_window_case(torch, rng, steps, 200, dev,
                                             sentinel_frac=0.5)
    t["win_step"][:3 * 4] = -(-200 // W)  # panel 0: every window a sentinel
    check_window_kernel_ks(torch, t, n_panels, W, ptr,
                           "sentinel panel, n=200")
    check_bwd_kernels(torch, t, n_panels, W, "sentinel panel, n=200")


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------

def load_graph():
    from flex_tpu_torch.kernels import BUILD_DIR
    from flex_tpu_torch.sparse.csr import CSRGraph

    path = os.path.join(BUILD_DIR, f"reddit_posts_rbdeg_v{CACHE_VERSION}.npz")
    if os.path.exists(path):
        d = np.load(path)
        g = CSRGraph.from_arrays(d["row_ptr"], d["col"], d["vals"],
                                 name="reddit_posts", order="RBD")
        log(f"[graph] loaded {path}")
    else:
        from flex_tpu_torch.io.synth import reddit_posts
        from flex_tpu_torch.reorder import reorder

        t0 = time.perf_counter()
        g = reddit_posts(seed=0)
        t1 = time.perf_counter()
        g = reorder(g, "rbdeg", check=False)
        t2 = time.perf_counter()
        log(f"[graph] host: reddit_posts {t1 - t0:.1f}s, rbdeg {t2 - t1:.1f}s")
        os.makedirs(BUILD_DIR, exist_ok=True)
        np.savez(path, row_ptr=g.row_ptr, col=g.col, vals=g.vals)
    if (g.m, g.nnz) != (EXPECT_M, EXPECT_NNZ):
        raise AssertionError(f"graph is {g.m} x {g.nnz} nnz, expected "
                             f"{EXPECT_M} x {EXPECT_NNZ}")
    return g


def window_bytes_flops(plan, k):
    """Bytes the dense half must move (real windows of A, B, tables, the
    output) and its multiply-adds, for this selection."""
    TM = plan.tm
    n_win = int((plan.win_step != max(-(-plan.n // plan.W), 1)).sum())
    n_bytes = (n_win * TM * plan.W * 4 + plan.n * k * 4
               + plan.win_step.numel() * 4 + plan.panel_step_ptr.numel() * 4
               + plan.n_used_panels * TM * k * 4)
    return n_win, n_bytes, 2.0 * n_win * TM * plan.W * k


def window_as_bsr(torch, plan):
    """The dense half's tiles as one BSR matrix of (W, W) blocks, the
    yardstick for ``torch.sparse.mm`` (block rows ordered panel by panel,
    so its product has the kernel's [n_used·TM, k] row order; the columns
    span whole blocks, so B must be padded to nblk·W rows)."""
    S, TM, GW = plan.A.shape
    W = plan.W
    G, h = GW // W, TM // W
    if TM % W:
        raise ValueError("the BSR yardstick needs TM % W == 0")
    nblk = max(-(-plan.n // W), 1)
    win = plan.win_step.long()
    real = torch.nonzero(win != nblk).squeeze(1)   # panel-major order
    panel = plan.out_panel.long()[real // G]
    counts = torch.bincount(panel, minlength=plan.n_used_panels)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(len(real), device=win.device) - start[panel]
    Av = plan.A.view(S, h, W, G, W).permute(0, 3, 1, 2, 4)  # (S, G, h, W, W)
    values = plan.A.new_empty((len(real) * h, W, W))
    cols = win.new_empty(len(real) * h)
    for hh in range(h):
        dst = start[panel] * h + hh * counts[panel] + pos
        values[dst] = Av[real // G, real % G, hh]
        cols[dst] = win[real]
    crow = torch.zeros(plan.n_used_panels * h + 1, dtype=torch.int64,
                       device=win.device)
    crow[1:] = torch.cumsum(counts.repeat_interleave(h), 0)
    return torch.sparse_bsr_tensor(crow, cols, values,
                                   size=(plan.n_used_panels * TM, nblk * W))


def steps_percentiles(plan) -> list[int]:
    steps = (plan.panel_step_ptr[1:] - plan.panel_step_ptr[:-1]).cpu().numpy()
    return [int(np.percentile(steps, q)) for q in (50, 99, 100)]


def longest_panel_ms(torch, plan, B, time_cuda_ms) -> float:
    """The window kernel on the longest panel's steps alone: a lower bound
    on the whole launch's time, since that panel's blocks run its steps in
    sequence."""
    from flex_tpu_torch.ops.window_spmm import window_spmm_fwd

    ptr = plan.panel_step_ptr.long()
    p = int(torch.argmax(ptr[1:] - ptr[:-1]))
    lo, hi = int(ptr[p]), int(ptr[p + 1])
    G = plan.A.shape[2] // plan.W
    one = dict(first=plan.first[lo:hi], out_panel=plan.out_panel[lo:hi] - p,
               win_step=plan.win_step[lo * G:hi * G], A=plan.A[lo:hi], B=B)
    ptr1 = torch.tensor([0, hi - lo], dtype=torch.int32, device=B.device)
    return time_cuda_ms(lambda: window_spmm_fwd(
        *one.values(), n_panels=1, W=plan.W, panel_step_ptr=ptr1), iters=10)

def window_T_as_bsr(torch, plan):
    """The dense half's tiles, transposed, as one BSR matrix of (W, W)
    blocks: block row = block of B, block columns = the (panel, W-row
    slice) pairs that meet it.  ``torch.sparse.mm`` of it with the dense
    half's cotangent is the library yardstick of the g_B kernel (its
    product has nblk·W rows, B's rows block by block)."""
    S, TM, GW = plan.A.shape
    W = plan.W
    G, h = GW // W, TM // W
    if TM % W:
        raise ValueError("the BSR yardstick needs TM % W == 0")
    nblk = max(-(-plan.n // W), 1)
    slot_s, slot_g, rows = plan.bwd_tabs
    ss, sg = slot_s.long(), slot_g.long()
    # slots are sorted by block id, then by step: panels ascend in a row
    tiles = plan.A.view(S, h, W, G, W)[ss, :, :, sg, :]    # (n_win, h, W, W)
    values = tiles.transpose(2, 3).reshape(-1, W, W)
    del tiles
    cols = (plan.out_panel.long()[ss][:, None] * h
            + torch.arange(h, device=ss.device)).reshape(-1)
    blk_of_rank = rows.view(-1, W)[:, 0].long() // W
    ptr = plan.slot_ptr.long()
    counts = torch.zeros(nblk, dtype=torch.int64, device=ss.device)
    counts[blk_of_rank] = (ptr[1:] - ptr[:-1]) * h
    crow = torch.zeros(nblk + 1, dtype=torch.int64, device=ss.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_bsr_tensor(
        crow, cols, values, size=(nblk * W, plan.n_used_panels * TM))


def dense_cotangent(torch, plan, co):
    """The cotangent that reaches the dense half when ``co`` is the
    cotangent of plan(B): the transpose of the output-assembly gather."""
    k = co.shape[1]
    g = co.new_zeros((plan.n_used_panels * plan.tm + 1, k))
    g.index_add_(0, plan.row_gather[:plan.m], co)
    return g[:-1].contiguous()


def check_gB_against_scipy(g, gB, gold, col_deg, label):
    from flex_tpu_torch.utils.check import res_check

    if tuple(gB.shape) != gold.shape or not bool(gB.isfinite().all()):
        raise AssertionError(f"{label}: g_B {tuple(gB.shape)} is not a "
                             f"finite {gold.shape} tensor")
    chk = res_check(gold, gB.cpu().numpy(), col_deg)
    if chk.err_frac > 1e-4:
        raise AssertionError(f"{label}: g_B err_frac={chk.err_frac} > 1e-4")
    log(f"[grad] {label}: g_B vs SciPy A^T.co err_frac={chk.err_frac} "
        f"max_err={chk.max_err:.3e} ok")
    return chk.err_frac


def kernel_wrappers() -> list:
    """The seven kernel wrappers, in the order of the kernels line."""
    from flex_tpu_torch.ops.gespmm import gespmm_partials
    from flex_tpu_torch.ops.pallas_band import band_spmm_v1, band_spmm_v2
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gB, window_spmm_fwd, window_spmm_t_fwd,
    )

    return [window_spmm_fwd, window_bwd_gA, window_bwd_gB, window_spmm_t_fwd,
            band_spmm_v2, band_spmm_v1, gespmm_partials]


def reset_launches():
    for fn in kernel_wrappers():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def expect_launches(launches: dict, what: str, **counts):
    """The named wrappers launched exactly ``counts``; every other, none."""
    want = {name: counts.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want}")


def phase_gradient(torch, g, plan, B_dev):
    """Phase 6.  Returns (launch counts, g_A's max error against plain, the
    cotangent co, the dense half's share of it, the plan with the training
    backward)."""
    import dataclasses

    from flex_tpu_torch.ops.window_spmm import with_training_bwd

    rng = np.random.default_rng(1)
    co_h = rng.random((g.m, K), dtype=np.float32)
    t0 = time.perf_counter()
    gold = np.asarray(g.to_scipy().T @ co_h, dtype=np.float32)
    col_deg = np.bincount(g.col, minlength=g.n)
    log(f"[grad] scipy A^T.co {time.perf_counter() - t0:.1f}s")
    co = torch.from_numpy(co_h).cuda()

    A = plan.A.detach().requires_grad_()   # shares plan.A's storage
    Bg = B_dev.clone().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss = (dataclasses.replace(plan, A=A)(Bg) * co).sum()
    loss.backward()
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[grad] loss={float(loss.detach()):.6e} launches={launches} peak_mem="
        f"{torch.cuda.max_memory_allocated()}")
    expect_launches(launches, "the gradient path", window_spmm_fwd=1,
                    window_bwd_gA=1, window_bwd_gB=1)
    check_gB_against_scipy(g, Bg.grad, gold, col_deg, "plan")
    # g_A of the backward against the plain version, on the same cotangent
    g_dense = dense_cotangent(torch, plan, co)
    gA_again, gA_err = check_gA_kernel(
        torch, plan.out_panel, plan.win_step, g_dense, B_dev, plan.tm, plan.W,
        "main path")
    diff = float((A.grad - gA_again).abs().max())
    if tuple(A.grad.shape) != tuple(plan.A.shape) or not diff <= 1e-5:
        raise AssertionError(f"A.grad differs from the g_A kernel on the "
                             f"backward's own cotangent: max |diff| {diff}")
    del A, gA_again, loss

    t0 = time.perf_counter()
    tplan = with_training_bwd(plan)
    torch.cuda.synchronize()
    log(f"[grad] with_training_bwd (transposed residue) "
        f"{time.perf_counter() - t0:.2f}s")
    Bg2 = B_dev.clone().requires_grad_()
    reset_launches()
    (tplan(Bg2) * co).sum().backward()
    torch.cuda.synchronize()
    l2 = read_launches()
    # A is a constant there, so no g_A
    expect_launches(l2, "the training-backward path", window_spmm_fwd=1,
                    window_bwd_gB=1)
    check_gB_against_scipy(g, Bg2.grad, gold, col_deg, "with_training_bwd")
    diff = float((Bg2.grad - Bg.grad).abs().max())
    log(f"[grad] g_B with vs without the transposed residue backward: "
        f"max |diff| {diff:.3e}")
    return launches, gA_err, co, g_dense, tplan


def profile_steps(torch, step, args, n=2):
    """``n`` train steps under torch.profiler: the device's busy share of
    the wall time and the kernels by their summed device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # kernel rows only: an operator's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in rows)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    log(f"[profile] {n} train steps: wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_us / wall_us):.4f}")
    for e in rows[:12]:
        log(f"[profile]   {dev_us(e) / 1e3 / n:9.3f} ms/step  x{e.count / n:g}"
            f"  {e.key[:90]}")


def plain_plan(torch, plan):
    """B -> A·B as the plan computes it, with the dense half by the forward
    kernel's plain version and the residue without its transposed backward:
    all tensor ops, so autograd differentiates it with no kernel of the
    package."""
    from flex_tpu_torch.ops.window_spmm import window_spmm_fwd_plain

    def call(B):
        out = window_spmm_fwd_plain(
            plan.first, plan.out_panel, plan.win_step, plan.A, B,
            n_panels=plan.n_used_panels, W=plan.W)
        cat = torch.cat([out, out.new_zeros((1, B.shape[1]))])
        dense = cat.index_select(0, plan.row_gather[:plan.m])
        return plan.ell(B, into=dense)

    if plan.ell.bwd_plan is not None or plan.ell.nnz == 0:
        raise AssertionError("plain_plan wants a residue without bwd_plan")
    return call


def check_first_step_gradients(torch, model, plan, tplan, X, y, mask,
                               rel=1e-3):
    """The parameter gradients of the first train step, through the kernels
    (forward, g_B and the transposed residue), against the same loss through
    :func:`plain_plan`: |diff| <= rel · max|plain gradient| elementwise, for
    each parameter.  The two differ by f32 sums in another order, through
    two layers, a relu and a softmax."""
    from flex_tpu_torch.models import gcn_loss

    grads = []
    for p in (tplan, plain_plan(torch, plan)):
        model.zero_grad(set_to_none=True)
        loss = gcn_loss(model, p, X, y, mask)
        loss.backward()
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()})
        del loss
    model.zero_grad(set_to_none=True)
    worst = {}
    for n, ref in grads[1].items():
        scale = float(ref.abs().max())
        diff = float((grads[0][n] - ref).abs().max())
        worst[n] = diff / scale if scale else float("inf")
        if not bool(grads[0][n].isfinite().all()) or not worst[n] <= rel:
            raise AssertionError(f"first step's {n}.grad differs from the "
                                 f"plain versions': max |diff| {diff:.3e} "
                                 f"over max |ref| {scale:.3e}")
    log(f"[train] first step's gradients vs plain versions, max |diff| / "
        f"max |ref|: {worst} (limit {rel}) ok")


def phase_training(torch, g, plan, tplan, X, time_cuda_ms, smi,
                   profile=False):
    """Phase 7.  Returns the launch counts of the 7 steps."""
    from flex_tpu_torch.models import GCN, gcn_loss, make_train_step
    from flex_tpu_torch.ops.gcn import pick_association
    from flex_tpu_torch.ops.window_spmm import window_bwd_gB

    d_in, d_hid, n_cls = 128, 128, 41
    assoc = [pick_association(g.m, g.nnz, d, c)
             for d, c in ((d_in, d_hid), (d_hid, n_cls))]
    if assoc != ["axw", "axw"]:
        raise AssertionError(f"association {assoc}, expected axw twice")
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, n_cls, g.m)).cuda()
    mask = torch.ones(g.m, device="cuda")
    model = GCN(d_in, d_hid, n_cls, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0)).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, plan, opt)  # attaches the training bwd
    check_first_step_gradients(torch, model, plan, tplan, X, y, mask)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [step(X, y, mask) for _ in range(2)]            # warm-up
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t0 = time.perf_counter()
    for i in range(5):
        ev[i].record()
        losses.append(step(X, y, mask))
    ev[5].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
    losses = [float(x) for x in losses]
    with torch.no_grad():
        after = float(gcn_loss(model, plan, X, y, mask))
    log(f"[train] losses {[round(x, 6) for x in losses]} then {after:.6f}")
    # 2 forward and 2 g_B per step, and no g_A
    expect_launches(launches, "7 train steps", window_spmm_fwd=14,
                    window_bwd_gB=14)
    if not np.isfinite(losses + [after]).all() or not after < losses[0]:
        raise AssertionError(f"loss {losses[0]} -> {after}: not finite and "
                             f"falling")
    if profile:
        profile_steps(torch, step, (X, y, mask))

    # the step's split: each part timed alone on the step's own shapes
    split = {}
    ts, tg, _ = plan.bwd_tabs
    bwd = tplan.ell.bwd_plan
    with torch.no_grad():
        H = {k: torch.rand((g.n, k), device="cuda") for k in (d_hid, n_cls)}
        for k, h in H.items():
            gd = torch.rand((plan.n_used_panels * plan.tm, k), device="cuda")
            split[f"fwd_dense_k{k}"] = time_cuda_ms(plan.dense_half, h, iters=5)
            split[f"fwd_residue_k{k}"] = time_cuda_ms(plan.ell, h, iters=5)
            split[f"kernel3_gB_k{k}"] = time_cuda_ms(
                lambda: window_bwd_gB(ts, tg, plan.slot_ptr, plan.out_panel,
                                      plan.A, gd, W=plan.W,
                                      n_blk_used=plan.n_blk_used), iters=5)
            split[f"residue_bwd_k{k}"] = time_cuda_ms(bwd, h, iters=5)
            del gd
        split["fwd_dense_matmul"] = time_cuda_ms(
            torch.matmul, X, model.W1, iters=5) + time_cuda_ms(
            torch.matmul, H[d_hid], model.W2, iters=5)
    parts = sum(split.values())
    ms = float(np.median(step_ms))
    log("[train] " + json.dumps({
        "ms_per_step": ms, "ms_per_step_host": host_ms,
        "step_ms": step_ms, "peak_memory_allocated": peak,
        "split_ms": split, "rest_ms": ms - parts,
        "launches_7_steps": launches,
        "spmm_equiv_gflops": 4 * 2 * g.nnz * 128 / (ms * 1e-3) / 1e9,
        "card": smi}))
    return launches


def slots_percentiles(plan) -> list[int]:
    n = (plan.slot_ptr[1:] - plan.slot_ptr[:-1]).cpu().numpy()
    return [int(np.percentile(n, q)) for q in (50, 99, 100)]


def phase_bwd_kernels(torch, g, plan, B_dev, co, g_dense, gA_err,
                      launches_grad, launches_train, peaks, time_cuda_ms):
    """Phase 8: the two backward kernels on the main path's tensors.
    Returns their rows of the kernels line."""
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gA_plain, window_bwd_gB,
        window_bwd_gB_plain,
    )

    n_win, _, n_flops = window_bytes_flops(plan, K)
    S, TM, GW = plan.A.shape
    W = plan.W
    ts, tg, rows = plan.bwd_tabs
    tabs = {"slot_s": ts, "slot_g": tg,
            "slot_ptr": plan.slot_ptr, "n_blk_used": plan.n_blk_used}
    tables_bytes = 4 * (plan.win_step.numel() + plan.out_panel.numel())

    # kernel 2: reads g and B once, writes every tile of g_A (sentinels too)
    gA_args = (plan.out_panel, plan.win_step, g_dense, B_dev)
    gA_ms = time_cuda_ms(lambda: window_bwd_gA(*gA_args, TM=TM, W=W), iters=5)
    gA_plain_ms = time_cuda_ms(
        lambda: window_bwd_gA_plain(*gA_args, TM=TM, W=W), iters=3, warmup=1)
    gA_bytes = (g_dense.numel() + B_dev.numel() + plan.A.numel()) * 4 \
        + tables_bytes
    gA_bound, gA_by = bound(gA_bytes, n_flops, peaks)
    log(f"[kernels] window_bwd_gA: real windows {n_win}, "
        f"{n_flops / 1e12:.4f} TFLOP, {gA_bytes / 1e9:.3f} GB, "
        f"{n_flops / (gA_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")

    # kernel 3: reads the real windows of A and g once, writes the compact out
    gB_err = check_gB_kernel(torch, tabs, plan.out_panel, plan.A, g_dense, W,
                             "main path k=128")
    # the train step's second layer calls it at k = 41
    gd41 = g_dense[:, :41].contiguous()
    gB_err_41 = check_gB_kernel(torch, tabs, plan.out_panel, plan.A, gd41, W,
                                "main path k=41")
    gB_call = lambda gd=g_dense: window_bwd_gB(  # noqa: E731
        ts, tg, plan.slot_ptr, plan.out_panel, plan.A, gd, W=W,
        n_blk_used=plan.n_blk_used)
    gB_ms = time_cuda_ms(gB_call, iters=10)
    gB_plain_ms = time_cuda_ms(
        lambda: window_bwd_gB_plain(ts, tg, plan.slot_ptr, plan.out_panel,
                                    plan.A, g_dense, W=W,
                                    n_blk_used=plan.n_blk_used),
        iters=3, warmup=1)
    gB_bytes = (n_win * TM * W + g_dense.numel()
                + plan.n_blk_used * W * K) * 4 + 4 * (
        2 * ts.numel() + plan.slot_ptr.numel() + plan.out_panel.numel())
    gB_bound, gB_by = bound(gB_bytes, n_flops, peaks)
    gB_ms_41 = time_cuda_ms(gB_call, gd41, iters=10)
    # the longest chain of slots alone: a lower bound on the whole launch
    ptr = plan.slot_ptr.long()
    r = int(torch.argmax(ptr[1:] - ptr[:-1]))
    lo, hi = int(ptr[r]), int(ptr[r + 1])
    ptr1 = torch.tensor([0, hi - lo], dtype=torch.int32, device="cuda")
    longest_ms = time_cuda_ms(lambda: window_bwd_gB(
        ts[lo:hi], tg[lo:hi], ptr1, plan.out_panel, plan.A, g_dense, W=W, n_blk_used=1), iters=10)
    log(f"[kernels] window_bwd_gB: {plan.n_blk_used} blocks, slots per "
        f"block p50/p99/max {slots_percentiles(plan)}; longest block alone "
        f"{longest_ms:.3f} ms; k=41 {gB_ms_41:.3f} ms; "
        f"{n_flops / 1e12:.4f} TFLOP, {gB_bytes / 1e9:.3f} GB, "
        f"{n_flops / (gB_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")

    # library yardsticks, timed here and used nowhere in the package
    At = g.to_scipy().T.tocsr()
    A_csr_T = torch.sparse_csr_tensor(
        torch.from_numpy(At.indptr.astype(np.int64)).cuda(),
        torch.from_numpy(At.indices.astype(np.int64)).cuda(),
        torch.from_numpy(At.data.astype(np.float32)).cuda(), size=At.shape)
    del At
    whole_gB_ms = time_cuda_ms(torch.sparse.mm, A_csr_T, co, iters=20)
    log(f"[kernels] whole g_B yardstick torch.sparse.mm(A_csr^T, co): "
        f"{whole_gB_ms:.3f} ms (dense half and residue together)")
    del A_csr_T
    A_T_bsr = window_T_as_bsr(torch, plan)
    blk = gB_call()
    full = blk.new_zeros((A_T_bsr.shape[0], K))
    full.index_copy_(0, rows.long(), blk)
    lib_err = float((torch.sparse.mm(A_T_bsr, g_dense) - full).abs().max())
    gB_library_ms = time_cuda_ms(torch.sparse.mm, A_T_bsr, g_dense, iters=5,
                                 warmup=1)
    log(f"[kernels] window_bwd_gB yardstick torch.sparse.mm(BSR^T {W}x{W}): "
        f"{gB_library_ms:.3f} ms, max |diff| vs kernel {lib_err:.3e}")
    del A_T_bsr, full, blk

    src = "flex_tpu_torch/csrc/window_spmm_bwd.cu"
    return [{
        "name": "window_bwd_gA", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/window_spmm.py:841",
        "launches": launches_grad["window_bwd_gA"], "max_abs_err": gA_err,
        "ms": gA_ms, "plain_ms": gA_plain_ms, "bound_ms": gA_bound,
        "bound_by": gA_by, "library_ms": None,
    }, {
        "name": "window_bwd_gB", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/window_spmm.py:882",
        "launches": launches_train["window_bwd_gB"], "max_abs_err": gB_err,
        "ms": gB_ms, "plain_ms": gB_plain_ms, "bound_ms": gB_bound,
        "bound_by": gB_by, "library_ms": gB_library_ms,
        "ms_k41": gB_ms_41, "max_abs_err_k41": gB_err_41,
        "longest_block_ms": longest_ms,
        "whole_gB_csr_library_ms": whole_gB_ms,
    }]


def csr_tensor(torch, g):
    """The graph as a sparse CSR tensor on the card: the operand of the
    library yardstick ``torch.sparse.mm``, used nowhere in the package's
    kernel paths."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(g.row_ptr).cuda(),
        torch.from_numpy(g.col.astype(np.int64)).cuda(),
        torch.from_numpy(g.vals).cuda(), size=g.shape)


def bench_checked(bench_spmm, g, k, method, label, **kw):
    """``bench_spmm`` with err_frac held to 1e-4.  Returns (result, plan)."""
    r, plan = bench_spmm(g, k, method, **kw)
    if r.err_frac is None or r.err_frac > 1e-4:
        raise AssertionError(f"{label}: err_frac={r.err_frac} > 1e-4")
    log(f"[{label}] " + json.dumps({
        "k": k, "t_pre_s": r.t_pre_s, "t_elap_ms": r.t_elap_ms,
        "gflops": r.gflops, "err_frac": r.err_frac}))
    return r, plan


def phase_transposed(torch, g, dev, sel, plan, B, gold, peaks, bench_spmm,
                     time_cuda_ms):
    """The transposed windowed plan at full size, on the main path's
    graph, ordering and selection, at k = 41 and k = 32 (the GCN's class
    count and the narrow width of the JAX package's sweeps); kernel 4
    beside kernel 1 at the same k.  Returns kernel 4's row."""
    from flex_tpu_torch.ops.window_spmm import (
        window_spmm_t_fwd, window_spmm_t_fwd_plain,
    )

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, plan_t = {}, None
    for k in (41, 32):
        Bk = np.ascontiguousarray(B[:, :k])
        # A·B[:, :k] is gold[:, :k]: SciPy sums each column on its own
        r, p = bench_checked(
            bench_spmm, g, k, "windowed", f"transposed k={k}", dev=dev, B=Bk,
            gold=np.ascontiguousarray(gold[:, :k]), iters=10, tm=256, W=128,
            min_count=64, sel=sel, transposed=True)
        plan_t = plan_t or p
        res[k] = r
        del p
    launches = read_launches()
    expect_launches(launches, "the transposed path", window_spmm_t_fwd=28)
    peak = torch.cuda.max_memory_allocated()
    if not plan_t.transposed or plan_t.bwd_tabs is not None:
        raise AssertionError("the transposed plan is not one")

    out = {}
    kw = dict(n_panels=plan_t.n_used_panels, W=plan_t.W)
    tabs = (plan_t.first, plan_t.out_panel, plan_t.win_step)
    for k in (41, 32):
        B_dev = torch.from_numpy(np.ascontiguousarray(B[:, :k])).cuda()
        B_T = B_dev.t().contiguous()
        err = check_window_t_kernel(
            torch, *tabs, plan_t.A, B_T, plan_t.n_used_panels, plan_t.W,
            plan_t.panel_step_ptr, f"main path k={k}")
        ms = time_cuda_ms(lambda: window_spmm_t_fwd(
            *tabs, plan_t.A, B_T, panel_step_ptr=plan_t.panel_step_ptr, **kw),
            iters=10)
        plain_ms = time_cuda_ms(lambda: window_spmm_t_fwd_plain(
            *tabs, plan_t.A, B_T, **kw), iters=5)
        n_win, n_bytes, n_flops = window_bytes_flops(plan_t, k)
        bound_ms, bound_by = bound(n_bytes, n_flops, peaks)
        out[k] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by,
                      dense_half_ms=time_cuda_ms(plan_t.dense_half, B_dev,
                                                 iters=10),
                      kernel1_ms=time_cuda_ms(plan.dense_half, B_dev,
                                              iters=10),
                      row_major_t_elap_ms=time_cuda_ms(plan, B_dev, iters=10))
        log(f"[kernels] window_spmm_t_fwd k={k}: {ms:.3f} ms "
            f"({n_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{n_bytes / (ms * 1e-3) / 1e9:.0f} GB/s), with the two "
            f"transposes {out[k]['dense_half_ms']:.3f} ms; kernel 1 at the "
            f"same k {out[k]['kernel1_ms']:.3f} ms; plan {res[k].t_elap_ms:.3f}"
            f" ms against the row-major plan's "
            f"{out[k]['row_major_t_elap_ms']:.3f} ms")
        if k == 41:
            # the library yardstick kernel 1 has: the same tiles as BSR
            A_bsr = window_as_bsr(torch, plan)
            B_pad = B_dev.new_zeros((A_bsr.shape[1], k))
            B_pad[:g.n] = B_dev
            C_T = window_spmm_t_fwd(*tabs, plan_t.A, B_T,
                                    panel_step_ptr=plan_t.panel_step_ptr, **kw)
            lib_err = float((torch.sparse.mm(A_bsr, B_pad) - C_T.t()
                             ).abs().max())
            library_ms = time_cuda_ms(torch.sparse.mm, A_bsr, B_pad, iters=3,
                                      warmup=1)
            log(f"[kernels] window_spmm_t_fwd yardstick torch.sparse.mm(BSR "
                f"{plan.W}x{plan.W}) k=41: {library_ms:.3f} ms, max |diff| vs"
                f" kernel {lib_err:.3e}")
            del A_bsr, B_pad, C_T
    log("[transposed] " + json.dumps({
        "launches": launches["window_spmm_t_fwd"], "peak_memory_allocated":
        peak, "steps_per_panel_p50_p99_max": steps_percentiles(plan_t),
        "k41": out[41], "k32": out[32]}))
    o = out[41]
    return {
        "name": "window_spmm_t_fwd", "route": "cuda",
        "source": "flex_tpu_torch/csrc/window_spmm_t.cu",
        "replaces": "flex_tpu/ops/window_spmm.py:1051",
        "launches": launches["window_spmm_t_fwd"], "max_abs_err": o["err"],
        "ms": o["ms"], "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
        "bound_by": o["bound_by"], "library_ms": library_ms, "k": 41,
        "kernel1_ms_same_k": o["kernel1_ms"], "ms_k32": out[32]["ms"],
        "kernel1_ms_k32": out[32]["kernel1_ms"],
        "plain_ms_k32": out[32]["plain_ms"],
        "bound_ms_k32": out[32]["bound_ms"],
        "max_abs_err_k32": out[32]["err"],
    }


def phase_gespmm(torch, g, dev, B, gold, A_csr, peaks, bench_spmm,
                 time_cuda_ms):
    """GE-SpMM at full size on the main path's graph, w = 32, k = 128 and
    41.  Returns kernel 7's row."""
    from flex_tpu_torch.ops.gespmm import (
        gespmm_partials, gespmm_partials_plain,
    )

    reset_launches()
    res, plan = {}, None
    for k in (K, 41):
        r, p = bench_checked(
            bench_spmm, g, k, "gespmm", f"gespmm k={k}", dev=dev,
            B=np.ascontiguousarray(B[:, :k]),
            gold=np.ascontiguousarray(gold[:, :k]), iters=10, w=32)
        plan = plan or p
        res[k] = r
        del p
    launches = read_launches()
    expect_launches(launches, "the GE-SpMM path", gespmm_partials=28)
    st = plan.stats
    N = st["n_chunks"]
    out = {}
    for k in (K, 41):
        B_dev = torch.from_numpy(np.ascontiguousarray(B[:, :k])).cuda()
        err = check_gespmm_kernel(torch, plan.cols, plan.vals, B_dev,
                                  f"main path k={k}")
        ms = time_cuda_ms(gespmm_partials, plan.cols, plan.vals, B_dev,
                          iters=10)
        plain_ms = time_cuda_ms(gespmm_partials_plain, plan.cols, plan.vals,
                                B_dev, iters=3, warmup=1)
        # each input once (cols, vals, B), the partials once; the
        # operations this graph needs, pads not counted
        n_bytes = plan.cols.numel() * 8 + B_dev.numel() * 4 + N * k * 4
        bound_ms, bound_by = bound(n_bytes, 2.0 * g.nnz * k, peaks)
        library_ms = time_cuda_ms(torch.sparse.mm, A_csr, B_dev, iters=20)
        out[k] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms,
                      t_elap_ms=res[k].t_elap_ms)
        log(f"[kernels] gespmm_partials k={k}: {ms:.3f} ms "
            f"({2.0 * g.nnz * k / (ms * 1e-3) / 1e9:.0f} GF/s; gathered rows "
            f"{plan.padded_nnz * k * 4 / (ms * 1e-3) / 1e9:.0f} GB/s), plan "
            f"{res[k].t_elap_ms:.3f} ms (scatter-add of {N} partials "
            f"included), library CSR {library_ms:.3f} ms")
    log("[gespmm] " + json.dumps({"stats": st, "k128": out[K],
                                  "k41": out[41],
                                  "launches": launches["gespmm_partials"]}))
    o = out[K]
    return {
        "name": "gespmm_partials", "route": "cuda",
        "source": "flex_tpu_torch/csrc/gespmm.cu",
        "replaces": "flex_tpu/ops/gespmm.py:78",
        "launches": launches["gespmm_partials"], "max_abs_err": o["err"],
        "ms": o["ms"], "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
        "bound_by": o["bound_by"], "library_ms": o["library_ms"],
        "plan_ms": o["t_elap_ms"], "ms_k41": out[41]["ms"],
        "plan_ms_k41": out[41]["t_elap_ms"],
        "library_ms_k41": out[41]["library_ms"],
        "max_abs_err_k41": out[41]["err"],
    }


def phase_baselines(torch, g, dev, B, gold, bench_spmm):
    """The two baselines without a hand kernel at full size, k = 128."""
    reset_launches()
    out = {}
    for method in ("xla", "bcoo"):
        torch.cuda.reset_peak_memory_stats()
        r, plan = bench_checked(bench_spmm, g, K, method, f"baseline {method}",
                                dev=dev, B=B, gold=gold, iters=10)
        out[method] = {"t_elap_ms": r.t_elap_ms, "gflops": r.gflops,
                       "t_pre_s": r.t_pre_s,
                       "peak_memory_allocated":
                       torch.cuda.max_memory_allocated()}
        del plan
    expect_launches(read_launches(), "the baselines")
    log("[baselines] " + json.dumps(out))
    return out


def phase_band(torch, peaks, bench_spmm, time_cuda_ms):
    """Band at full size: the JAX package's own band case, all three
    impls.  Returns the rows of kernels 5 and 6."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.io.synth import banded_graph
    from flex_tpu_torch.ops.pallas_band import (
        band_spmm_v1, band_spmm_v1_plain, band_spmm_v2, band_spmm_v2_plain,
    )
    from flex_tpu_torch.ops.ref import spmm_scipy
    from flex_tpu_torch.sparse.device import DeviceCSR

    t0 = time.perf_counter()
    g = banded_graph(262_144, 256, 64.0, seed=2)
    B = make_features(g, K)
    gold = spmm_scipy(g, B)
    log(f"[band] host: graph {g} + features + SciPy gold "
        f"{time.perf_counter() - t0:.1f}s")
    dev = DeviceCSR.from_graph(g, "cuda")
    reset_launches()
    res, plans = {}, {}
    for impl in ("pallas2", "xla", "pallas"):
        res[impl], plans[impl] = bench_checked(
            bench_spmm, g, K, "band", f"band impl={impl}", dev=dev, B=B,
            gold=gold, iters=10, tm=256, impl=impl)
    launches = read_launches()
    expect_launches(launches, "the band path", band_spmm_v2=14,
                    band_spmm_v1=14)
    del plans["xla"]
    p2, p1 = plans["pallas2"], plans["pallas"]
    st = p2.stats
    P, TM, W = p2.band[0].shape
    log(f"[band] plan: {st}; m={g.m} nnz={g.nnz}; "
        f"{2.0 * P * TM * 2 * W * K / 1e12:.4f} TFLOP (split band), "
        f"{2.0 * P * TM * W * K / 1e12:.4f} TFLOP (unsplit)")
    B_dev = torch.from_numpy(B).cuda()
    A_csr = csr_tensor(torch, g)
    library_ms = time_cuda_ms(torch.sparse.mm, A_csr, B_dev, iters=20)
    del A_csr

    out2 = band_spmm_v2(*p2.band, p2.ws, B_dev)
    torch.cuda.synchronize()
    e2 = hold_to_plain(
        torch, "band_spmm_v2", "full-size band k=128", out2,
        band_spmm_v2_plain(*p2.band, p2.ws, B_dev),
        band_spmm_v2_plain(p2.band[0].abs(), p2.band[1].abs(), p2.ws,
                           B_dev.abs()), 2 * W)
    out1 = band_spmm_v1(p1.band, p1.ws, B_dev)
    torch.cuda.synchronize()
    e1 = hold_to_plain(
        torch, "band_spmm_v1", "full-size band k=128", out1,
        band_spmm_v1_plain(p1.band, p1.ws, B_dev),
        band_spmm_v1_plain(p1.band.abs(), p1.ws, B_dev.abs()), W)
    del out1, out2
    ms2 = time_cuda_ms(band_spmm_v2, *p2.band, p2.ws, B_dev, iters=10)
    ms1 = time_cuda_ms(band_spmm_v1, p1.band, p1.ws, B_dev, iters=10)
    plain2 = time_cuda_ms(band_spmm_v2_plain, *p2.band, p2.ws, B_dev, iters=5)
    plain1 = time_cuda_ms(band_spmm_v1_plain, p1.band, p1.ws, B_dev, iters=5)
    io_bytes = (B_dev.numel() + P * TM * K) * 4 + P * 4
    b2, by2 = bound(2 * P * TM * W * 4 + io_bytes,
                    2.0 * P * TM * 2 * W * K, peaks)
    b1, by1 = bound(P * TM * W * 4 + io_bytes, 2.0 * P * TM * W * K, peaks)
    log(f"[kernels] band_spmm_v2: {ms2:.3f} ms "
        f"({2.0 * P * TM * 2 * W * K / (ms2 * 1e-3) / 1e12:.2f} TFLOP/s dense,"
        f" {2.0 * g.nnz * K / (ms2 * 1e-3) / 1e9:.0f} GF/s of the SpMM); "
        f"band_spmm_v1: {ms1:.3f} ms "
        f"({2.0 * P * TM * W * K / (ms1 * 1e-3) / 1e12:.2f} TFLOP/s dense); "
        f"impl=xla plan {res['xla'].t_elap_ms:.3f} ms; library CSR "
        f"{library_ms:.3f} ms")
    src = "flex_tpu_torch/csrc/band_spmm.cu"
    return [{
        "name": "band_spmm_v2", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/pallas_band.py:113",
        "launches": launches["band_spmm_v2"], "max_abs_err": e2, "ms": ms2,
        "plain_ms": plain2, "bound_ms": b2, "bound_by": by2,
        "library_ms": library_ms, "plan_ms": res["pallas2"].t_elap_ms,
        "t_pre_s": res["pallas2"].t_pre_s,
    }, {
        "name": "band_spmm_v1", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/pallas_band.py:191",
        "launches": launches["band_spmm_v1"], "max_abs_err": e1, "ms": ms1,
        "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
        "library_ms": library_ms, "plan_ms": res["pallas"].t_elap_ms,
        "t_pre_s": res["pallas"].t_pre_s,
        "impl_xla_plan_ms": res["xla"].t_elap_ms,
    }]


def main() -> int:
    quick = "--quick" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import flex_tpu_torch  # noqa: F401  (fails outside a checkout)
    from flex_tpu_torch import kernels
    from flex_tpu_torch.bench.harness import bench_spmm, time_cuda_ms
    from flex_tpu_torch.ops.window_spmm import (
        window_select, window_spmm_fwd, window_spmm_fwd_plain,
    )

    # 1. environment
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = peaks_for(name)

    # 2. build
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f}s")
    for src, out in kernels.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}: {line.strip()}")

    # 3. kernel vs plain
    phase_kernels_vs_plain(torch)
    phase_new_kernels_vs_plain(torch)
    if quick:
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # 4. main path at full size
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.ops.ref import spmm_scipy
    from flex_tpu_torch.sparse.device import DeviceCSR

    t0 = time.perf_counter()
    g = load_graph()
    log(f"[graph] {g} ready in {time.perf_counter() - t0:.1f}s (host)")
    t0 = time.perf_counter()
    sel = window_select(g, tm=256, W=128, min_count=64,
                        max_dense_bytes=6 << 30)
    log(f"[select] host {time.perf_counter() - t0:.1f}s: "
        f"coverage={sel['coverage']:.4f} steps={sel['total_steps']} "
        f"n_res={sel['n_res']} dense_bytes={sel['dense_bytes']} "
        f"min_count_eff={sel['min_count_eff']}")
    B = make_features(g, K)
    t0 = time.perf_counter()
    gold = spmm_scipy(g, B)
    log(f"[gold] scipy {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dev = DeviceCSR.from_graph(g, "cuda")
    torch.cuda.synchronize()
    log(f"[upload] CSR {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    r, plan = bench_spmm(g, K, "windowed", dev=dev, B=B, gold=gold, iters=10,
                         tm=256, W=128, min_count=64, sel=sel)
    launches = read_launches()
    # 3 warm-up + 10 timed + 1 checked call, and no other kernel
    expect_launches(launches, "the forward path", window_spmm_fwd=14)
    peak_mem = torch.cuda.max_memory_allocated()
    if r.err_frac is None or r.err_frac > 1e-4:
        raise AssertionError(f"main path err_frac={r.err_frac} > 1e-4")

    B_dev = torch.from_numpy(B).to("cuda")
    C = plan(B_dev)
    if tuple(C.shape) != (g.m, K) or not bool(torch.isfinite(C).all()):
        raise AssertionError(f"main path output {tuple(C.shape)} is not a "
                             f"finite ({g.m}, {K}) tensor")
    del C
    dense_ms =time_cuda_ms(plan.dense_half, B_dev, iters=20)
    res_ms = time_cuda_ms(plan.ell, B_dev, iters=20)
    A_csr = csr_tensor(torch, g)
    library_ms = time_cuda_ms(torch.sparse.mm, A_csr, B_dev, iters=20)
    st = plan.stats
    log("[main] " + json.dumps({
        "t_pre_s": r.t_pre_s, "t_elap_ms": r.t_elap_ms, "gflops": r.gflops,
        "pre_elap_ratio": r.pre_elap_ratio, "err_frac": r.err_frac,
        "coverage": st["coverage"], "steps": st["n_steps"],
        "n_res": st["n_res"], "dense_bytes": st["dense_bytes"],
        "max_steps_per_panel": st["max_steps_per_panel"],
        "dense_kernel_ms": dense_ms, "residue_ms": res_ms,
        "launches": launches["window_spmm_fwd"],
        "max_memory_allocated": peak_mem, "library_ms": library_ms,
        "library_gflops": 2 * g.nnz * K / (library_ms * 1e-3) / 1e9,
        "card": smi}))
    del A_csr

    # 5. kernels on the main path's tensors
    args = (plan.first, plan.out_panel, plan.win_step, plan.A, B_dev)
    kw = dict(n_panels=plan.n_used_panels, W=plan.W)
    max_abs_err = check_window_kernel(
        torch, {"first": plan.first, "out_panel": plan.out_panel,
                "win_step": plan.win_step, "A": plan.A, "B": B_dev},
        plan.n_used_panels, plan.W, plan.panel_step_ptr, "main path k=128")
    # the train step's second layer calls the kernel at k = 41
    max_abs_err_41 = check_window_kernel(
        torch, {"first": plan.first, "out_panel": plan.out_panel,
                "win_step": plan.win_step, "A": plan.A,
                "B": B_dev[:, :41].contiguous()},
        plan.n_used_panels, plan.W, plan.panel_step_ptr, "main path k=41")
    C_k = plan.dense_half(B_dev)
    plain_ms = time_cuda_ms(lambda: window_spmm_fwd_plain(*args, **kw),
                            iters=5)
    log(f"[kernels] window_spmm_fwd longest panel alone: "
        f"{longest_panel_ms(torch, plan, B_dev, time_cuda_ms):.3f} ms; "
        f"steps per panel p50/p99/max "
        f"{steps_percentiles(plan)}")
    n_win, n_bytes, n_flops = window_bytes_flops(plan, K)
    bound_ms, bound_by = bound(n_bytes, n_flops, peaks)
    A_bsr = window_as_bsr(torch, plan)
    B_pad = B_dev.new_zeros((A_bsr.shape[1], K))
    B_pad[:g.n] = B_dev
    lib_err = float((torch.sparse.mm(A_bsr, B_pad) - C_k).abs().max())
    win_library_ms = time_cuda_ms(torch.sparse.mm, A_bsr, B_pad, iters=10)
    log(f"[kernels] window_spmm_fwd yardstick torch.sparse.mm(BSR "
        f"{plan.W}x{plan.W}): {win_library_ms:.3f} ms, max |diff| vs "
        f"kernel {lib_err:.3e}")
    del A_bsr, B_pad, C_k
    rows = [{
        "name": "window_spmm_fwd", "route": "cuda",
        "source": "flex_tpu_torch/csrc/window_spmm.cu",
        "replaces": "flex_tpu/ops/window_spmm.py:958",
        "launches": launches["window_spmm_fwd"],
        "max_abs_err": max_abs_err, "ms": dense_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": win_library_ms, "max_abs_err_k41": max_abs_err_41,
    }]
    log(f"[kernels] window_spmm_fwd: real windows {n_win}, "
        f"{n_flops / 1e12:.4f} TFLOP, {n_bytes / 1e9:.3f} GB, "
        f"{n_flops / (dense_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")

    # 6. gradient path, 7. training path, 8. the backward kernels
    launches_grad, gA_err, co, g_dense, tplan = phase_gradient(
        torch, g, plan, B_dev)
    launches_train = phase_training(torch, g, plan, tplan, B_dev,
                                    time_cuda_ms, smi,
                                    profile="--profile" in sys.argv[1:])
    rows += phase_bwd_kernels(torch, g, plan, B_dev, co, g_dense, gA_err,
                              launches_grad, launches_train, peaks,
                              time_cuda_ms)
    log(f"[kernels] launches: forward path {launches}, gradient path "
        f"{launches_grad}, 7 train steps {launches_train}")
    del co, g_dense, tplan

    # 9. the transposed plan beside the row-major one (both A arrays live)
    rows.append(phase_transposed(torch, g, dev, sel, plan, B, gold, peaks,
                                 bench_spmm, time_cuda_ms))
    del plan
    sel.pop("torch_tables", None)   # the selection's tables on the card
    torch.cuda.empty_cache()
    # 10. GE-SpMM and 11. the baselines on the main path's graph
    A_csr = csr_tensor(torch, g)
    gespmm_row = phase_gespmm(torch, g, dev, B, gold, A_csr, peaks,
                              bench_spmm, time_cuda_ms)
    del A_csr
    phase_baselines(torch, g, dev, B, gold, bench_spmm)
    del dev, B_dev, gold
    torch.cuda.empty_cache()
    # 12. band, on its own graph
    rows += phase_band(torch, peaks, bench_spmm, time_cuda_ms)
    rows.append(gespmm_row)
    if len(rows) != 7 or any(r["launches"] < 1 for r in rows):
        raise AssertionError(f"a kernel was never launched on its path: "
                             f"{[(r['name'], r['launches']) for r in rows]}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
