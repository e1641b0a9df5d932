#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only
    python3 chip_smoke.py --profile  # also trace two train steps

Phases:
  1. environment: card name and power limit, torch/CUDA versions; TF32 off.
  2. build every CUDA kernel of the package from ``flex_tpu_torch/csrc``.
  3. each kernel (forward, g_A, g_B) against its plain PyTorch version on
     random tables at the main path's shapes (k = 128 and k = 41), with
     the tolerance stated there.
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


def check_window_kernel(torch, t, n_panels, W, ptr, label):
    """|C_kernel - C_plain| <= 2·L·eps32·(|A|·|B|) elementwise, L = the
    panel's contraction length (steps·G·W): the worst-case f32 rounding of
    two length-L sums taken in different orders."""
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
    tol = 2 * L * EPS32 * absprod.double()
    err = (C_k.double() - C_p.double()).abs()
    ratio = float((err / tol.clamp_min(1e-30)).max())
    max_err = float(err.max())
    if not bool(torch.isfinite(C_k).all()) or bool((err > tol).any()):
        raise AssertionError(f"window kernel disagrees with plain on {label}:"
                             f" max_abs_err={max_err:.3e} ratio={ratio:.3f}")
    log(f"[kernel-vs-plain] window_spmm {label}: max_abs_err={max_err:.3e} "
        f"worst err/bound={ratio:.4f} ok")
    return max_err


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


def _worst(torch, err, tol):
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max()), \
        bool((err > tol).any())


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
    max_err, ratio, bad = _worst(
        torch, (out.double() - ref.double()).abs(),
        2 * L[:, None] * EPS32 * absprod.double())
    if bad or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"g_B kernel disagrees with plain on {label}: "
                             f"max_abs_err={max_err:.3e} ratio={ratio:.3f}")
    log(f"[kernel-vs-plain] window_bwd_gB {label}: max_abs_err={max_err:.3e} "
        f"worst err/bound={ratio:.4f} ok")
    return max_err


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
    S, TM, GW = plan.A.shape
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


def reset_launches():
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gB, window_spmm_fwd,
    )

    for fn in (window_spmm_fwd, window_bwd_gA, window_bwd_gB):
        fn.launches = 0


def read_launches() -> dict:
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gB, window_spmm_fwd,
    )

    return {fn.__name__: fn.launches
            for fn in (window_spmm_fwd, window_bwd_gA, window_bwd_gB)}


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
    if launches != {"window_spmm_fwd": 1, "window_bwd_gA": 1,
                    "window_bwd_gB": 1}:
        raise AssertionError(f"gradient path launches {launches}, expected "
                             f"one of each kernel")
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
    if l2 != {"window_spmm_fwd": 1, "window_bwd_gA": 0, "window_bwd_gB": 1}:
        raise AssertionError(f"training-backward path launches {l2}: A is a "
                             f"constant there, so no g_A")
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
    if launches != {"window_spmm_fwd": 14, "window_bwd_gA": 0,
                    "window_bwd_gB": 14}:
        raise AssertionError(f"7 train steps launched {launches}; expected "
                             f"2 forward and 2 g_B per step and no g_A")
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
    if launches["window_bwd_gA"] or launches["window_bwd_gB"]:
        raise AssertionError(f"the forward path launched a backward kernel: "
                             f"{launches}")
    peak_mem = torch.cuda.max_memory_allocated()
    if r.err_frac is None or r.err_frac > 1e-4:
        raise AssertionError(f"main path err_frac={r.err_frac} > 1e-4")
    if launches["window_spmm_fwd"] < 1:
        raise AssertionError("main path never launched the window kernel")

    B_dev = torch.from_numpy(B).to("cuda")
    C = plan(B_dev)
    if tuple(C.shape) != (g.m, K) or not bool(torch.isfinite(C).all()):
        raise AssertionError(f"main path output {tuple(C.shape)} is not a "
                             f"finite ({g.m}, {K}) tensor")
    del C
    dense_ms =time_cuda_ms(plan.dense_half, B_dev, iters=20)
    res_ms = time_cuda_ms(plan.ell, B_dev, iters=20)
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(g.row_ptr).cuda(),
        torch.from_numpy(g.col.astype(np.int64)).cuda(),
        torch.from_numpy(g.vals).cuda(), size=g.shape)
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
    del A_bsr, B_pad, C_k, gold
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
