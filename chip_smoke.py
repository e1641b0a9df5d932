#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only

Phases:
  1. environment: card name and power limit, torch/CUDA versions; TF32 off.
  2. build every CUDA kernel of the package from ``flex_tpu_torch/csrc``.
  3. each kernel against its plain PyTorch version on random tables at the
     main path's shapes, with the tolerance stated there.
  4. the main path at full size: reddit_posts(seed=0) -> rbdeg ->
     window_select(tm=256, W=128, min_count=64, max_dense_bytes=6 GiB) ->
     prepare_windowed on cuda -> plan(B), B = make_features(g, 128),
     checked with res_check against SciPy (err_frac <= 1e-4).
  5. per kernel, on the main path's own tensors: launches during phase 4,
     max error against the plain version, kernel / plain / bound /
     library times, printed as one JSON line.
The last line is {"ok": true, "device": {...}}.  Any failure raises and
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


def phase_kernels_vs_plain(torch, dev="cuda"):
    rng = np.random.default_rng(0)
    # a 1-step panel, a 64-step panel, a spread of others, trailing empties;
    # n % W != 0
    steps = np.concatenate([[1, 64], rng.integers(1, 24, 60), [1]])
    t, n_panels, W, ptr = random_window_case(torch, rng, steps, 50_000 + 37, dev)
    check_window_kernel(torch, t, n_panels, W, ptr,
                        f"S={int(steps.sum())} panels={n_panels} n=50037")
    # all-sentinel panel and a tiny graph with a single partial block
    steps = np.array([3, 2])
    t, n_panels, W, ptr = random_window_case(torch, rng, steps, 200, dev,
                                             sentinel_frac=0.5)
    t["win_step"][:3 * 4] = -(-200 // W)  # panel 0: every window a sentinel
    check_window_kernel(torch, t, n_panels, W, ptr, "sentinel panel, n=200")


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

    window_spmm_fwd.launches = 0
    r, plan = bench_spmm(g, K, "windowed", dev=dev, B=B, gold=gold, iters=20,
                         tm=256, W=128, min_count=64, sel=sel)
    launches = {"window_spmm_fwd": window_spmm_fwd.launches}
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
        plan.n_used_panels, plan.W, plan.panel_step_ptr, "main path")
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
    del A_bsr, B_pad
    rows = [{
        "name": "window_spmm_fwd", "route": "cuda",
        "source": "flex_tpu_torch/csrc/window_spmm.cu",
        "replaces": "flex_tpu/ops/window_spmm.py:958",
        "launches": launches["window_spmm_fwd"],
        "max_abs_err": max_abs_err, "ms": dense_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": win_library_ms,
    }]
    log(f"[kernels] window_spmm_fwd: real windows {n_win}, "
        f"{n_flops / 1e12:.4f} TFLOP, {n_bytes / 1e9:.3f} GB, "
        f"{n_flops / (dense_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
