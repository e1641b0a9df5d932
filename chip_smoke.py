#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only
    python3 chip_smoke.py --profile  # also trace two GCN and two GAT steps

Phases:
  1. environment: card name and power limit, torch/CUDA versions; TF32 off.
  2. build every CUDA kernel of the package from ``flex_tpu_torch/csrc``.
  3. each kernel (forward, g_A, g_B; transposed forward, band v2 and v1,
     the row-unit kernel of GE-SpMM and the residue) against its plain
     PyTorch version on random tables
     at its path's shapes (k = 128 and k = 41), with the tolerance stated
     there.  The forward and g_B run in work units: their tables hold
     panels and slot chains of a single step, exactly one unit, one unit
     plus one and many units, and an all-sentinel step; k = 128, 41, 32,
     64, 16 and 200 (every column tile); each is launched twice and must
     give the same bits.  The
     transposed forward runs in units too: panels of 1, 8, 9 and 17 steps
     with all-sentinel steps, TM 256 and 128, k = 16, 32, 41, 64, 100, a
     misaligned Bᵀ.  Band v2 and v1 read depth ranges: tiles with empty,
     one-half, narrow and full ranges at k = 32, 41, 128, 200, bit-equal to
     the same kernel on full-depth ranges.  The row-unit kernel on GE-SpMM
     plans (pad chunks, empty and split rows; k = 128, 41, 200) and on ELL
     plans and their transposed plans added into an accumulator, each
     launched twice for equal bits.  g_A runs on the forward's units of
     panels of 1, 8, 9 and 17 steps with an all-sentinel step, TM 128, 200,
     256 and 384, k = 16, 32, 41, 128, 200 (beyond its resident depth of 128)
     and a misaligned g at k = 41; its sentinel tiles must be exactly zero,
     and a second launch, one-step units and derived units give its bits.
  4. the forward path at full size: reddit_posts(seed=0) -> rbdeg ->
     window_select(tm=256, W=128, min_count=64, max_dense_bytes=6 GiB) ->
     prepare_windowed on cuda -> plan(B), B = make_features(g, 128),
     checked with res_check against SciPy (err_frac <= 1e-4); a second
     call must give the same bits.
  5. the forward kernel on that path's own tensors, at k = 128 and at the
     train step's k = 41 (there also res_check against SciPy): max error
     against the plain version, kernel / plain / bound / library times, the
     work units (count, steps per unit, scratch bytes of the partial
     tiles), the reduce pass alone, the longest panel alone, and the same
     kernel with one unit per panel.
  6. the gradient path at full size: loss = (plan(B) * co).sum() with B and
     plan.A requiring grad; the backward launches the g_A and g_B kernels;
     g_B against SciPy's A^T.co (res_check err_frac <= 1e-4), g_A against
     its plain version and A.grad against the kernel's g_A; the gradient
     call timed with and without A's gradient; once more with
     ``with_training_bwd`` (twice, for equal bits), and g_B at k = 41.
  7. the training path at full size: GCN(128 -> 128 -> 41) through
     ``make_train_step`` with Adam(1e-2), 2 warm-up and 5 timed steps; the
     parameter gradients of the first step against the same loss taken
     through the plain versions on the card; the launch counts per step, a
     finite and falling loss, ms/step, peak memory and the step's split.
  8. the two backward kernels on the main path's own tensors, as in 5
     (g_A at k = 128 and 41 in the forward's units and one step a block,
     beside the plain version's bmm alone on gathered operands, the two
     gathers, and ptxas's registers and spills; g_B at k = 128 and k = 41,
     with its units, reduce pass, longest chain alone and one unit per
     chain); then the residue alone: the
     row-unit kernel added into an accumulator at k = 128, 41 and 32
     against its plain version and cuSPARSE on the residue's CSR, and the
     transposed residue without its pad entries (``with_training_bwd``'s)
     and with them (the JAX package's tables).
  9. the transposed windowed plan at full size: the same graph, ordering
     and selection, ``prepare_windowed(transposed=True)`` through
     ``bench_spmm`` at k = 41 and k = 32 (err_frac <= 1e-4), the
     transposed kernel against plain on its tensors, its time beside the
     row-major kernel's at the same k; its work units, the strided reduce
     pass alone, the longest panel alone and one unit per panel.
 10. GE-SpMM at full size on that graph (w = 32, k = 128 and 41): the
     plan is the row-unit kernel alone; its unit report, equal bits.
 11. the baselines ``"xla"`` and ``"bcoo"`` at full size (k = 128).
 7b. GraphSAGE(128 -> 128 -> 41) on the main path's windowed plan with its
     training backward: the first step's gradients against the plain
     plan, launch counts (kernels 1, 3, 7), ms/step and peak memory over 5
     timed steps; a checkpoint after step 3, restored into a fresh model
     and Adam, must give step 4's loss and parameters bit for bit.
 11b. GAT(128 -> 4 heads x 16 -> 41, Adam 1e-2) on the main path's graph
     (unit self-loops): kernel 7 on the dynamic SpMM's forward and g_B
     tables against plain at k = 16 and 41, the first step's loss and
     gradients against the plain dynamic SpMM, whether two forwards give
     the same bits, 2 warm-up and 5 timed steps (16 launches of kernel 7
     a step), ms/step and peak memory.
 12. band at full size: banded_graph(262144, 256, 64.0, seed=2), tm = 256,
     k = 128, the three impls through ``bench_spmm``, both band kernels
     against plain on the plans' tensors; both kernels' depth ranges (their
     build time, the share of the depth they read, the empty tiles), each
     kernel on full-depth ranges beside the ranged run (bit-equal), the
     bound of its ranges and of its format.
 13. panel at full size: reorder(hub_graph(200000, 20M, n_hub_cols=512,
     hub_frac=0.95, seed=0), "deg"), k = 128, through ``bench_spmm``
     without hub rows and with hub_threshold=100 (the hub prefix on kernel
     7, held to its plain version), beside cuSPARSE on the same CSR; the
     plans' stats and host seconds.
 11c. [autotune] the autotuner's rates on the main path's graph: seconds
     per padded ELL nonzero on kernel 7 at k = 128 and 41, per kept window
     on kernel 1 (k = 128) and kernel 4 (k = 41), the FP32 torch.bmm and
     row-gather rates, the fixed cost of one call; then suggest's choice
     and model beside autotune's measured ranking at k = 128 and 41.
 11d. [gcn_bench] bench_gcn_layer(g, 128, 41, method="ell"): both
     associations timed, cross and SciPy err_frac 0.
 14. [cli] ``python -m flex_tpu_torch`` in a child process on the main
     path's graph as a CSV (written by save_csv before ordering; load_csv
     gives back its row_ptr and col exactly), --order=rbdeg with the
     ordering file: --method=auto at k = 128 and 41, --method=windowed
     --min_count=64 at k = 128 (phase 4's selection, tElap within 3 % of
     phase 4's); each exits 0 with err_frac <= 1e-4 in its CSV row, the
     method it printed, its kernels' launch counts and their names in
     its trace.
 15. [sweep] ``python -m flex_tpu_torch <flickr_posts csv> 128
     --method=sweep`` on flickr_posts(seed=0) (Flickr's size): exit 0,
     every row checked or refused by its format.
 3b. (with phase 3) kernel 7's bf16 instance against its plain version on
     B rounded to bf16, at the f32 instance's shapes (GE-SpMM plans with
     pad chunks, empty and split rows, k = 128, 41, 200; ELL plans and
     their transposed plans added into an accumulator): launched twice,
     the same bits; the f32 instance on B widened, the same bits; a
     misaligned B (scalar loads), the same bits.
 11e. [bf16] on the main path's graph: prepare_ell(b_dtype="bfloat16")
     at k = 128 and 41 through bench_spmm (res_check at the bf16 scale,
     eps_scale 4 * 2^16), the bf16 instance against plain on the plan's
     tables, its time beside the f32 plan's, its bytes bound (2 bytes a B
     element), cuSPARSE on the CSR, whether torch takes a bf16 CSR; the
     windowed plan with a bf16 residue at k = 128.
 11f. [options] at k = 128: every fused name (one build, each
     bit-equal to the default plan), step_order="lex" and impl="xla" (the
     plain product) through bench_spmm.
 11g. [sharded] on make_mesh(4) (four entries of cuda:0 on one card):
     prepare_ell_sharded in both B layouts, prepare_windowed_sharded, each
     against SciPy with its launches of one call (one or more a shard),
     then g_B through the sharded windowed plan with its training
     backward (kernels 3 and 7 on every shard) against SciPy's A^T.co.
 11h. [parallel_2d] GCN(128 -> 128 -> 41) through make_train_step_2d on
     a (2, 2) mesh: the first loss against the one-device step's, 2 + 5
     steps, a finite and falling loss, ms/step.
 16. [headline] ``python3 bench_torch.py`` in a child process on the
     cached graph: exit 0, one stdout line with the headline's keys,
     err_frac <= 1e-4, value > 0 and the method that suggest(g, 128,
     win_min_count=64, max_dense_bytes=6 GiB) chooses in this process;
     its launch counts (exact for the methods the command line checks)
     and its tElap beside [cli_auto_k128]'s.
 17. [entry] entry()'s forward (GCN 64 -> 32 -> 3 on the ELL plan of the
     Pubmed-sized R-MAT graph) against the same forward through the plan's
     plain version (max |diff| <= 1e-4 * max(1, max |plain|)), a second
     call with the same bits, kernel 7's launches (one a layer); then
     dryrun_multichip(4) on one card (a 2-D GCN step, the sharded
     windowed forward and gradient, the gathered B layout, the budgeted
     selection), which must launch kernels 1, 3 and 7.
 18. [examples] the three training examples at their default sizes for
     a few steps each: a finite loss that falls, ms/step, peak memory and
     the launch counts (each of the example's kernels at least once);
     kernels 1 and 3 on the windowed example's own plan at k = 64 and 8
     against their plain versions.
 19. [micro] the probes of experiments/: each of
     flex_tpu_torch.experiments.micro_ellreduce, micro_dma_u16, micro_tpu
     and micro_vmem_gather run by its main() at the scripts' sizes (their
     launches of kernels 8-11 counted from 0); u16x2's rebuilt rows
     bit-exact; then kernel 8 (row_gather_sum) at the scripts' 64 x 1024
     (16 deep) and 32 x 1024 (8 deep) rows and at 7,520 x 1024 rows beside
     kernel 7's gather rate in phase 10 (GE-SpMM, k = 128), kernel 9
     (smem_probe) at the opt-in limit that m6_vmem_probe found, timed on
     the card alone (200 calls in a CUDA graph) beside x.clone() and the
     empty launch of its shape at 48 and 227 KB (its floor), with the
     host clock of kernels.launch alone, kernel 10 (slab_gather) in both
     placements with and without bf16 rounding and kernel 11 (ell_reduce)
     on the script's 3.4 GB, each held to its plain version (bits for
     8-10, the f32 order bound for 11) with its time, the plain
     version's, the library call's and the bound; kernels 8 and 10 also
     on the card alone.  Phase 3 also holds kernels 8-11 to their plain
     versions at the edges of their shapes.
 20. [winstep] E7: flex_tpu_torch.experiments.micro_winstep.main() at the
     script's sizes (A f32 [28000 / G, 256, G·128], 3.67 GB, G = 4 and 8;
     kernel 1 on its highest rows, kernel 12 on its default rows, and
     kernel 1 with one step a panel), its launches counted from 0; kernels
     1 and 12 against their plain versions on E7's own G = 4 tables;
     kernel 12's ms at G = 4 and 8 (its B cast inside the call, timed
     apart too; again with B's windows drawn from 64 blocks, held in L2),
     plain, library (torch.bmm on gathered windows), bound
     (bytes at 3.35 TB/s or operations at the bf16 tensor rate, 989
     TFLOP/s), launches, stages and shared memory a block, and ptxas's
     registers and spills; then the
     precision ladder: micro_precision.main() (default, high, highest and
     the card's tf32 rung) and high_precision_host.main() on the main
     path's graph (res_check of each rung's dense half).  Phase 3 also
     holds kernel 12 to its plain version on random tables (panels of 1,
     8, 9 and 17 steps, an all-sentinel step, G = 4 and 8, W = 128 and 48,
     TM = 256 and 200 at both, k = 128, 41 and 200, a misaligned B),
     launched twice for equal bits.
 21. [band_v2] E8: pallas_band_v2.main() on banded_graph(262144, 256,
     64.0, seed=2), k = 128: kernel 5 on the script's split, err_frac
     <= 1e-4 against SciPy, its launches and ms beside phase 12's.
 22. [studies] gen_graphs (the headline's cache: must be there),
     bench_windowed (mc 64, mc 128 and ell through bench_spmm),
     profile_windowed at mc 64 and 128, analyze_windows,
     subtile_occupancy, sweep_windowed_r3 and sweep_windowed_r4 in full
     (each config runs, or is the refusal the JAX package shares), and
     bench_gcn_train (grad parity, then ms/step on windowed,
     windowed+tbwd, ell and ell+tbwd), each with its seconds and its
     launches counted from 0.
Phase 3 also holds the transposed, band and GE-SpMM kernels to their plain
versions on random tables.  Each path is driven with the launch counts
set to 0 just before it and read just after (the command-line phases
count in their own process, from 0, and print the counts last).
Then one JSON line {"kernels": [...]} (thirteen rows: kernel 7's bf16
instance is its own, kernels 8-11 are the probes', kernel 12 is E7's
default rows'; each row also counts its kernel's launches in the
phases autotune, gcn_bench, cli_*, sweep, 11e-11h, 16-18, winstep and
each study), the card's
name and power limit, and last {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without a CUDA card the script exits 2
and prints no result.  The ordered graph is cached under
flex_tpu_torch/_build/.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

K = 128
EPS32 = float(np.finfo(np.float32).eps)

def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    from flex_tpu_torch.utils.device_info import smi_query

    line = smi_query(0)
    if line is None:
        raise RuntimeError("nvidia-smi did not answer")
    return line


def bound(n_bytes: float, n_flops: float, peaks: dict) -> tuple[float, str]:
    t_b = n_bytes / peaks["bytes"] * 1e3
    t_f = n_flops / peaks["fp32"] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: window kernel vs plain on random tables
# ---------------------------------------------------------------------------

def random_window_case(torch, rng, steps_per_panel, n, dev, TM=256, G=4,
                       W=128, k=K, sentinel_frac=0.2, trailing_empty=2,
                       sentinel_steps=(), chains=()):
    """Random step tables: panels with the given step counts (then
    ``trailing_empty`` panels with none), block ids sorted within a step
    and including the last, partial block; a fraction of sentinels; the
    steps ``sentinel_steps`` all sentinels.  ``chains`` plants block ids
    0, 1, ... in exactly that many slots each (the g_B kernel's chains of
    slots); every other id is >= len(chains)."""
    nblk = -(-n // W)
    S = int(sum(steps_per_panel))
    out_panel = np.repeat(np.arange(len(steps_per_panel)), steps_per_panel)
    first = np.zeros(S, np.int32)
    starts = np.concatenate([[0], np.cumsum(steps_per_panel)[:-1]])
    first[starts] = 1
    win = np.sort(rng.integers(len(chains), nblk, (S, G)), axis=1)
    win[::7, -1] = nblk - 1                       # rows >= n read as zero
    win[rng.random((S, G)) < sentinel_frac] = nblk
    win[list(sentinel_steps)] = nblk
    if chains:
        free = np.setdiff1d(np.arange(S), sentinel_steps)
        pos = rng.permutation(len(free) * G)[:int(sum(chains))]
        win[free[pos // G], pos % G] = np.repeat(np.arange(len(chains)),
                                                 chains)
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


def require_same_bits(torch, name, label, a, b):
    """Two launches on the same inputs: the units' partial tiles are added
    in a fixed order, so the outputs are equal bit for bit."""
    if not torch.equal(a, b):
        raise AssertionError(f"{name} on {label}: a second launch gave other "
                             f"bits, max |diff| {float((a - b).abs().max())}")


def check_window_kernel(torch, t, n_panels, W, ptr, label, units=None,
                        bf16=False):
    """Kernel 1 (kernel 12 with ``bf16``: its plain version is kernel 1's
    on the bf16-rounded operands) against its plain version; L = the
    panel's contraction length (steps·G·W), |a|·|b| of the operands the
    plain version multiplies.  Launched twice: the outputs must be
    bit-equal.  Returns max_abs_err."""
    from flex_tpu_torch.experiments import micro
    from flex_tpu_torch.ops.window_spmm import (
        window_spmm_fwd, window_spmm_fwd_plain,
    )

    name, fn, plain = (
        ("window_step_bf16", micro.window_step_bf16,
         micro.window_step_bf16_plain) if bf16 else
        ("window_spmm", window_spmm_fwd, window_spmm_fwd_plain))
    args = (t["first"], t["out_panel"], t["win_step"])
    kw = dict(n_panels=n_panels, W=W, panel_step_ptr=ptr, units=units)
    C_k = fn(*args, t["A"], t["B"], **kw)
    require_same_bits(torch, name, label, C_k, fn(*args, t["A"], t["B"],
                                                  **kw))
    C_p = plain(*args, t["A"], t["B"], n_panels=n_panels, W=W)
    A, B = ((x.bfloat16().float() for x in (t["A"], t["B"])) if bf16
            else (t["A"], t["B"]))
    absprod = window_spmm_fwd_plain(*args, A.abs(), B.abs(),
                                    n_panels=n_panels, W=W)
    TM, GW = t["A"].shape[1], t["A"].shape[2]
    L = ((ptr[1:] - ptr[:-1]).double() * GW).repeat_interleave(TM)[:, None]
    return hold_to_plain(torch, name, label, C_k, C_p, absprod, L)


# column tiles of 128, 48, 32 and 64, and two of 128; 64 is the windowed
# example's width, 16 that of dryrun_multichip's windowed plan
KS = (K, 41, 32, 64, 16, 200)


def check_window_kernel_ks(torch, t, n_panels, W, ptr, label, ks=KS):
    """The forward kernel on one random-table case at each k: the column
    tile follows k, and k = 41 takes the copies of 4 bytes."""
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
            "slot_ptr": d["slot_ptr"], "n_blk_used": d["n_blk_used"],
            "units": d["slot_units"]}


def step_units(S, dev):
    """The step grain of the g_A kernel: a table of one-step units."""
    from flex_tpu_torch.ops.window_spmm import device_units

    return device_units(np.arange(S + 1, dtype=np.int32), 1, dev)


def check_gA_kernel(torch, out_panel, win_step, g, B, TM, W, label,
                    units=None, chunk=1024):
    """|gA_kernel - gA_plain| <= 2·k·eps32·(|g|·|B|ᵀ) elementwise (k is the
    contraction length); sentinel tiles exactly zero.  Each element sums
    over k in one fixed order whatever the unit table, so a second launch,
    the step grain and (when ``units`` is given) the derived units give the
    same bits.  The plain version runs ``chunk`` steps at a time to bound
    its temporaries.  Returns (g_A, max_abs_err)."""
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gA, window_bwd_gA_plain,
    )

    S, k = out_panel.shape[0], B.shape[1]
    G = win_step.shape[0] // S
    gA = window_bwd_gA(out_panel, win_step, g, B, TM=TM, W=W, units=units)
    again = [units, step_units(S, g.device)] + ([None] if units else [])
    for u in again:
        require_same_bits(torch, "window_bwd_gA", f"{label} units="
                          f"{'derived' if u is None else u[0].shape[0]}", gA,
                          window_bwd_gA(out_panel, win_step, g, B, TM=TM, W=W,
                                        units=u))
    torch.cuda.synchronize()
    nblk = max(-(-B.shape[0] // W), 1)
    sent = (win_step == nblk).view(S, G)
    if bool(gA.view(S, TM, G, W).permute(0, 2, 1, 3)[sent].any()):
        raise AssertionError(f"g_A kernel on {label}: a sentinel tile is not "
                             f"zero")
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
        f"worst err/bound={ratio:.4f} sentinel tiles {int(sent.sum())} zero, "
        f"{len(again) + 1} launches bit-equal ok")
    return gA, max_err


def check_gB_kernel(torch, tabs, out_panel, A, g, W, label):
    """|gB_kernel - gB_plain| <= 2·L·eps32·(|A|ᵀ·|g|) elementwise, L = the
    block's contraction length (its slots · TM).  Launched twice: the
    outputs must be bit-equal.  Returns max_abs_err."""
    from flex_tpu_torch.ops.window_spmm import (
        window_bwd_gB, window_bwd_gB_plain,
    )

    kw = dict(W=W, n_blk_used=tabs["n_blk_used"])
    args = (tabs["slot_s"], tabs["slot_g"], tabs["slot_ptr"], out_panel)
    out = window_bwd_gB(*args, A, g, units=tabs["units"], **kw)
    require_same_bits(torch, "window_bwd_gB", label, out,
                      window_bwd_gB(*args, A, g, units=tabs["units"], **kw))
    torch.cuda.synchronize()
    ref = window_bwd_gB_plain(*args, A, g, **kw)
    absprod = window_bwd_gB_plain(*args, A.abs(), g.abs(), **kw)
    ptr = tabs["slot_ptr"]
    L = ((ptr[1:] - ptr[:-1]).double() * A.shape[1]).repeat_interleave(W)
    return hold_to_plain(torch, "window_bwd_gB", label, out, ref, absprod,
                         L[:, None])


def check_bwd_kernels(torch, t, n_panels, W, label, ptr=None, ks=KS):
    """Both backward kernels on one random-table case, at each k; g_A with
    the forward's units of ``ptr`` (and, inside, one-step and derived
    units), and at k = 41 once more with a g that is not 16-byte aligned
    (4-byte copies)."""
    from flex_tpu_torch.ops.window_spmm import FWD_CHUNK_STEPS, device_units

    TM, GW = t["A"].shape[1], t["A"].shape[2]
    n = t["B"].shape[0]
    tabs = bwd_slot_tables(t["win_step"], t["out_panel"], n, W, GW // W)
    units = None if ptr is None else device_units(
        ptr.cpu().numpy(), FWD_CHUNK_STEPS, t["A"].device)
    for k in ks:
        g = torch.rand((n_panels * TM, k), device=t["A"].device) * 2 - 1
        B = t["B"] if k == t["B"].shape[1] else \
            torch.rand((n, k), device=g.device) * 2 - 1
        check_gA_kernel(torch, t["out_panel"], t["win_step"], g, B, TM, W,
                        f"{label} k={k}", units=units)
        if k == 41:
            g_off = torch.empty(g.numel() + 1, device=g.device)[1:].view_as(g)
            g_off.copy_(g)
            check_gA_kernel(torch, t["out_panel"], t["win_step"], g_off, B,
                            TM, W, f"{label} k={k} g misaligned", units=units)
        if tabs is not None:
            check_gB_kernel(torch, tabs, t["out_panel"], t["A"], g, W,
                            f"{label} k={k}")


def check_gA_unit_edges(torch, rng, dev="cuda"):
    """Kernel 2 on the forward's units of panels of 1, 8, 9 and 17 steps
    with an all-sentinel step, n % W != 0, TM 128, 256 and 384 (a block
    takes 256 rows), k = 16, 41, 128 and 200 (a depth beyond the resident
    tile's cap of 128)."""
    from flex_tpu_torch.ops.window_spmm import FWD_CHUNK_STEPS as CS

    steps = np.array([1, CS, CS + 1, 2 * CS + 1])
    for TM in (128, 256, 384):
        t, n_panels, W, ptr = random_window_case(
            torch, rng, steps, 9_000 + 5, dev, TM=TM,
            sentinel_steps=(CS + 4,))
        check_bwd_kernels(torch, t, n_panels, W,
                          f"unit edges TM={TM} S={int(steps.sum())}", ptr,
                          ks=(16, 41, K, 200))
        del t


def check_window_t_kernel(torch, first, out_panel, win_step, A_T, B_T,
                          n_panels, W, ptr, label, units=None):
    """Kernel 4 against its plain version; L = the panel's steps·G·W.
    Launched again, with derived unit tables: the outputs must be
    bit-equal."""
    from flex_tpu_torch.ops.window_spmm import (
        window_spmm_t_fwd, window_spmm_t_fwd_plain,
    )

    args = (first, out_panel, win_step)
    kw = dict(n_panels=n_panels, W=W)
    out = window_spmm_t_fwd(*args, A_T, B_T, panel_step_ptr=ptr, units=units,
                            **kw)
    require_same_bits(torch, "window_spmm_t_fwd", label, out, window_spmm_t_fwd(
        *args, A_T, B_T, panel_step_ptr=ptr, **kw))
    torch.cuda.synchronize()
    ref = window_spmm_t_fwd_plain(*args, A_T, B_T, **kw)
    absprod = window_spmm_t_fwd_plain(*args, A_T.abs(), B_T.abs(), **kw)
    S, GW, TM = A_T.shape
    L = ((ptr[1:] - ptr[:-1]).double() * GW).repeat_interleave(TM)[None, :]
    return hold_to_plain(torch, "window_spmm_t_fwd", label, out, ref,
                         absprod, L)


def check_window_t_unit_edges(torch, rng, dev="cuda"):
    """Kernel 4 on the edges of its work units, as the card tests run it:
    panels of 1, 8, 9 and 17 steps (panel 0's only step and one step in
    each longer panel all sentinels) and two trailing empty panels, both
    panel-row tiles (TM 256 and 128), every tile over k (k = 16, 32, 41,
    64, 100) and a Bᵀ that is not 16-byte aligned."""
    from flex_tpu_torch.ops.window_spmm import FWD_CHUNK_STEPS as CS

    steps = np.array([1, CS, CS + 1, 2 * CS + 1])
    n = 9_000 + 5
    for TM in (256, 128):
        t, n_panels, W, ptr = random_window_case(
            torch, rng, steps, n, dev, TM=TM, sentinel_steps=(0, 3, 12, 30))
        A_T = t["A"].transpose(1, 2).contiguous()
        del t["A"], t["B"]
        for k in (16, 32, 41, 64, 100):
            buf = torch.rand(k * n + 1, device=dev) * 2 - 1
            B_T = buf[1:].view(k, n)                # not 16-byte aligned
            check_window_t_kernel(
                torch, t["first"], t["out_panel"], t["win_step"], A_T, B_T,
                n_panels, W, ptr,
                f"unit edges 1/8/9/17 steps TM={TM} k={k} misaligned B_T")


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
    require_same_bits(torch, "band_spmm_v1", label, out,
                      band_spmm_v1(a[0], ws, B))
    torch.cuda.synchronize()
    e1 = hold_to_plain(
        torch, "band_spmm_v1", label, out, band_spmm_v1_plain(a[0], ws, B),
        band_spmm_v1_plain(a[0].abs(), ws, B.abs()), W)
    return e2, e1


def full_depth(ranges, W):
    """A range table that reads every tile's whole depth [0, 2W)."""
    full = ranges.clone()
    full[..., 0], full[..., 1] = 0, 2 * W
    return full


def check_band_v1_ranges(torch, rng, TM, W, n, k, label, dev="cuda"):
    """Kernel 6 on depth ranges of the unsplit band: an empty tile, a
    narrow range and full ones; launched again, with the table derived
    and on full-depth ranges, the same bits."""
    from flex_tpu_torch.ops.pallas_band import (
        band_depth_ranges, band_spmm_v1, band_spmm_v1_plain,
    )

    band = torch.rand((4, TM, W), device=dev) * 2 - 1
    band[0, :128] = 0
    band[1, :, 40:] = 0
    band[1, :, :8] = 0
    ws = rng.integers(0, -(-n // 128), 4)
    ws[::3] = -(-n // 128) - 1
    ws = torch.from_numpy(ws.astype(np.int32)).to(dev)
    B = torch.rand((n, k), device=dev) * 2 - 1
    ranges = band_depth_ranges(band)
    r = ranges.cpu().numpy()
    if not (tuple(r[0, 0]) == (0, 0) and tuple(r[1, 0]) == (0, 48)):
        raise AssertionError(f"band v1 range case {label}: ranges {r[:2]}")
    out = band_spmm_v1(band, ws, B, ranges=ranges)
    full = ranges.clone()
    full[..., 0], full[..., 1] = 0, W
    for again in (None, full):
        require_same_bits(torch, "band_spmm_v1", label, out,
                          band_spmm_v1(band, ws, B, ranges=again))
    torch.cuda.synchronize()
    return hold_to_plain(
        torch, "band_spmm_v1", label, out, band_spmm_v1_plain(band, ws, B),
        band_spmm_v1_plain(band.abs(), ws, B.abs()), W)


def check_band_v2_ranges(torch, rng, P, TM, W, n, k, label, dev="cuda"):
    """Kernel 5 on depth ranges, as the card tests run it: tiles with an
    empty range, the left half only, the right half only, a narrow range
    inside the right half and the full depth; launched again, with the
    table derived and on a table of full-depth ranges, the same bits (a
    skipped column is a zero of A, whose FMAs add exact zeros)."""
    from flex_tpu_torch.ops.pallas_band import (
        band_depth_ranges, band_spmm_v2, band_spmm_v2_plain,
    )

    a = [torch.rand((P, TM, W), device=dev) * 2 - 1 for _ in range(2)]
    a[0][0, :128] = 0
    a[1][0, :128] = 0
    a[1][1, :128] = 0
    a[0][1, 128:] = 0
    a[0][2] = 0
    a[1][2, :, 40:] = 0
    a[1][2, :, :8] = 0
    iW = rng.integers(0, -(-n // W), P)
    iW[::3] = -(-n // W) - 1
    iW = torch.from_numpy(iW.astype(np.int32)).to(dev)
    B = torch.rand((n, k), device=dev) * 2 - 1
    ranges = band_depth_ranges(*a)
    r = ranges.cpu().numpy()
    if not (tuple(r[0, 0]) == (0, 0) and r[1, 0, 1] <= W
            and r[1, 1, 0] >= W and tuple(r[2, 0]) == (W, W + 48)):
        raise AssertionError(f"band range case {label}: ranges {r[:3]}")
    out = band_spmm_v2(*a, iW, B, ranges=ranges)
    for again in (None, full_depth(ranges, W)):
        require_same_bits(torch, "band_spmm_v2", label, out,
                          band_spmm_v2(*a, iW, B, ranges=again))
    torch.cuda.synchronize()
    return hold_to_plain(
        torch, "band_spmm_v2", label, out, band_spmm_v2_plain(*a, iW, B),
        band_spmm_v2_plain(a[0].abs(), a[1].abs(), iW, B.abs()), 2 * W)


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


def rows_absprod_and_len(torch, t, B):
    """|A|·|B| row by row (the plain version on |vals|, |B|) and each row's
    length L: the rounding bound of two f32 sums of a row in different
    orders is 2·L·eps32·(|A|·|B|)."""
    import dataclasses

    from flex_tpu_torch.ops.gespmm import gespmm_rows_plain

    absprod = gespmm_rows_plain(dataclasses.replace(t, vals=t.vals.abs()),
                                B.abs())
    u = t.units.long()
    L = torch.zeros(t.m, dtype=torch.float64, device=B.device).index_add_(
        0, u[:, 0], (u[:, 2] - u[:, 1]).double())
    return absprod, L[:, None].clamp_min(1)


def check_gespmm_kernel(torch, t, B, label, into=None):
    """Kernel 7 (the row-unit kernel) against its plain version, with
    ``into`` added to when given; launched twice, the same bits.  Returns
    max_abs_err."""
    from flex_tpu_torch.ops.gespmm import gespmm_rows, gespmm_rows_plain

    def call(fn):
        return fn(t, B, into=None if into is None else into.clone())

    out = call(gespmm_rows)
    require_same_bits(torch, "gespmm_rows", label, out, call(gespmm_rows))
    torch.cuda.synchronize()
    absprod, L = rows_absprod_and_len(torch, t, B)
    if into is not None:   # the add into the accumulator rounds once more
        absprod = absprod + into.abs() / L
    return hold_to_plain(torch, "gespmm_rows", label, out,
                         call(gespmm_rows_plain), absprod, L)


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
    k = 128 and k = 41 (and the transposed kernel's own k = 32; kernel 7
    also at k = 200 and on ELL residues with an accumulator)."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.io.synth import banded_graph
    from flex_tpu_torch.ops.ell_spmm import prepare_ell, with_bwd_plan
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
    check_window_t_unit_edges(torch, rng, dev=dev)
    # kernels 5 and 6: TM a multiple of the 128-row tile or not, W = 768
    # (the full-size band's) and 128, n % W != 0
    for P, TM, W in ((40, 256, 768), (9, 200, 128), (5, 8, 256)):
        for k in (K, 41):
            check_band_kernels(torch, rng, P, TM, W, 20_000 + 77, k,
                               f"P={P} TM={TM} W={W} k={k}", dev=dev)
    # kernels 5 and 6 on empty, one-half, narrow and full-depth ranges
    for TM, W in ((256, 768), (200, 256)):
        for k in (32, 41, K, 200):
            check_band_v2_ranges(torch, rng, 5, TM, W, 9_000 + 5, k,
                                 f"ranges TM={TM} W={W} k={k}", dev=dev)
            check_band_v1_ranges(torch, rng, TM, W, 9_000 + 5, k,
                                 f"v1 ranges TM={TM} W={W} k={k}", dev=dev)
    # m % tm != 0 through the plans, against SciPy
    gb = banded_graph(5000, 300, 40.0, seed=3)
    for k in (K, 41):
        Bb = make_features(gb, k)
        gold = spmm_scipy(gb, Bb)
        for impl in ("pallas2", "pallas"):
            check_plan_against_scipy(
                gb, prepare_band(gb, device=dev, tm=256, impl=impl), Bb, gold,
                f"band impl={impl} m=5000 tm=256 k={k}")
    # kernel 7: pad chunks, a zero-degree row, rows longer than a unit
    # (several units and the reduce pass), k within one slice or beyond
    gh = hub_and_empty_graph(rng)
    for w in (32, 7):
        plan = prepare_gespmm(gh, w=w, device=dev)
        if int((plan.chunk_row == gh.m).sum()) == 0 or \
                plan.rows.splits.shape[0] == 0:
            raise AssertionError("the gespmm case has no pad chunk or no "
                                 "split row")
        for k in (K, 41, 200):
            Bh = make_features(gh, k)
            check_gespmm_kernel(torch, plan.rows, torch.from_numpy(Bh).to(dev),
                                f"hub+empty N={plan.cols.shape[0]} w={w} k={k}")
            check_plan_against_scipy(gh, plan, Bh, spmm_scipy(gh, Bh),
                                     f"gespmm w={w} k={k}")
    # kernel 7 on ELL residues, added into an accumulator: all width
    # buckets and split rows, and the transposed plan whose row 0 holds
    # every pad entry
    ell = with_bwd_plan(prepare_ell(gh, device=dev), gh.n)
    for e, what in ((ell, "ell"), (ell.bwd_plan, "transposed ell")):
        for k in (K, 41, 32):
            B = torch.rand((gh.n, k), device=dev) * 2 - 1
            into = torch.rand((e.m, k), device=dev) * 2 - 1
            check_gespmm_kernel(torch, e.rows, B,
                                f"{what} into= k={k} units="
                                f"{e.rows.units.shape[0]} split rows="
                                f"{e.rows.splits.shape[0]}", into=into)


def phase_kernels_vs_plain(torch, dev="cuda"):
    from flex_tpu_torch.ops.window_spmm import (
        FWD_CHUNK_STEPS as CS, GB_CHUNK_SLOTS as CL, work_units,
    )

    rng = np.random.default_rng(0)
    # panels of a single step, exactly one unit, one unit plus one step and
    # eight units, a spread of others, trailing empties; an all-sentinel
    # step inside the long panel; chains of slots of the same four kinds;
    # n % W != 0
    steps = np.concatenate([[1, CS, CS + 1, 8 * CS], rng.integers(1, 24, 60),
                            [1]])
    chains = (1, CL, CL + 1, 8 * CL + 3)
    t, n_panels, W, ptr = random_window_case(
        torch, rng, steps, 50_000 + 37, dev, sentinel_steps=(2 * CS + 5,),
        chains=chains)
    tabs = bwd_slot_tables(t["win_step"], t["out_panel"], 50_037, W, 4)
    got = np.diff(tabs["slot_ptr"].cpu().numpy())[:len(chains)]
    units = work_units(ptr.cpu().numpy(), CS)[0]
    if tuple(got) != chains or int(np.diff(units[:, 1:3]).max()) != CS:
        raise AssertionError(f"the random case has chains {got}, not "
                             f"{chains}, or no full unit")
    label = f"S={int(steps.sum())} panels={n_panels} n=50037"
    check_window_kernel_ks(torch, t, n_panels, W, ptr, label)
    check_bwd_kernels(torch, t, n_panels, W, label, ptr)
    # TM not a multiple of the 128-row tile, W = 64, G = 2
    steps = np.array([3, 2 * CS + 1, 1])
    t, n_panels, W, ptr = random_window_case(
        torch, rng, steps, 3_000 + 5, dev, TM=200, G=2, W=64,
        chains=(CL + 1,))
    label = f"S={int(steps.sum())} TM=200 G=2 W=64 n=3005"
    check_window_kernel_ks(torch, t, n_panels, W, ptr, label)
    check_bwd_kernels(torch, t, n_panels, W, label, ptr)
    # all-sentinel panel and a tiny graph with a single partial block
    steps = np.array([3, 2])
    t, n_panels, W, ptr = random_window_case(torch, rng, steps, 200, dev,
                                             sentinel_frac=0.5)
    t["win_step"][:3 * 4] = -(-200 // W)  # panel 0: every window a sentinel
    check_window_kernel_ks(torch, t, n_panels, W, ptr,
                           "sentinel panel, n=200")
    check_bwd_kernels(torch, t, n_panels, W, "sentinel panel, n=200", ptr)
    check_gA_unit_edges(torch, rng, dev)


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------

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


def longest_panel_ms(torch, plan, B, time_cuda_ms, fwd=None) -> float:
    """The window kernel (``fwd``: the forward, or the transposed forward
    with Bᵀ as ``B``) on the longest panel's steps alone, cut into units as
    in the whole launch: what the card takes for that panel when nothing
    else runs."""
    from flex_tpu_torch.ops.window_spmm import (
        FWD_CHUNK_STEPS, device_units, window_spmm_fwd,
    )

    ptr = plan.panel_step_ptr.long()
    p = int(torch.argmax(ptr[1:] - ptr[:-1]))
    lo, hi = int(ptr[p]), int(ptr[p + 1])
    G = plan.win_step.numel() // plan.A.shape[0]
    one = dict(first=plan.first[lo:hi], out_panel=plan.out_panel[lo:hi] - p,
               win_step=plan.win_step[lo * G:hi * G], A=plan.A[lo:hi], B=B)
    ptr1 = torch.tensor([0, hi - lo], dtype=torch.int32, device=B.device)
    units1 = device_units(np.array([0, hi - lo]), FWD_CHUNK_STEPS, B.device)
    return time_cuda_ms(lambda: (fwd or window_spmm_fwd)(
        *one.values(), n_panels=1, W=plan.W, panel_step_ptr=ptr1,
        units=units1), iters=10)


def units_report(units) -> dict:
    """Counts of a unit table: units, steps (slots) per unit at p50 / p99 /
    max, owners with several units, partial tiles."""
    tab, splits, n_parts = units
    u = tab.cpu().numpy()
    per = u[:, 2] - u[:, 1]
    return {"units": len(u), "per_unit_p50_p99_max":
            [int(np.percentile(per, q)) for q in (50, 99, 100)],
            "split_owners": int(splits.shape[0]), "partial_tiles": n_parts}


def reduce_pass_ms(torch, name, symbol, units, rows, k, n_tiles,
                   time_cuda_ms) -> tuple[float, int]:
    """The pass that adds the partial tiles, alone, on a scratch of the
    launch's size.  Returns (ms, scratch bytes)."""
    from flex_tpu_torch.ops.window_spmm import reduce_partials

    _, splits, n_parts = units
    scratch = torch.rand((n_parts, rows, k), device="cuda")
    out = torch.empty((n_tiles * rows, k), device="cuda")
    ms = time_cuda_ms(reduce_partials, name, symbol, scratch, out, splits,
                      iters=10)
    return ms, scratch.numel() * 4


# What the kernels that owned a whole panel (a whole chain of slots) took
# on these tensors before they were cut into units, on an NVIDIA H100 80GB
# HBM3 at 700 W: printed beside this run's times, not part of the kernels
# line.
WHOLE_OWNER_RECORD_MS = {
    "window_spmm_fwd": {"k128": 20.60, "k41": 20.40, "longest_alone": 15.24},
    "window_bwd_gB": {"k128": 22.79, "k41": 22.02, "longest_alone": 17.35},
    "windowed_t_elap": 27.89, "train_ms_per_step": 108.48,
}


# What kernels 2 and 4 to 7 and the residue took before they were
# redesigned (one block per panel or per tile, loads and FMAs in turn;
# kernels 5 and 6 over the whole depth; kernel 7 as chunk partials with the
# scatter-add outside; the residue in plain torch), on an NVIDIA H100 80GB
# HBM3 at 700 W: printed beside this run's times, not part of the kernels
# line.
REDESIGN_RECORD_MS = {
    "window_bwd_gA": 15.36,
    "window_spmm_t_fwd": {"k41": 11.67, "k32": 8.68},
    "transposed_t_elap": {"k41": 14.15, "k32": 13.18},
    "band_spmm_v2": 2.909, "pallas2_t_elap": 2.909,
    # kernel 6 loading, waiting and multiplying in turn over the whole
    # depth; kernel 7 as chunk partials with index_add_ outside; the
    # residue in plain torch
    "band_spmm_v1": 1.614,
    "gespmm": {"partials_k128": 1.310, "partials_k41": 0.837,
               "plan_k128": 2.168, "plan_k41": 1.118},
    "residue": {"fwd_k128": 6.59, "fwd_k41": 2.78, "bwd_k128": 7.04,
                "bwd_k41": 3.22},
    "windowed_t_elap": 18.30, "train_ms_per_step": 51.22,
}


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


def kernel_usage(source: str, name: str) -> list:
    """Registers and spill bytes that ptxas reported for the entries of
    ``csrc/<source>.cu`` whose mangled name holds ``name`` (empty when the
    library was built by an earlier process)."""
    from flex_tpu_torch import kernels

    out, entry = [], None
    for line in kernels.build_log.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if name in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if entry and m:
            out.append({"entry": entry, "spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if entry and m and out and out[-1]["entry"] == entry:
            out[-1]["registers"] = int(m.group(1))
    return out


def ptxas_summary(usage: list) -> dict:
    """:func:`kernel_usage` keyed by each entry's template arguments."""
    out = {}
    for u in usage:
        m = re.search(r"kernelI(.*?)E+v", u["entry"])
        out[m.group(1) if m else u["entry"]] = (
            f"{u.get('registers')} registers, {u['spill_stores']} bytes "
            f"spill stores, {u['spill_loads']} bytes spill loads")
    return out


def reset_launches():
    """Every count to 0: the package's kernels and the probes' (8-11)."""
    from flex_tpu_torch import kernels
    from flex_tpu_torch.experiments import micro

    kernels.reset_launch_counts()
    micro.reset_launch_counts()


def read_launches() -> dict:
    from flex_tpu_torch import kernels
    from flex_tpu_torch.experiments import micro

    return {**kernels.launch_counts(), **micro.launch_counts()}


def expect_launches(launches: dict, what: str, **counts):
    """The named wrappers launched exactly ``counts``; every other, none."""
    want = {name: counts.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want}")


def phase_gradient(torch, g, plan, B_dev, time_cuda_ms):
    """Phase 6.  Returns (launch counts, g_A's max error against plain, the
    cotangent co, the dense half's share of it, the plan with the training
    backward, its launch counts, the gradient call's times)."""
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
    # the residue's forward is kernel 7; its g_B without a bwd_plan is the
    # plain transposed scatter
    expect_launches(launches, "the gradient path", window_spmm_fwd=1,
                    window_bwd_gA=1, window_bwd_gB=1, gespmm_rows=1)
    check_gB_against_scipy(g, Bg.grad, gold, col_deg, "plan")
    # g_A of the backward against the plain version, on the same cotangent
    g_dense = dense_cotangent(torch, plan, co)
    gA_again, gA_err = check_gA_kernel(
        torch, plan.out_panel, plan.win_step, g_dense, B_dev, plan.tm, plan.W,
        "main path k=128", units=plan.panel_units)
    diff = float((A.grad - gA_again).abs().max())
    if tuple(A.grad.shape) != tuple(plan.A.shape) or not diff <= 1e-5:
        raise AssertionError(f"A.grad differs from the g_A kernel on the "
                             f"backward's own cotangent: max |diff| {diff}")
    log(f"[grad] A.grad vs the g_A kernel on the dense cotangent: max |diff| "
        f"{diff:.3e}")
    del A, gA_again, loss

    # the gradient call, timed: with A's gradient (kernel 2 runs) and with
    # B's alone
    def grad_call(wrt_A):
        Ai = plan.A.detach().requires_grad_(wrt_A)
        Bi = B_dev.clone().requires_grad_()
        (dataclasses.replace(plan, A=Ai)(Bi) * co).sum().backward()

    grad_ms = {wrt: time_cuda_ms(grad_call, wrt, iters=5)
               for wrt in (True, False)}
    log(f"[grad] gradient call (forward + backward): B and A requiring grad "
        f"{grad_ms[True]:.3f} ms, B alone {grad_ms[False]:.3f} ms, "
        f"difference {grad_ms[True] - grad_ms[False]:.3f} ms")

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
    # A is a constant there, so no g_A; kernel 7 runs the residue forward
    # and, on the transposed plan, its g_B
    expect_launches(l2, "the training-backward path", window_spmm_fwd=1,
                    window_bwd_gB=1, gespmm_rows=2)
    check_gB_against_scipy(g, Bg2.grad, gold, col_deg, "with_training_bwd")
    # no unordered sum on this path: a second backward gives the same bits
    Bg3 = B_dev.clone().requires_grad_()
    (tplan(Bg3) * co).sum().backward()
    require_same_bits(torch, "g_B with_training_bwd", "full size", Bg2.grad,
                      Bg3.grad)
    del Bg3
    diff = float((Bg2.grad - Bg.grad).abs().max())
    log(f"[grad] g_B with vs without the transposed residue backward: "
        f"max |diff| {diff:.3e}")
    # the train step's second layer takes its g_B at k = 41 (SciPy sums each
    # column on its own, so gold[:, :41] is the gold of co[:, :41])
    B41 = B_dev[:, :41].clone().requires_grad_()
    (tplan(B41) * co[:, :41]).sum().backward()
    check_gB_against_scipy(g, B41.grad, np.ascontiguousarray(gold[:, :41]),
                           col_deg, "with_training_bwd k=41")
    del B41
    return launches, gA_err, co, g_dense, tplan, l2, grad_ms


def profile_steps(torch, step, args, n=2, tag="train"):
    """``n`` train steps under torch.profiler: the device's busy share of
    the wall time and the kernels by their summed device time (lines
    ``[profile]``, naming ``tag``'s steps)."""
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
    log(f"[profile] {n} {tag} steps: wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_us / wall_us):.4f}")
    for e in rows[:16]:
        log(f"[profile]   {dev_us(e) / 1e3 / n:9.3f} ms/step  x{e.count / n:g}"
            f"  {e.key[:90]}")


def plain_plan(torch, plan):
    """B -> A·B as the plan computes it, with the dense half by the forward
    kernel's plain version and the residue by its plain version, without
    its transposed backward: all tensor ops, so autograd differentiates it
    with no kernel of the package."""
    from flex_tpu_torch.ops.ell_spmm import ell_spmm_plain
    from flex_tpu_torch.ops.window_spmm import window_spmm_fwd_plain

    def call(B):
        out = window_spmm_fwd_plain(
            plan.first, plan.out_panel, plan.win_step, plan.A, B,
            n_panels=plan.n_used_panels, W=plan.W)
        cat = torch.cat([out, out.new_zeros((1, B.shape[1]))])
        dense = cat.index_select(0, plan.row_gather[:plan.m])
        return ell_spmm_plain(plan.ell, B, into=dense)

    if plan.ell.bwd_plan is not None or plan.ell.nnz == 0:
        raise AssertionError("plain_plan wants a residue without bwd_plan")
    return call


def check_first_step_gradients(torch, model, loss_fn, fast, plain, X, y,
                               mask, tag, rel=1e-3):
    """The parameter gradients of the first train step, through the kernels
    (``fast``: the plan or attention graph the step uses), against the same
    loss through ``plain`` (the plain versions, all tensor ops):
    |diff| <= rel · max|plain gradient| elementwise, for each parameter.
    The two differ by f32 sums in another order, through two layers and a
    softmax.  Returns the first step's loss through the kernels."""
    grads, losses = [], []
    for p in (fast, plain):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, p, X, y, mask)
        loss.backward()
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()})
        losses.append(float(loss.detach()))
        del loss
    model.zero_grad(set_to_none=True)
    worst = {}
    for n, ref in grads[1].items():
        scale = float(ref.abs().max())
        diff = float((grads[0][n] - ref).abs().max())
        worst[n] = diff / scale if scale else float("inf")
        if not bool(grads[0][n].isfinite().all()) or not worst[n] <= rel:
            raise AssertionError(f"[{tag}] first step's {n}.grad differs "
                                 f"from the plain versions': max |diff| "
                                 f"{diff:.3e} over max |ref| {scale:.3e}")
    log(f"[{tag}] first step's loss {losses[0]:.8f} (plain {losses[1]:.8f}); "
        f"gradients vs plain versions, max |diff| / max |ref|: {worst} "
        f"(limit {rel}) ok")
    return losses[0]


def node_labels(torch, m, n_cls):
    """The train phases' labels and mask: seeded labels, every node
    labelled."""
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.integers(0, n_cls, m)).cuda(),
            torch.ones(m, device="cuda"))


def timed_steps(torch, step, args, n):
    """``n`` train steps, each bracketed by CUDA events.  Returns (losses,
    per-step device ms, host ms per step)."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    t0 = time.perf_counter()
    for i in range(n):
        ev[i].record()
        losses.append(step(*args))
    ev[n].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    return losses, [ev[i].elapsed_time(ev[i + 1]) for i in range(n)], host_ms


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
    y, mask = node_labels(torch, g.m, n_cls)
    model = GCN(d_in, d_hid, n_cls, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0)).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, plan, opt)  # attaches the training bwd
    check_first_step_gradients(torch, model, gcn_loss, tplan,
                               plain_plan(torch, plan), X, y, mask, "train")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [step(X, y, mask) for _ in range(2)]            # warm-up
    timed, step_ms, host_ms = timed_steps(torch, step, (X, y, mask), 5)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses + timed]
    with torch.no_grad():
        after = float(gcn_loss(model, plan, X, y, mask))
    log(f"[train] losses {[round(x, 6) for x in losses]} then {after:.6f}")
    # 2 forward and 2 g_B per step, and no g_A; kernel 7 runs the residue
    # of each forward and of each g_B
    expect_launches(launches, "7 train steps", window_spmm_fwd=14,
                    window_bwd_gB=14, gespmm_rows=28)
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
                                      n_blk_used=plan.n_blk_used,
                                      units=plan.slot_units), iters=5)
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


def phase_bwd_kernels(torch, g, plan, B_dev, co, g_dense, gA_err, grad_ms,
                      launches_grad, launches_train, peaks, time_cuda_ms):
    """Phase 8: the two backward kernels on the main path's tensors.
    Returns their rows of the kernels line."""
    from flex_tpu_torch.ops.window_spmm import (
        FWD_CHUNK_STEPS, GB_CHUNK_SLOTS, _padded, _window_rows, device_units,
        window_bwd_gA, window_bwd_gA_plain, window_bwd_gB, window_bwd_gB_plain,
    )

    n_win, _, n_flops = window_bytes_flops(plan, K)
    S, TM, GW = plan.A.shape
    W = plan.W
    ts, tg, rows = plan.bwd_tabs
    tabs = {"slot_s": ts, "slot_g": tg, "slot_ptr": plan.slot_ptr,
            "n_blk_used": plan.n_blk_used, "units": plan.slot_units}
    tables_bytes = 4 * (plan.win_step.numel() + plan.out_panel.numel())

    # kernel 2: reads g and B once, writes every tile of g_A (sentinels too);
    # the forward's units (one block per unit and 128-row tile) and the step
    # grain (one block per step and 128-row tile) at k = 128 and 41
    gA_args = (plan.out_panel, plan.win_step)
    gd41 = g_dense[:, :41].contiguous()
    B41 = B_dev[:, :41].contiguous()
    steps1 = step_units(S, "cuda")
    gA_call = lambda gd, b, units: window_bwd_gA(  # noqa: E731
        *gA_args, gd, b, TM=TM, W=W, units=units)
    _, gA_err_41 = check_gA_kernel(torch, *gA_args, gd41, B41, TM, W,
                                   "main path k=41", units=plan.panel_units)
    gA_ms = time_cuda_ms(gA_call, g_dense, B_dev, plan.panel_units, iters=10)
    gA_ms_41 = time_cuda_ms(gA_call, gd41, B41, plan.panel_units, iters=10)
    gA_steps_ms = time_cuda_ms(gA_call, g_dense, B_dev, steps1, iters=10)
    gA_steps_ms_41 = time_cuda_ms(gA_call, gd41, B41, steps1, iters=10)
    gA_plain_ms = time_cuda_ms(
        lambda: window_bwd_gA_plain(*gA_args, g_dense, B_dev, TM=TM, W=W),
        iters=3, warmup=1)
    units_bytes = 4 * plan.panel_units[0].numel()
    gA_bound, gA_by = bound(
        (g_dense.numel() + B_dev.numel() + plan.A.numel()) * 4
        + tables_bytes + units_bytes, n_flops, peaks)
    gA_bytes_41 = (gd41.numel() + B41.numel() + plan.A.numel()) * 4 \
        + tables_bytes + units_bytes
    gA_bound_41, gA_by_41 = bound(gA_bytes_41, n_flops * 41 / K, peaks)
    # the library yardstick: the plain version's one bmm (cuBLAS SGEMM, TF32
    # off) on operands gathered beforehand, and the two gathers apart
    gather_g = lambda gd: gd.view(-1, TM, gd.shape[1])[  # noqa: E731
        plan.out_panel.long()]
    gather_B = lambda b: _padded(b, W)[  # noqa: E731
        _window_rows(plan.win_step, W, b.device).view(S, -1)]
    lib = {}
    for kk, gd, b in ((K, g_dense, B_dev), (41, gd41, B41)):
        g_p, Bw = gather_g(gd), gather_B(b)
        out = torch.empty((S, TM, GW), device="cuda")
        lib[kk] = {
            "bmm_ms": time_cuda_ms(lambda: torch.bmm(
                g_p, Bw.transpose(1, 2), out=out), iters=5),
            "gather_g_ms": time_cuda_ms(gather_g, gd, iters=5),
            "gather_B_ms": time_cuda_ms(gather_B, b, iters=5)}
        del g_p, Bw, out
    usage = kernel_usage("window_spmm_bwd", "window_bwd_gA")
    log(f"[kernels] window_bwd_gA: real windows {n_win}, "
        f"{n_flops / 1e12:.4f} TFLOP, {n_flops / (gA_ms * 1e-3) / 1e12:.2f} "
        f"TFLOP/s achieved; units of at most {FWD_CHUNK_STEPS} steps "
        f"{plan.panel_units[0].shape[0]}: {gA_ms:.3f} ms, k=41 "
        f"{gA_ms_41:.3f} ms (bound {gA_bound_41:.3f} ms, {gA_by_41}); one "
        f"step a block {S}: {gA_steps_ms:.3f} ms, k=41 {gA_steps_ms_41:.3f} "
        f"ms; library bmm alone on gathered operands {lib[K]['bmm_ms']:.3f} "
        f"ms (k=41 {lib[41]['bmm_ms']:.3f}), gathers of g "
        f"{lib[K]['gather_g_ms']:.3f} and of B {lib[K]['gather_B_ms']:.3f} "
        f"ms (k=41 {lib[41]['gather_g_ms']:.3f}, "
        f"{lib[41]['gather_B_ms']:.3f}); plain {gA_plain_ms:.3f} ms; "
        f"ptxas {usage}; the kernel took "
        f"{REDESIGN_RECORD_MS['window_bwd_gA']} ms before its redesign")

    # kernel 3: reads the real windows of A and g once, writes the compact out
    gB_err = check_gB_kernel(torch, tabs, plan.out_panel, plan.A, g_dense, W,
                             "main path k=128")
    # the train step's second layer calls it at k = 41
    gB_err_41 = check_gB_kernel(torch, tabs, plan.out_panel, plan.A, gd41, W,
                                "main path k=41")
    gB_call = lambda gd=g_dense, units=plan.slot_units: window_bwd_gB(  # noqa: E731
        ts, tg, plan.slot_ptr, plan.out_panel, plan.A, gd, W=W,
        n_blk_used=plan.n_blk_used, units=units)
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
    # one unit per rank: the same kernel with a block behind every whole chain
    whole = device_units(plan.slot_ptr.cpu().numpy(), 1 << 30, "cuda")
    gB_whole_ms = time_cuda_ms(gB_call, g_dense, whole, iters=5)
    # the longest chain of slots alone, cut into units as in the whole launch
    ptr = plan.slot_ptr.long()
    r = int(torch.argmax(ptr[1:] - ptr[:-1]))
    lo, hi = int(ptr[r]), int(ptr[r + 1])
    ptr1 = torch.tensor([0, hi - lo], dtype=torch.int32, device="cuda")
    units1 = device_units(np.array([0, hi - lo]), GB_CHUNK_SLOTS, "cuda")
    longest_ms = time_cuda_ms(lambda: window_bwd_gB(
        ts[lo:hi], tg[lo:hi], ptr1, plan.out_panel, plan.A, g_dense, W=W,
        n_blk_used=1, units=units1), iters=10)
    rep = units_report(plan.slot_units)
    reduce_ms, scratch_bytes = reduce_pass_ms(
        torch, "window_spmm_bwd", "flex_window_bwd_gB_reduce",
        plan.slot_units, W, K, plan.n_blk_used, time_cuda_ms)
    log(f"[kernels] window_bwd_gB: {plan.n_blk_used} blocks, slots per "
        f"block p50/p99/max {slots_percentiles(plan)}; {rep['units']} units "
        f"of at most {GB_CHUNK_SLOTS} slots, slots per unit p50/p99/max "
        f"{rep['per_unit_p50_p99_max']}, {rep['split_owners']} blocks split, "
        f"{rep['partial_tiles']} partial tiles = {scratch_bytes} scratch "
        f"bytes at k={K}, reduce pass alone {reduce_ms:.3f} ms; longest "
        f"block alone {longest_ms:.3f} ms; one unit per block "
        f"{gB_whole_ms:.3f} ms; k=41 {gB_ms_41:.3f} ms; "
        f"{n_flops / 1e12:.4f} TFLOP, {gB_bytes / 1e9:.3f} GB, "
        f"{n_flops / (gB_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; the "
        f"whole-chain kernel's record: {WHOLE_OWNER_RECORD_MS['window_bwd_gB']}")

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
        "bound_by": gA_by, "library_ms": lib[K]["bmm_ms"],
        "ms_k41": gA_ms_41, "max_abs_err_k41": gA_err_41,
        "bound_ms_k41": gA_bound_41, "bound_by_k41": gA_by_41,
        "library_ms_k41": lib[41]["bmm_ms"],
        "gather_g_ms": lib[K]["gather_g_ms"],
        "gather_B_ms": lib[K]["gather_B_ms"],
        "ms_one_step_per_block": gA_steps_ms,
        "ms_one_step_per_block_k41": gA_steps_ms_41,
        "units": int(plan.panel_units[0].shape[0]),
        "grad_call_ms": grad_ms[True], "grad_call_B_only_ms": grad_ms[False],
        "ptxas": usage,
    }, {
        "name": "window_bwd_gB", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/window_spmm.py:882",
        "launches": launches_train["window_bwd_gB"], "max_abs_err": gB_err,
        "ms": gB_ms, "plain_ms": gB_plain_ms, "bound_ms": gB_bound,
        "bound_by": gB_by, "library_ms": gB_library_ms,
        "ms_k41": gB_ms_41, "max_abs_err_k41": gB_err_41,
        "longest_block_ms": longest_ms, "reduce_ms": reduce_ms,
        "ms_one_unit_per_block": gB_whole_ms, "scratch_bytes": scratch_bytes,
        "units": rep["units"],
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


def bench_plan(bench_spmm, g, k, method, **kw):
    """``bench_spmm`` with the plan kept (``prepare=`` keeps it), without
    the serial chain and the traced call, whose calls would add launches
    to the counts.  Returns (the result's numbers, the plan)."""
    from types import SimpleNamespace

    from flex_tpu_torch.ops import prepare_fn

    kept = []

    def prepare(g_, **prep_kwargs):
        kept.append(prepare_fn(method)(g_, **prep_kwargs))
        return kept[-1]

    r = bench_spmm(g, k, method, prepare=prepare, chain=False, trace=False,
                   **kw)
    return SimpleNamespace(
        t_pre_s=r.t_pre, t_elap_ms=r.t_elap * 1e3, gflops=r.gflops,
        pre_elap_ratio=r.pre_ratio,
        err_frac=r.check.err_frac if r.check else None), kept[-1]


def bench_checked(bench_spmm, g, k, method, label, **kw):
    """``bench_spmm`` with err_frac held to 1e-4.  Returns (result, plan)."""
    r, plan = bench_plan(bench_spmm, g, k, method, **kw)
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
        FWD_CHUNK_STEPS, device_units, reduce_partials_t, window_spmm_t_fwd,
        window_spmm_t_fwd_plain,
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
    expect_launches(launches, "the transposed path", window_spmm_t_fwd=28,
                    gespmm_rows=28)
    peak = torch.cuda.max_memory_allocated()
    if not plan_t.transposed or plan_t.bwd_tabs is not None:
        raise AssertionError("the transposed plan is not one")

    out = {}
    kw = dict(n_panels=plan_t.n_used_panels, W=plan_t.W,
              panel_step_ptr=plan_t.panel_step_ptr)
    plain_kw = dict(n_panels=plan_t.n_used_panels, W=plan_t.W)
    tabs = (plan_t.first, plan_t.out_panel, plan_t.win_step)
    for k in (41, 32):
        B_dev = torch.from_numpy(np.ascontiguousarray(B[:, :k])).cuda()
        B_T = B_dev.t().contiguous()
        err = check_window_t_kernel(
            torch, *tabs, plan_t.A, B_T, plan_t.n_used_panels, plan_t.W,
            plan_t.panel_step_ptr, f"main path k={k}",
            units=plan_t.panel_units)
        t_call = lambda B_T=B_T, units=plan_t.panel_units: window_spmm_t_fwd(  # noqa: E731
            *tabs, plan_t.A, B_T, units=units, **kw)
        ms = time_cuda_ms(t_call, iters=10)
        plain_ms = time_cuda_ms(lambda: window_spmm_t_fwd_plain(
            *tabs, plan_t.A, B_T, **plain_kw), iters=5)
        n_win, n_bytes, n_flops = window_bytes_flops(plan_t, k)
        bound_ms, bound_by = bound(n_bytes, n_flops, peaks)
        out[k] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by,
                      dense_half_ms=time_cuda_ms(plan_t.dense_half, B_dev,
                                                 iters=10),
                      kernel1_ms=time_cuda_ms(plan.dense_half, B_dev,
                                              iters=10),
                      row_major_t_elap_ms=time_cuda_ms(plan, B_dev, iters=10))
        # one unit per panel: the same kernel with a block behind every
        # whole panel; the longest panel alone; the reduce pass alone on a
        # scratch of the launch's size
        whole = device_units(plan_t.panel_step_ptr.cpu().numpy(), 1 << 30,
                             "cuda")
        out[k]["ms_one_unit_per_panel"] = time_cuda_ms(t_call, B_T, whole,
                                                       iters=5)
        out[k]["longest_panel_ms"] = longest_panel_ms(
            torch, plan_t, B_T, time_cuda_ms, fwd=window_spmm_t_fwd)
        _, splits, n_parts = plan_t.panel_units
        scratch = torch.rand((n_parts, k, plan_t.tm), device="cuda")
        C_T = torch.empty((k, plan_t.n_used_panels * plan_t.tm),
                          device="cuda")
        out[k]["reduce_ms"] = time_cuda_ms(
            reduce_partials_t, scratch, C_T, splits, plan_t.n_used_panels,
            iters=10)
        out[k]["scratch_bytes"] = scratch.numel() * 4
        del scratch, C_T
        rep = units_report(plan_t.panel_units)
        rec = REDESIGN_RECORD_MS
        log(f"[kernels] window_spmm_t_fwd k={k}: {ms:.3f} ms "
            f"({n_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{n_bytes / (ms * 1e-3) / 1e9:.0f} GB/s), with the two "
            f"transposes {out[k]['dense_half_ms']:.3f} ms; kernel 1 at the "
            f"same k {out[k]['kernel1_ms']:.3f} ms; plan {res[k].t_elap_ms:.3f}"
            f" ms against the row-major plan's "
            f"{out[k]['row_major_t_elap_ms']:.3f} ms; {rep['units']} units "
            f"of at most {FWD_CHUNK_STEPS} steps, steps per unit p50/p99/max "
            f"{rep['per_unit_p50_p99_max']}, {rep['split_owners']} panels "
            f"split, {rep['partial_tiles']} partial tiles = "
            f"{out[k]['scratch_bytes']} scratch bytes, reduce pass alone "
            f"{out[k]['reduce_ms']:.3f} ms; longest panel alone "
            f"{out[k]['longest_panel_ms']:.3f} ms; one unit per panel "
            f"{out[k]['ms_one_unit_per_panel']:.3f} ms; the whole-panel "
            f"kernel's record {rec['window_spmm_t_fwd'][f'k{k}']} ms, its "
            f"plan's {rec['transposed_t_elap'][f'k{k}']} ms")
        if k == 41:
            # the library yardstick kernel 1 has: the same tiles as BSR
            A_bsr = window_as_bsr(torch, plan)
            B_pad = B_dev.new_zeros((A_bsr.shape[1], k))
            B_pad[:g.n] = B_dev
            C_T = t_call()
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
        "units": units_report(plan_t.panel_units), "k41": out[41],
        "k32": out[32], "t_elap_ms": {k: res[k].t_elap_ms for k in res}}))
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
        "longest_panel_ms": o["longest_panel_ms"], "reduce_ms": o["reduce_ms"],
        "ms_one_unit_per_panel": o["ms_one_unit_per_panel"],
        "scratch_bytes": o["scratch_bytes"],
        "units": units_report(plan_t.panel_units)["units"],
    }


def rows_report(t) -> dict:
    """Counts of a row-unit table: units, nonzeros per unit at p50 / p99 /
    max, split rows, partial rows, the longest row."""
    u = t.units.cpu().numpy().astype(np.int64)
    per = u[:, 2] - u[:, 1]
    row_len = np.bincount(u[:, 0], weights=per, minlength=t.m)
    return {"units": len(u), "nnz_per_unit_p50_p99_max":
            [int(np.percentile(per, q)) for q in (50, 99, 100)],
            "split_rows": int(t.splits.shape[0]), "partial_rows": t.n_parts,
            "longest_row": int(row_len.max(initial=0))}


def retile_rows(torch, t, chunk):
    """The same row-unit table cut into units of at most ``chunk``
    nonzeros (a huge ``chunk``: one unit per row), for timing the choice
    of ROW_UNIT_ENTRIES."""
    import dataclasses

    from flex_tpu_torch.ops.units import row_units

    u = t.units.cpu().numpy().astype(np.int64)
    row_len = np.bincount(u[:, 0], weights=u[:, 2] - u[:, 1],
                          minlength=t.m).astype(np.int64)
    units, splits = row_units(row_len, chunk)
    dev = t.units.device
    return dataclasses.replace(
        t, units=torch.from_numpy(units).to(dev),
        splits=torch.from_numpy(splits).to(dev),
        n_parts=int((units[:, 3] >= 0).sum()))


def pass_ms(torch, t, B, time_cuda_ms, into=None) -> dict:
    """Kernel 7's two passes apart: the units alone (no split row summed)
    and the pass over split rows alone (on a scratch left as it is; only
    its time is read)."""
    import dataclasses

    from flex_tpu_torch.ops.gespmm import gespmm_rows

    units_only = dataclasses.replace(t, splits=t.splits[:0])
    reduce_only = dataclasses.replace(t, units=t.units[:0])
    return {p: time_cuda_ms(lambda: gespmm_rows(tab, B, into=into), iters=10)
            for p, tab in (("units_ms", units_only),
                           ("reduce_ms", reduce_only))}


def unit_size_ms(torch, t, B, time_cuda_ms, into=None) -> dict:
    """Kernel 7 on the same rows with units of 64, 128, 512 and 1024
    nonzeros and with one unit per row, beside ROW_UNIT_ENTRIES."""
    from flex_tpu_torch.ops.gespmm import gespmm_rows

    out = {}
    for chunk in (64, 128, 512, 1024, 1 << 30):
        tc = retile_rows(torch, t, chunk)
        out["one_per_row" if chunk == 1 << 30 else str(chunk)] = \
            time_cuda_ms(lambda: gespmm_rows(tc, B, into=into), iters=10)
        del tc
    return out


def rows_bytes(t, nnz, n_in, n_out):
    """Bytes a row-unit product must move: the nonzeros' cols and vals
    once, the row and unit tables, ``n_in`` floats of input (the rows of B
    that the nonzeros name, and an accumulator that is read) and ``n_out``
    floats of output."""
    return (nnz * 8 + 4 * (t.row_start.numel() + t.units.numel()
                           + t.splits.numel()) + 4 * (n_in + n_out))


def distinct_cols(torch, t):
    """How many distinct columns a row-unit table's nonzeros name: the rows
    of B its product must read at least once."""
    from flex_tpu_torch.ops.gespmm import unit_entries

    _, idx = unit_entries(t)
    return int(torch.unique(t.cols[idx]).numel())


def phase_gespmm(torch, g, dev, B, gold, A_csr, peaks, bench_spmm,
                 time_cuda_ms):
    """GE-SpMM at full size on the main path's graph, w = 32, k = 128 and
    41: the plan is kernel 7 alone.  Returns kernel 7's row."""
    from flex_tpu_torch.ops.gespmm import gespmm_rows, gespmm_rows_plain

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
    expect_launches(launches, "the GE-SpMM path", gespmm_rows=28)
    st = plan.stats
    t = plan.rows
    rep = rows_report(t)
    b_rows = distinct_cols(torch, t)
    out = {}
    for k in (K, 41):
        B_dev = torch.from_numpy(np.ascontiguousarray(B[:, :k])).cuda()
        err = check_gespmm_kernel(torch, t, B_dev, f"GE-SpMM main path k={k}")
        require_same_bits(torch, "the GE-SpMM plan", f"k={k}", plan(B_dev),
                          plan(B_dev))
        ms = time_cuda_ms(gespmm_rows, t, B_dev, iters=10)
        plain_ms = time_cuda_ms(gespmm_rows_plain, t, B_dev, iters=3,
                                warmup=1)
        # each input once (the nonzeros' cols and vals, the tables, the rows
        # of B they name), C written once; the operations this graph needs,
        # pads not counted
        n_bytes = rows_bytes(t, g.nnz, b_rows * k, g.m * k)
        bound_ms, bound_by = bound(n_bytes, 2.0 * g.nnz * k, peaks)
        library_ms = time_cuda_ms(torch.sparse.mm, A_csr, B_dev, iters=20)
        out[k] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms,
                      t_elap_ms=res[k].t_elap_ms,
                      scratch_bytes=t.n_parts * k * 4,
                      ms_by_unit_size=unit_size_ms(torch, t, B_dev,
                                                   time_cuda_ms),
                      **pass_ms(torch, t, B_dev, time_cuda_ms))
        rec = REDESIGN_RECORD_MS["gespmm"]
        log(f"[kernels] gespmm_rows k={k}: {ms:.3f} ms "
            f"({2.0 * g.nnz * k / (ms * 1e-3) / 1e9:.0f} GF/s; B rows read "
            f"{g.nnz * k * 4 / (ms * 1e-3) / 1e9:.0f} GB/s), plan "
            f"{res[k].t_elap_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}), library CSR {library_ms:.3f} ms; {rep}; the "
            f"chunk kernel's record {rec[f'partials_k{k}']} ms, its plan "
            f"with the scatter-add {rec[f'plan_k{k}']} ms")
    log("[gespmm] " + json.dumps({"stats": st, "rows": rep, "k128": out[K],
                                  "k41": out[41],
                                  "launches": launches["gespmm_rows"]}))
    o = out[K]
    return {
        "name": "gespmm_rows", "route": "cuda",
        "source": "flex_tpu_torch/csrc/gespmm.cu",
        "replaces": "flex_tpu/ops/gespmm.py:78",
        "launches": launches["gespmm_rows"], "max_abs_err": o["err"],
        "ms": o["ms"], "plain_ms": o["plain_ms"], "bound_ms": o["bound_ms"],
        "bound_by": o["bound_by"], "library_ms": o["library_ms"],
        "plan_ms": o["t_elap_ms"], "ms_k41": out[41]["ms"],
        "plan_ms_k41": out[41]["t_elap_ms"],
        "plain_ms_k41": out[41]["plain_ms"],
        "bound_ms_k41": out[41]["bound_ms"],
        "library_ms_k41": out[41]["library_ms"],
        "max_abs_err_k41": out[41]["err"], "units": rep["units"],
        "split_rows": rep["split_rows"], "scratch_bytes": o["scratch_bytes"],
    }


def residue_csr(torch, t, n):
    """The real entries of a row-unit table as a CSR tensor on the card:
    the operand of the yardstick ``torch.sparse.mm``, used nowhere in the
    package."""
    from flex_tpu_torch.ops.gespmm import unit_entries

    rows, idx = unit_entries(t)
    crow = torch.zeros(t.m + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=t.m), 0)
    return torch.sparse_csr_tensor(crow, t.cols[idx].long(), t.vals[idx],
                                   size=(t.m, n))


def phase_residue(torch, plan, tplan, peaks, time_cuda_ms):
    """The residue alone at full size (the main path's ELL part, 4.4 M
    nonzeros of reddit_posts rbdeg) at k = 128, 41 and 32: kernel 7 added
    into an accumulator as the windowed call does, against its plain
    version, twice for the same bits, timed beside its plain version and
    cuSPARSE on the residue's CSR; the transposed residue (g_B under
    ``with_training_bwd``) with its pad entries, as the JAX package builds
    it, and without them, beside cuSPARSE on the transposed CSR.  Returns
    the numbers for kernel 7's row.  ``with_training_bwd`` builds the
    transposed residue without its pad entries (the measured faster one);
    the one with them is built here."""
    import scipy.sparse as sp

    from flex_tpu_torch.ops.ell_spmm import (
        ell_spmm_plain, prepare_ell_transpose,
    )

    ell, nopad = plan.ell, tplan.ell.bwd_plan
    m, n, nnz = plan.m, plan.n, ell.nnz
    t0 = time.perf_counter()
    bwd = prepare_ell_transpose(ell, n)
    torch.cuda.synchronize()
    pads_s = time.perf_counter() - t0
    if nopad.nnz != nnz or bwd.nnz != ell.padded_nnz:
        raise AssertionError(f"transposed residues of {nopad.nnz} and "
                             f"{bwd.nnz} entries, expected {nnz} and "
                             f"{ell.padded_nnz}")
    A_res = residue_csr(torch, ell.rows, n)
    At = sp.csr_matrix((A_res.values().cpu().numpy(),
                        A_res.col_indices().cpu().numpy(),
                        A_res.crow_indices().cpu().numpy()),
                       shape=(m, n)).T.tocsr()
    A_res_T = torch.sparse_csr_tensor(
        torch.from_numpy(At.indptr.astype(np.int64)).cuda(),
        torch.from_numpy(At.indices.astype(np.int64)).cuda(),
        torch.from_numpy(At.data.astype(np.float32)).cuda(), size=At.shape)
    del At
    reps = {"forward": rows_report(ell.rows), "transposed": rows_report(
        nopad.rows), "transposed_with_pads": rows_report(bwd.rows)}
    b_rows, g_rows = distinct_cols(torch, ell.rows), distinct_cols(
        torch, nopad.rows)
    out = {}
    for k in (K, 41, 32):
        B = torch.rand((n, k), device="cuda") * 2 - 1
        acc = torch.rand((m, k), device="cuda") * 2 - 1
        err = check_gespmm_kernel(torch, ell.rows, B,
                                  f"residue into= k={k}", into=acc)
        fwd_ms = time_cuda_ms(lambda: ell(B, into=acc), iters=20)
        plain_ms = time_cuda_ms(lambda: ell_spmm_plain(ell, B, into=acc),
                                iters=3, warmup=1)
        lib_ms = time_cuda_ms(torch.sparse.mm, A_res, B, iters=20)
        b_ms, b_by = bound(rows_bytes(ell.rows, nnz, b_rows * k + m * k,
                                      m * k),
                           2.0 * nnz * k, peaks)
        gk = torch.rand((m, k), device="cuda") * 2 - 1
        bwd_err = check_gespmm_kernel(torch, nopad.rows, gk,
                                      f"transposed residue k={k}")
        check_gespmm_kernel(torch, bwd.rows, gk,
                            f"transposed residue with its pads k={k}")
        g1, g2 = bwd(gk), nopad(gk)
        pads_diff = float((g1 - g2).abs().max())
        del g1, g2
        bwd_ms = time_cuda_ms(bwd, gk, iters=20)
        nopad_ms = time_cuda_ms(nopad, gk, iters=20)
        by_unit = {} if k != K else {
            "forward": unit_size_ms(torch, ell.rows, B, time_cuda_ms,
                                    into=acc),
            "transposed_with_pads": unit_size_ms(torch, bwd.rows, gk,
                                                 time_cuda_ms),
            "forward_passes": pass_ms(torch, ell.rows, B, time_cuda_ms,
                                      into=acc)}
        bwd_plain_ms = time_cuda_ms(ell_spmm_plain, nopad, gk, iters=3,
                                    warmup=1)
        bwd_lib_ms = time_cuda_ms(torch.sparse.mm, A_res_T, gk, iters=20)
        # the function needs the real nonzeros only: the pads add zeros
        bb_ms, bb_by = bound(rows_bytes(nopad.rows, nnz, g_rows * k, n * k),
                             2.0 * nnz * k, peaks)
        out[k] = {"err": err, "ms": fwd_ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "bwd_err": bwd_err, "bwd_ms": nopad_ms,
                  "bwd_with_pads_ms": bwd_ms,
                  "bwd_plain_ms": bwd_plain_ms, "bwd_library_ms": bwd_lib_ms,
                  "bwd_bound_ms": bb_ms, "bwd_bound_by": bb_by,
                  "bwd_with_vs_without_pads_max_diff": pads_diff,
                  "ms_by_unit_size": by_unit}
        rec = REDESIGN_RECORD_MS["residue"]
        log(f"[kernels] residue k={k}: forward {fwd_ms:.3f} ms (plain "
            f"{plain_ms:.3f}, cuSPARSE {lib_ms:.3f}, bound {b_ms:.3f} "
            f"{b_by}); transposed {nopad_ms:.3f} ms, with the pad entries "
            f"{bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}, cuSPARSE "
            f"{bwd_lib_ms:.3f}, bound {bb_ms:.3f} {bb_by}); the plain "
            f"residue's record: forward {rec.get(f'fwd_k{k}')} ms, transposed "
            f"{rec.get(f'bwd_k{k}')} ms")
        del B, acc, gk
    log("[residue] " + json.dumps({
        "nnz": nnz, "padded_nnz": ell.padded_nnz,
        "transposed_nnz_with_pads": bwd.nnz, "transposed_with_pads_row0_len":
        reps["transposed_with_pads"]["longest_row"],
        "build_with_pads_s": pads_s,
        "rows": reps, "k128": out[K], "k41": out[41], "k32": out[32]}))
    del bwd, A_res, A_res_T
    return out


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
        band_depth_ranges, band_spmm_v1, band_spmm_v1_plain, band_spmm_v2,
        band_spmm_v2_plain,
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

    # the depth ranges of kernels 5 and 6: their build (part of tPre), the
    # share of the depth they read, the empty tiles
    def range_stats(ranges, depth):
        r = ranges.long().cpu().numpy()
        width = r[..., 1] - r[..., 0]
        rows = np.minimum(128, TM - 128 * np.arange(r.shape[1]))[None, :]
        elems = float((width * rows).sum())
        return elems, r.size, {
            "tiles": int(width.size), "empty_tiles": int((width == 0).sum()),
            "depth_share_read": elems / (P * TM * depth),
            "range_p50_max": [int(np.percentile(width, 50)),
                              int(width.max())], "depth": depth}

    ranged_elems, r_size, range_stats2 = range_stats(p2.ranges, 2 * W)
    range_stats2["table_build_ms"] = time_cuda_ms(band_depth_ranges, *p2.band,
                                                  iters=5)
    ranged1, r1_size, range_stats1 = range_stats(p1.ranges, W)
    range_stats1["table_build_ms"] = time_cuda_ms(band_depth_ranges, p1.band,
                                                  iters=5)
    log(f"[band] depth ranges: split {json.dumps(range_stats2)}; unsplit "
        f"{json.dumps(range_stats1)}")

    B_dev = torch.from_numpy(B).cuda()
    A_csr = csr_tensor(torch, g)
    library_ms = time_cuda_ms(torch.sparse.mm, A_csr, B_dev, iters=20)
    del A_csr

    v2 = lambda ranges=p2.ranges: band_spmm_v2(  # noqa: E731
        *p2.band, p2.ws, B_dev, ranges=ranges)
    v1 = lambda ranges=p1.ranges: band_spmm_v1(  # noqa: E731
        p1.band, p1.ws, B_dev, ranges=ranges)
    full2, full1 = full_depth(p2.ranges, W), p1.ranges.clone()
    full1[..., 0], full1[..., 1] = 0, W
    out2 = v2()
    require_same_bits(torch, "band_spmm_v2", "full-size band, full-depth "
                      "ranges", out2, v2(full2))
    torch.cuda.synchronize()
    e2 = hold_to_plain(
        torch, "band_spmm_v2", "full-size band k=128", out2,
        band_spmm_v2_plain(*p2.band, p2.ws, B_dev),
        band_spmm_v2_plain(p2.band[0].abs(), p2.band[1].abs(), p2.ws,
                           B_dev.abs()), 2 * W)
    out1 = v1()
    require_same_bits(torch, "band_spmm_v1", "full-size band, full-depth "
                      "ranges", out1, v1(full1))
    torch.cuda.synchronize()
    e1 = hold_to_plain(
        torch, "band_spmm_v1", "full-size band k=128", out1,
        band_spmm_v1_plain(p1.band, p1.ws, B_dev),
        band_spmm_v1_plain(p1.band.abs(), p1.ws, B_dev.abs()), W)
    del out1, out2
    ms2 = time_cuda_ms(v2, iters=10)
    ms2_full = time_cuda_ms(v2, full2, iters=10)
    ms1 = time_cuda_ms(v1, iters=10)
    ms1_full = time_cuda_ms(v1, full1, iters=10)
    plain2 = time_cuda_ms(band_spmm_v2_plain, *p2.band, p2.ws, B_dev, iters=5)
    plain1 = time_cuda_ms(band_spmm_v1_plain, p1.band, p1.ws, B_dev, iters=5)
    io_bytes = (B_dev.numel() + P * TM * K) * 4 + P * 4
    # each kernel is bounded by what its ranges need; the format's bound
    # (every tile's whole depth) is printed beside it
    flops2, flops1 = 2.0 * ranged_elems * K, 2.0 * ranged1 * K
    b2, by2 = bound(ranged_elems * 4 + io_bytes + r_size * 4, flops2, peaks)
    b2_format, by2_format = bound(2 * P * TM * W * 4 + io_bytes,
                                  2.0 * P * TM * 2 * W * K, peaks)
    b1, by1 = bound(ranged1 * 4 + io_bytes + r1_size * 4, flops1, peaks)
    b1_format, by1_format = bound(P * TM * W * 4 + io_bytes,
                                  2.0 * P * TM * W * K, peaks)
    rec = REDESIGN_RECORD_MS
    log(f"[kernels] band_spmm_v2: {ms2:.3f} ms "
        f"({flops2 / (ms2 * 1e-3) / 1e12:.2f} TFLOP/s of its ranges, "
        f"{2.0 * g.nnz * K / (ms2 * 1e-3) / 1e9:.0f} GF/s of the SpMM); on "
        f"full-depth ranges {ms2_full:.3f} ms; bound of its ranges "
        f"{b2:.3f} ms ({by2}), of the split format {b2_format:.3f} ms "
        f"({by2_format}); the whole-depth kernel's record "
        f"{rec['band_spmm_v2']} ms; pallas2 plan "
        f"{res['pallas2'].t_elap_ms:.3f} ms; impl=xla plan "
        f"{res['xla'].t_elap_ms:.3f} ms; library CSR {library_ms:.3f} ms")
    log(f"[kernels] band_spmm_v1: {ms1:.3f} ms "
        f"({flops1 / (ms1 * 1e-3) / 1e12:.2f} TFLOP/s of its ranges, "
        f"{2.0 * g.nnz * K / (ms1 * 1e-3) / 1e9:.0f} GF/s of the SpMM); on "
        f"full-depth ranges {ms1_full:.3f} ms "
        f"({2.0 * P * TM * W * K / (ms1_full * 1e-3) / 1e12:.2f} TFLOP/s "
        f"dense); bound of its ranges {b1:.3f} ms ({by1}), of the unsplit "
        f"format {b1_format:.3f} ms ({by1_format}); the synchronous "
        f"kernel's record {rec['band_spmm_v1']} ms; pallas plan "
        f"{res['pallas'].t_elap_ms:.3f} ms")
    src = "flex_tpu_torch/csrc/band_spmm.cu"
    return [{
        "name": "band_spmm_v2", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/pallas_band.py:113",
        "launches": launches["band_spmm_v2"], "max_abs_err": e2, "ms": ms2,
        "plain_ms": plain2, "bound_ms": b2, "bound_by": by2,
        "library_ms": library_ms, "plan_ms": res["pallas2"].t_elap_ms,
        "t_pre_s": res["pallas2"].t_pre_s, "ms_full_depth": ms2_full,
        "bound_ms_split_format": b2_format,
        "bound_by_split_format": by2_format,
        "depth_share_read": range_stats2["depth_share_read"],
        "empty_tiles": range_stats2["empty_tiles"],
        "ranges_build_ms": range_stats2["table_build_ms"],
    }, {
        "name": "band_spmm_v1", "route": "cuda", "source": src,
        "replaces": "flex_tpu/ops/pallas_band.py:191",
        "launches": launches["band_spmm_v1"], "max_abs_err": e1, "ms": ms1,
        "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
        "library_ms": library_ms, "plan_ms": res["pallas"].t_elap_ms,
        "t_pre_s": res["pallas"].t_pre_s, "ms_full_depth": ms1_full,
        "bound_ms_unsplit_format": b1_format,
        "bound_by_unsplit_format": by1_format,
        "depth_share_read": range_stats1["depth_share_read"],
        "empty_tiles": range_stats1["empty_tiles"],
        "ranges_build_ms": range_stats1["table_build_ms"],
        "impl_xla_plan_ms": res["xla"].t_elap_ms,
    }]


# ---------------------------------------------------------------------------
# the models on the card (SAGE, GAT) and the panel plan
# ---------------------------------------------------------------------------

def phase_sage(torch, g, plan, tplan, X, smi):
    """GraphSAGE(128 -> 128 -> 41) on the main path's windowed plan with its
    training backward: the first step's gradients against the plain plan,
    3 steps, a checkpoint, 5 timed steps; then a fresh model and optimizer
    restored from the checkpoint must give step 4's loss and parameters
    bit for bit.  Returns the launch counts of the 8 steps."""
    import tempfile

    from flex_tpu_torch.models import (
        GraphSAGE, make_sage_train_step, sage_loss,
    )
    from flex_tpu_torch.models.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )

    d_in, d_hid, n_cls = 128, 128, 41
    y, mask = node_labels(torch, g.m, n_cls)

    def fresh(seed):
        model = GraphSAGE(d_in, d_hid, n_cls, nnz=g.nnz,
                          generator=torch.Generator().manual_seed(seed))
        model = model.cuda()
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    model, opt = fresh(0)
    check_first_step_gradients(torch, model, sage_loss, tplan,
                               plain_plan(torch, plan), X, y, mask, "sage")
    step = make_sage_train_step(model, tplan, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [step(X, y, mask) for _ in range(3)]   # 2 warm-up + step 3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sage.pt")
        t0 = time.perf_counter()
        save_checkpoint(path, model, opt, step=3)
        save_s = time.perf_counter() - t0
        timed, step_ms, host_ms = timed_steps(torch, step, (X, y, mask), 1)
        after4 = {n: p.detach().clone() for n, p in model.named_parameters()}
        more, more_ms, more_host = timed_steps(torch, step, (X, y, mask), 4)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        resumed, r_opt = fresh(1)
        restored = restore_checkpoint(path, resumed, r_opt)
        loss4 = make_sage_train_step(resumed, tplan, r_opt)(X, y, mask)
    losses += timed + more
    step_ms += more_ms
    host_ms = (host_ms + 4 * more_host) / 5
    same = restored == 3 and torch.equal(loss4, losses[3]) and all(
        torch.equal(p, after4[n]) for n, p in resumed.named_parameters())
    if not same:
        raise AssertionError(f"[sage] resumed step 4: loss {float(loss4)!r} "
                             f"vs {float(losses[3])!r}, restored step "
                             f"{restored}: not the same bits")
    # 2 forward and 2 g_B per step, as the GCN's; kernel 7 runs the residue
    expect_launches(launches, "8 SAGE train steps", window_spmm_fwd=16,
                    window_bwd_gB=16, gespmm_rows=32)
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"[sage] loss {losses}: not finite and falling")
    log(f"[sage] losses {[round(x, 6) for x in losses]}; checkpoint after "
        f"step 3 ({save_s:.3f}s to write), restored into a fresh model and "
        f"Adam: step 4's loss {float(loss4)!r} and parameters equal the "
        f"uninterrupted run's bit for bit")
    log("[sage] " + json.dumps({
        "ms_per_step": float(np.median(step_ms)),
        "ms_per_step_host": host_ms, "step_ms": step_ms,
        "peak_memory_allocated": peak, "launches_8_steps": launches,
        "card": smi}))
    return launches


def plain_dyn(torch, plan):
    """A copy of the plan whose call, (vals, B) -> A(vals)·B, is the
    row-unit kernel's plain version on the plan's forward tables: all
    tensor ops, so autograd differentiates it in vals and B with no kernel
    of the package."""
    import dataclasses

    from flex_tpu_torch.ops.dyn_ell import DynEllPlan
    from flex_tpu_torch.ops.gespmm import gespmm_rows_plain

    class PlainDynPlan(DynEllPlan):
        def __call__(self, vals, B):
            return gespmm_rows_plain(dataclasses.replace(self.fwd, vals=vals),
                                     B)

    return PlainDynPlan(**{f.name: getattr(plan, f.name)
                           for f in dataclasses.fields(plan)})


def edge_dots_unpadded(torch, dyn, g, B):
    """The dynamic SpMM's g_vals as ``DynEllPlan.edge_dots`` computes it,
    but gathered from g and B as they are: the yardstick of its padding."""
    out = g.new_empty(dyn.nnz)
    for s in range(0, dyn.nnz, dyn.max_gather_rows):
        e = slice(s, s + dyn.max_gather_rows)
        out[e] = (g.index_select(0, dyn.rows[e].long())
                  * B.index_select(0, dyn.cols[e].long())).sum(1)
    return out


def phase_gat(torch, g, dev, X, peaks, time_cuda_ms, smi, profile=False):
    """GAT(128 -> 4 heads x 16 -> 41) on the main path's graph (unit
    self-loops: attention over N(i) and i): kernel 7 on the dynamic SpMM's
    forward and g_B tables against plain at k = 16 and 41, the first
    step's loss and gradients against the plain dynamic SpMM, two forwards
    compared bit for bit, 2 warm-up and 5 timed Adam(1e-2) steps with
    kernel 7's launches per step.  Returns kernel 7's numbers here."""
    import dataclasses

    from flex_tpu_torch.models import (
        GAT, gat_loss, make_gat_train_step, prepare_attention,
    )
    from flex_tpu_torch.ops.gespmm import gespmm_rows, gespmm_rows_plain

    d_in, d_hid, n_cls, heads = 128, 16, 41, 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ag = prepare_attention(g, dev=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    dyn = ag.plan
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.random(g.nnz, dtype=np.float32)).cuda()
    kern = {}
    b_rows = {"fwd": distinct_cols(torch, dyn.fwd),
              "gB": distinct_cols(torch, dyn.bwd)}
    for k in (d_hid, n_cls):
        Bk = torch.rand((g.m, k), device="cuda") * 2 - 1
        for part, t in (("fwd", dataclasses.replace(dyn.fwd, vals=vals)),
                        ("gB", dataclasses.replace(
                            dyn.bwd, vals=vals.index_select(0, dyn.perm)))):
            err = check_gespmm_kernel(torch, t, Bk,
                                      f"GAT dynamic {part} k={k}")
            ms = time_cuda_ms(gespmm_rows, t, Bk, iters=10)
            plain_ms = time_cuda_ms(gespmm_rows_plain, t, Bk, iters=3,
                                    warmup=1)
            n_bytes = rows_bytes(t, g.nnz, b_rows[part] * k, t.m * k)
            bound_ms, bound_by = bound(n_bytes, 2.0 * g.nnz * k, peaks)
            kern[f"{part}_k{k}"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by)
        kern[f"call_fwd_k{k}"] = time_cuda_ms(dyn, vals, Bk, iters=10)
        # g_vals (plain torch): the plan's gathers, and the same products
        # gathered without the zero column it adds when k % 4 == 0
        gk = torch.rand((g.m, k), device="cuda") * 2 - 1
        kern[f"g_vals_k{k}"] = time_cuda_ms(dyn.edge_dots, gk, Bk, iters=5)
        kern[f"g_vals_unpadded_k{k}"] = time_cuda_ms(
            lambda: edge_dots_unpadded(torch, dyn, gk, Bk), iters=5)
        del Bk, gk
    y, mask = node_labels(torch, g.m, n_cls)
    model = GAT(d_in, d_hid, n_cls, n_heads=heads,
                generator=torch.Generator().manual_seed(0)).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    check_first_step_gradients(
        torch, model, gat_loss, ag,
        dataclasses.replace(ag, plan=plain_dyn(torch, dyn)), X, y, mask,
        "gat")
    torch.cuda.empty_cache()
    with torch.no_grad():
        same_bits = torch.equal(model(ag, X), model(ag, X))
    step = make_gat_train_step(model, ag, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [step(X, y, mask) for _ in range(2)]            # warm-up
    timed, step_ms, host_ms = timed_steps(torch, step, (X, y, mask), 5)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # per step and head: one dynamic SpMM forward and its g_B, two layers
    expect_launches(launches, "7 GAT train steps",
                    gespmm_rows=7 * 2 * 2 * heads)
    losses = [float(x) for x in losses + timed]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"[gat] loss {losses}: not finite and falling")
    if profile:
        profile_steps(torch, step, (X, y, mask), tag="GAT train")
    out = {"ms_per_step": float(np.median(step_ms)),
           "ms_per_step_host": host_ms, "step_ms": step_ms,
           "peak_memory_allocated": peak, "launches_7_steps": launches,
           "launches_per_step": launches["gespmm_rows"] // 7,
           "two_forwards_same_bits": same_bits,
           "prepare_attention_s": prep_s, "kernel": kern, "card": smi}
    log(f"[gat] losses {[round(x, 6) for x in losses]}; two forwards give "
        f"the same bits: {same_bits}")
    log("[gat] " + json.dumps(out))
    del ag, model, opt
    torch.cuda.empty_cache()
    return out


PANEL_CASE = dict(m=200_000, nnz_target=20_000_000, n_hub_cols=512,
                  hub_frac=0.95, seed=0)
# below the case's maximum degree (123): the rows above it form a prefix
# after DEG, the hub rows
PANEL_HUB_THRESHOLD = 100


def phase_panel(torch, peaks, bench_spmm, time_cuda_ms, smi):
    """Panel at full size: the JAX package's own panel case, DEG-ordered,
    k = 128; without hub rows (the default threshold of 512 is above the
    maximum degree) and with them (threshold 100: a hub prefix on kernel
    7).  Each plan through ``bench_spmm`` beside cuSPARSE on the same CSR;
    kernel 7 on the hub tables against plain.  Returns its numbers."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.io.synth import hub_graph
    from flex_tpu_torch.ops.gespmm import gespmm_rows, gespmm_rows_plain
    from flex_tpu_torch.ops.ref import spmm_scipy
    from flex_tpu_torch.reorder import reorder
    from flex_tpu_torch.sparse.device import DeviceCSR

    t0 = time.perf_counter()
    g = hub_graph(**PANEL_CASE)
    t1 = time.perf_counter()
    g = reorder(g, "deg", check=False)
    t2 = time.perf_counter()
    B = make_features(g, K)
    gold = spmm_scipy(g, B)
    t3 = time.perf_counter()
    max_deg = int(g.degrees.max())
    log(f"[panel] host: hub_graph {t1 - t0:.1f}s, deg {t2 - t1:.1f}s, "
        f"features + SciPy gold {t3 - t2:.1f}s; {g}, max degree {max_deg}")
    dev = DeviceCSR.from_graph(g, "cuda")
    B_dev = torch.from_numpy(B).cuda()
    A_csr = csr_tensor(torch, g)
    library_ms = time_cuda_ms(torch.sparse.mm, A_csr, B_dev, iters=20)
    del A_csr
    out = {"max_degree": max_deg, "m": g.m, "nnz": g.nnz,
           "graph_host_s": t2 - t0, "library_ms": library_ms, "card": smi}
    for name, kw in (("no_hubs", {}),
                     ("hubs", dict(hub_threshold=PANEL_HUB_THRESHOLD))):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        r, plan = bench_checked(bench_spmm, g, K, "panel", f"panel {name}",
                                dev=dev, B=B, gold=gold, iters=10, **kw)
        launches = read_launches()
        st = plan.stats
        if (st["n_hub_rows"] > 0) != (name == "hubs"):
            raise AssertionError(f"[panel] {name}: {st['n_hub_rows']} hub "
                                 f"rows")
        # 3 warm-up + 10 timed + 1 checked call; kernel 7 runs the hub rows
        expect_launches(launches, f"the panel path ({name})",
                        gespmm_rows=14 if name == "hubs" else 0)
        res = {"t_pre_s": r.t_pre_s, "t_elap_ms": r.t_elap_ms,
               "gflops": r.gflops, "err_frac": r.err_frac, "stats": st,
               "traffic_model_bytes": plan.traffic_model(K)["bytes"],
               "peak_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches["gespmm_rows"],
               "repeat_same_bits": torch.equal(plan(B_dev), plan(B_dev))}
        if plan.hub_rows is not None:
            t = plan.hub_rows
            hub_nnz = int(g.row_ptr[plan.n_hub_rows])
            res["hub_err"] = check_gespmm_kernel(torch, t, B_dev,
                                                 "panel hub rows k=128")
            res["hub_ms"] = time_cuda_ms(gespmm_rows, t, B_dev, iters=20)
            res["hub_plain_ms"] = time_cuda_ms(gespmm_rows_plain, t, B_dev,
                                               iters=3, warmup=1)
            hub_b_rows = distinct_cols(torch, t)
            res["hub_bound_ms"], res["hub_bound_by"] = bound(
                rows_bytes(t, hub_nnz, hub_b_rows * K, t.m * K),
                2.0 * hub_nnz * K, peaks)
            res["hub_nnz"], res["hub_b_rows"] = hub_nnz, hub_b_rows
        out[name] = res
        log(f"[panel] {name}: tElap {r.t_elap_ms:.3f} ms beside cuSPARSE "
            f"{library_ms:.3f} ms on the same CSR; " + json.dumps(res))
        del plan
        torch.cuda.empty_cache()
    del dev, B_dev
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the autotuner's rates, the GCN layer bench, the command line, the sweep
# ---------------------------------------------------------------------------

# the phases whose launch counts join every row of the kernels line
NEW_PHASES = ("autotune", "gcn_bench", "cli_auto_k128", "cli_auto_k41",
              "cli_windowed_k128", "sweep")


def phase_autotune(torch, g, dev, B_dev, sel, kernel1_ms, kernel4_ms41,
                   time_cuda_ms):
    """The autotuner's rates, measured on the main path's graph: seconds
    per padded ELL nonzero on kernel 7 (the ELL plan at k = 128 and 41),
    seconds per kept window of the main path's selection on kernel 1 at
    k = 128 (phase 5's time) and on kernel 4 at k = 41 (phase 9's), the
    FP32 ``torch.bmm`` rate at panel-tail shapes, the bytes rate of the
    row gather that feeds it, and the fixed cost of one call.  Then
    ``suggest``'s choice and model beside ``autotune``'s measured ranking
    at k = 128 and 41 (the transposed plan too at 41).  A choice slower
    than the fastest candidate is reported, not failed.  Returns (rates,
    launch counts)."""
    from flex_tpu_torch.bench.autotune import autotune, suggest
    from flex_tpu_torch.bench.harness import bench_spmm
    from flex_tpu_torch.io.synth import rmat_graph
    from flex_tpu_torch.ops.ell_spmm import ell_padded_nnz, prepare_ell

    reset_launches()
    ell = prepare_ell(g, dev=dev)
    pad = ell_padded_nnz(g.degrees)
    if pad != ell.padded_nnz:
        raise AssertionError(f"ell_padded_nnz {pad} != plan {ell.padded_nnz}")
    B41 = B_dev[:, :41].contiguous()
    ell_ms = time_cuda_ms(ell, B_dev, iters=20)
    ell_ms41 = time_cuda_ms(ell, B41, iters=20)
    del ell
    n_win = sel["total_steps"] * sel["G"]
    # panel's tail: (panels, tm, u) x (panels, u, k) batched products
    Ab = torch.rand((1024, 128, 512), device="cuda")
    Bb = torch.rand((1024, 512, K), device="cuda")
    bmm_ms = time_cuda_ms(torch.bmm, Ab, Bb, iters=20)
    bmm_flops = 2 * 1024 * 128 * 512 * K
    del Ab, Bb
    idx = torch.randint(0, g.n, (4_000_000,), device="cuda")
    gather_ms = time_cuda_ms(torch.index_select, B_dev, 0, idx, iters=20)
    gather_bytes = 2 * idx.numel() * K * 4 + idx.numel() * 8
    del idx
    # one call of a plan whose kernels take no time: the host's launch
    # cost or the card's, whichever is larger
    tiny = rmat_graph(1024, 8192, seed=0)
    tp = prepare_ell(tiny, device="cuda")
    Bt = torch.rand((tiny.n, K), device="cuda")
    tp_ms = time_cuda_ms(tp, Bt, iters=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        tp(Bt)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    rates = {
        "ell_s_per_pad": ell_ms * 1e-3 / pad,
        "ell_k41_ratio": ell_ms41 / ell_ms,
        "ell_ns_per_pad_k128": ell_ms * 1e6 / pad,
        "ell_ns_per_pad_k41": ell_ms41 * 1e6 / pad,
        "ell_ms": ell_ms, "ell_ms_k41": ell_ms41, "ell_padded_nnz": pad,
        "win_s_per_window": kernel1_ms * 1e-3 / n_win,
        "win_k41_ratio": kernel4_ms41 / kernel1_ms,
        "win_us_per_window_kernel1_k128": kernel1_ms * 1e3 / n_win,
        "win_us_per_window_kernel4_k41": kernel4_ms41 * 1e3 / n_win,
        "kept_windows": n_win,
        "bmm_flops": bmm_flops / (bmm_ms * 1e-3), "bmm_ms": bmm_ms,
        "gather_bytes": gather_bytes / (gather_ms * 1e-3),
        "gather_ms": gather_ms,
        "fixed_overhead_s": max(tp_ms, host_ms) * 1e-3,
        "tiny_call_event_ms": tp_ms, "tiny_call_host_ms": host_ms,
    }
    log("[autotune] rates " + json.dumps(rates))
    del tp, Bt
    for k in (K, 41):
        t0 = time.perf_counter()
        s = suggest(g, k)
        t_sug = time.perf_counter() - t0
        res = autotune(g, k, methods=("ell", "windowed", "bcoo", "xla"))
        ranking = [(r.method, r.t_elap * 1e3) for r in res]
        if k == 41:
            r = bench_spmm(g, k, "windowed", check=False, iters=3, dev=dev,
                           transposed=True)
            ranking.append(("windowed transposed", r.t_elap * 1e3))
        ranking.sort(key=lambda x: x[1])
        choice = s.method + (" transposed" if s.prep_kwargs.get(
            "transposed") else "")
        got = dict(ranking).get(choice)
        log(f"[autotune] k={k}: suggest -> {choice} ({s.reason}; host "
            f"{t_sug:.1f}s); model ms "
            + json.dumps({m: t * 1e3 for m, t in s.model.items()})
            + "; measured ms, fastest first " + json.dumps(ranking))
        if got is None or got > ranking[0][1]:
            log(f"[autotune] k={k}: suggest's choice {choice} "
                f"({got} ms) is not the fastest measured candidate "
                f"{ranking[0][0]} ({ranking[0][1]:.3f} ms)")
    return rates, read_launches()


def phase_gcn_bench(g):
    """``bench_gcn_layer(g, 128, 41, method="ell")``: both associations of
    the GCN layer on kernel 7; the two must agree, and agree with SciPy,
    with err_frac 0 (``res_check2``, tol 0.01)."""
    from flex_tpu_torch.bench.gcn_bench import bench_gcn_layer

    reset_launches()
    r = bench_gcn_layer(g, K, 41, method="ell")
    launches = read_launches()
    # per association 3 warm-up + 5 timed + 1 checked call
    expect_launches(launches, "gcn_bench", gespmm_rows=18)
    gf = r.gflops(g.nnz, g.m)
    log("[gcn_bench] " + json.dumps({
        "t_axw_ms": r.t_axw * 1e3, "t_ax_w_ms": r.t_ax_w * 1e3,
        "gflops_axw": gf["axw"], "gflops_ax_w": gf["ax_w"],
        "auto_choice": r.auto_choice, "cross_err_frac": r.cross_err_frac,
        "scipy_err_frac": r.scipy_err_frac}))
    if r.cross_err_frac != 0 or r.scipy_err_frac != 0:
        raise AssertionError(f"gcn_bench: cross {r.cross_err_frac}, scipy "
                             f"{r.scipy_err_frac}")
    return launches


CLI_TIMEOUT_S = 600


def run_cli(args, label):
    """``python -m flex_tpu_torch`` with ``args`` in a child process, from
    the checkout's root; every line it prints is logged.  Returns (its
    output, the launch counts it printed last, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "flex_tpu_torch", *args],
                       cwd=root, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in p.stdout.splitlines():
        log(f"[{label}] | {line}")
    if p.returncode != 0:
        log(p.stderr[-6000:])
        raise AssertionError(f"[{label}] exited {p.returncode}")
    m = re.search(r"^kernel launches: (\{.*\})$", p.stdout, re.M)
    if m is None:
        raise AssertionError(f"[{label}] printed no launch counts")
    return p.stdout, json.loads(m.group(1)), secs


def read_csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# the hand kernels each method's plan launches, by device-function name
CLI_KERNELS = {"ell": ("rows_kernel",),
               "windowed": ("window_spmm_kernel", "rows_kernel"),
               "windowed transposed": ("window_spmm_t_kernel", "rows_kernel")}
CLI_WRAPPERS = {"ell": ("gespmm_rows",),
                "windowed": ("window_spmm_fwd", "gespmm_rows"),
                "windowed transposed": ("window_spmm_t_fwd", "gespmm_rows")}


def phase_cli(main_ms, main_stats):
    """The main path's graph through ``python -m flex_tpu_torch``: the CSV
    that ``load_graph(csv=True)`` wrote (the graph before ordering),
    ``--order=rbdeg`` with the ordering file, ``--method=auto`` at k = 128
    and 41, then
    ``--method=windowed --min_count=64`` at k = 128, each with ``--csv``
    and ``--trace``.  Each run exits 0, reloads the ordering, writes one
    row with err_frac <= 1e-4 and the method it printed, launches the
    hand kernels of that method (15 calls: 3 warm-up, 10 timed, the traced
    and the checked one) and names them in its trace.  The windowed run
    selects what phase 4 selected (its 8 GiB budget and phase 4's 6 GiB
    both hold the 6.4 GB array) and its tElap is within 3 % of phase
    4's.  Returns {run: summary}."""
    from flex_tpu_torch.bench.headline import GRAPH_CSV, GRAPH_PERM
    from flex_tpu_torch.kernels import BUILD_DIR
    from flex_tpu_torch.utils.trace import classify_op, trace_table

    csv_path, perm = GRAPH_CSV, GRAPH_PERM
    out = {}
    for tag, k, flags in (
            ("cli_auto_k128", K, ["--method=auto"]),
            ("cli_auto_k41", 41, ["--method=auto"]),
            ("cli_windowed_k128", K, ["--method=windowed", "--min_count=64"])):
        row_csv = os.path.join(BUILD_DIR, f"{tag}.csv")
        tdir = os.path.join(BUILD_DIR, f"{tag}_trace")
        shutil.rmtree(tdir, ignore_errors=True)
        stdout, launches, secs = run_cli(
            [csv_path, str(k), "--order=rbdeg", f"--order-file={perm}",
             *flags, f"--csv={row_csv}", f"--trace={tdir}"], tag)
        if f"loading ordering from {perm}" not in stdout:
            raise AssertionError(f"[{tag}] did not reload the ordering file")
        m = re.search(r"^auto-selected method: (\w+) \(", stdout, re.M)
        printed = m.group(1) if m else flags[0].split("=")[1]
        if re.search(r"refused \(.*\); falling back to ell", stdout):
            printed = "ell"
        rows = read_csv_rows(row_csv)
        if len(rows) != 1 or rows[0]["method"] != printed:
            raise AssertionError(f"[{tag}] csv rows {rows} do not name the "
                                 f"printed method {printed}")
        row = rows[0]
        err = float(row["err_frac"])
        if not err <= 1e-4:
            raise AssertionError(f"[{tag}] err_frac={err} > 1e-4")
        plan = printed + (" transposed" if row.get("fmt_transposed") == "True"
                          else "")
        expect_launches(launches, f"[{tag}]", **{
            w: 15 for w in CLI_WRAPPERS[plan]})
        trows = trace_table(tdir)
        for name in CLI_KERNELS[plan]:
            hits = [r for r in trows if name in r["op"]]
            if not hits or any(classify_op(r["op"]) != "dot" for r in hits):
                raise AssertionError(f"[{tag}] trace does not show {name} "
                                     f"as a dot op: {trows[:8]}")
        out[tag] = {
            "k": k, "method": plan, "t_elap_ms": float(row["t_elap_ms"]),
            "t_pre_s": float(row["t_pre_s"]), "gflops": float(row["gflops"]),
            "err_frac": err,
            "trace_device_ms": float(row["trace_device_ms"])
            if row.get("trace_device_ms") else None,
            "trace_dot_ms": float(row["trace_dot_ms"])
            if row.get("trace_dot_ms") else None,
            "fmt_n_steps": row.get("fmt_n_steps"),
            "fmt_n_res": row.get("fmt_n_res"),
            "seconds": secs, "launches": launches,
            "trace_top": [(r["op"][:100], r["count"], r["total_ms"])
                          for r in trows[:6]]}
        log(f"[{tag}] " + json.dumps(out[tag]))
    w = out["cli_windowed_k128"]
    if (int(w["fmt_n_steps"]), int(w["fmt_n_res"])) != (
            main_stats["n_steps"], main_stats["n_res"]):
        raise AssertionError(f"[cli] windowed selection {w['fmt_n_steps']} "
                             f"steps, {w['fmt_n_res']} residue nnz; phase 4 "
                             f"{main_stats['n_steps']}, {main_stats['n_res']}")
    rel = w["t_elap_ms"] / main_ms - 1
    log(f"[cli] windowed tElap {w['t_elap_ms']:.3f} ms against phase 4's "
        f"{main_ms:.3f} ms ({rel:+.2%})")
    if abs(rel) > 0.03:
        raise AssertionError(f"[cli] windowed tElap differs by {rel:+.2%} "
                             f"from phase 4's")
    return out


def phase_sweep():
    """``python -m flex_tpu_torch <flickr_posts csv> 128 --method=sweep``
    on flickr_posts(seed=0) (89,250 nodes, 989,006 nnz): 6 orderings x
    xla, bcoo, ell, panel, band, windowed (the last three at tm 128 and
    256).  It exits 0, and every row passes its check or records a
    ValueError / NotImplementedError refusal.  Returns (summary, launch
    counts)."""
    from flex_tpu_torch.io import flickr_posts, save_csv
    from flex_tpu_torch.kernels import BUILD_DIR

    t0 = time.perf_counter()
    csv_path = os.path.join(BUILD_DIR, "flickr_posts.csv")
    g = flickr_posts(seed=0)
    save_csv(g, csv_path)
    log(f"[sweep] host: {g}, written in {time.perf_counter() - t0:.1f}s")
    rows_csv = os.path.join(BUILD_DIR, "sweep.csv")
    _, launches, secs = run_cli([csv_path, str(K), "--method=sweep",
                                 f"--csv={rows_csv}"], "sweep")
    rows = read_csv_rows(rows_csv)
    refused, checked = [], []
    for r in rows:
        if r.get("err_frac"):
            if float(r["err_frac"]) != 0.0:
                raise AssertionError(f"[sweep] row failed its check: {r}")
            checked.append(r)
        elif r.get("error", "").startswith(("ValueError",
                                            "NotImplementedError")):
            refused.append(r)
        else:
            raise AssertionError(f"[sweep] row neither checked nor refused: "
                                 f"{r}")
    best = min(checked, key=lambda r: float(r["t_elap_ms"]))
    out = {"rows": len(rows), "checked": len(checked),
           "refused": len(refused), "seconds": secs,
           "refused_by_method": {m: sum(r["method"] == m for r in refused)
                                 for m in sorted({r["method"] for r in rows})},
           "fastest": {f: best[f] for f in ("order", "method", "t_elap_ms",
                                            "gflops")},
           "launches": launches}
    log("[sweep] " + json.dumps(out))
    return out, launches


# ---------------------------------------------------------------------------
# kernel 7's bf16 instance, the build options, the sharded plans and the
# 2-D GCN step
# ---------------------------------------------------------------------------

# the phases of the bf16 mode, the build options and the sharded plans,
# whose launch counts join every row too
SHARD_PHASES = ("bf16", "bf16_windowed", "options", "sharded_ell",
                "sharded_windowed", "sharded_grad", "parallel_2d")
# the f32 ELL plan's tElap through the command line at k = 128 and 41, on
# an NVIDIA H100 80GB HBM3 at 700 W, before the bf16 mode existed: printed
# beside this run's f32 and bf16 plans
ELL_CLI_RECORD_MS = {128: 1.3905, 41: 0.9889}
# kernel 7's bf16 instance before its redesign (the f32 body on bf16 B, 8-byte
# loads), on the same card model at 700 W
BF16_TEMPLATED_RECORD_MS = {128: 1.0174, 41: 1.0247}
ONE_CARD = "four shards on one card, not a scaling figure"
BF16_SCALE = 4.0 * 2 ** 16   # res_check's eps_scale for a bf16 gather


def check_gespmm_bf16_kernel(torch, t, B, label, into=None):
    """Kernel 7's bf16 instance on B rounded to bf16: launched twice, the
    same bits; the f32 instance on that B widened, the same bits (the
    instances sum in one order); B in the plans' padded cast (16-byte
    loads at every k) and misaligned by one element (2-byte loads), the
    same bits; and its plain version (``gespmm_rows_plain`` on the bf16 B)
    within the rounding bound of two f32 sums.  Returns max_abs_err."""
    from flex_tpu_torch.ops.gespmm import (
        gespmm_rows, gespmm_rows_bf16, gespmm_rows_plain, to_bf16_padded,
    )

    Bb = B.bfloat16()

    def call(fn, BB):
        return fn(t, BB, into=None if into is None else into.clone())

    out = call(gespmm_rows_bf16, Bb)
    if out.dtype != torch.float32:
        raise AssertionError(f"gespmm_rows_bf16 on {label}: {out.dtype} out")
    require_same_bits(torch, "gespmm_rows_bf16", label, out,
                      call(gespmm_rows_bf16, Bb))
    require_same_bits(torch, "gespmm_rows_bf16 vs the f32 instance on B "
                      "widened", label, out, call(gespmm_rows, Bb.float()))
    require_same_bits(torch, "gespmm_rows_bf16 on the padded cast", label,
                      out, call(gespmm_rows_bf16, to_bf16_padded(B)))
    mis = torch.empty(Bb.numel() + 1, dtype=torch.bfloat16,
                      device=B.device)[1:].view(Bb.shape)
    mis.copy_(Bb)
    require_same_bits(torch, "gespmm_rows_bf16 on a misaligned B", label, out,
                      call(gespmm_rows_bf16, mis))
    torch.cuda.synchronize()
    absprod, L = rows_absprod_and_len(torch, t, Bb.float())
    if into is not None:
        absprod = absprod + into.abs() / L
    return hold_to_plain(torch, "gespmm_rows_bf16", label, out,
                         call(gespmm_rows_plain, Bb), absprod, L)


BF16_KS = (8, 16, 32, 41, 64, 96, 128, 200)


def phase_bf16_kernel_vs_plain(torch, dev="cuda"):
    """Kernel 7's bf16 instance at the shapes its f32 instance is held at
    in phase 3: GE-SpMM plans with pad chunks, empty and split rows (w = 32
    and 7; every lane-group size, k = 8 .. 200), the ELL plan and its
    transposed plan added into an accumulator (k = 128, 41, 32)."""
    from flex_tpu_torch.ops.ell_spmm import prepare_ell, with_bwd_plan
    from flex_tpu_torch.ops.gespmm import prepare_gespmm

    rng = np.random.default_rng(12)
    gh = hub_and_empty_graph(rng)
    for w in (32, 7):
        plan = prepare_gespmm(gh, w=w, device=dev)
        for k in BF16_KS:
            B = torch.rand((gh.n, k), device=dev) * 2 - 1
            check_gespmm_bf16_kernel(
                torch, plan.rows, B, f"hub+empty N={plan.cols.shape[0]} "
                f"w={w} k={k} split rows={plan.rows.splits.shape[0]}")
    ell = with_bwd_plan(prepare_ell(gh, device=dev), gh.n)
    for e, what in ((ell, "ell"), (ell.bwd_plan, "transposed ell")):
        for k in (K, 41, 32):
            B = torch.rand((gh.n, k), device=dev) * 2 - 1
            into = torch.rand((e.m, k), device=dev) * 2 - 1
            check_gespmm_bf16_kernel(torch, e.rows, B, f"{what} into= k={k}",
                                     into=into)


def res_check_logged(g, C, gold, label, eps_scale=4.0, row_nnz=None):
    """res_check of a card result against SciPy, err_frac <= 1e-4."""
    from flex_tpu_torch.utils.check import res_check

    if tuple(C.shape) != gold.shape or not bool(C.isfinite().all()):
        raise AssertionError(f"{label}: output {tuple(C.shape)} is not a "
                             f"finite {gold.shape} tensor")
    chk = res_check(gold, C.detach().cpu().numpy(),
                    g.degrees if row_nnz is None else row_nnz,
                    eps_scale=eps_scale)
    if chk.err_frac > 1e-4:
        raise AssertionError(f"{label}: err_frac={chk.err_frac} > 1e-4")
    log(f"[check] {label}: err_frac={chk.err_frac} max_err={chk.max_err:.3e}"
        f" (eps_scale {eps_scale:g}) ok")
    return chk.err_frac


def phase_bf16(torch, g, dev, B, gold, sel, peaks, bench_spmm, time_cuda_ms,
               smi):
    """[bf16] on the main path's graph: ``prepare_ell(b_dtype="bfloat16")``
    through ``bench_spmm`` at k = 128 and 41 (its check at the bf16
    scale); at k = 128, 41 and 32 kernel 7's bf16 instance against its
    plain version on the plan's tables, its time on the plan's padded cast
    beside the f32 instance's and the f32 plan's, both gathered-row rates,
    its layout (ldb, lanes a row, units a warp), the units' divergence,
    its bytes bound (2 bytes a B element), cuSPARSE on its CSR; ptxas's
    registers and spills for both bodies; then the windowed plan with a
    bf16 residue at k = 128.  Returns (kernel row, launches by path)."""
    from flex_tpu_torch.ops.ell_spmm import ell_spmm_plain, prepare_ell
    from flex_tpu_torch.ops.gespmm import (
        bf16_layout, gespmm_rows, gespmm_rows_bf16, gespmm_rows_plain,
        to_bf16_padded,
    )

    reset_launches()
    res, plan = {}, None
    for k in (K, 41):
        r, p = bench_plan(bench_spmm, g, k, "ell", dev=dev,
                          B=np.ascontiguousarray(B[:, :k]),
                          gold=np.ascontiguousarray(gold[:, :k]), iters=10,
                          b_dtype="bfloat16")
        if r.err_frac is None or r.err_frac > 1e-4:
            raise AssertionError(f"bf16 ell k={k}: err_frac={r.err_frac} at "
                                 f"the bf16 scale")
        res[k] = r
        plan = plan or p
        del p
    launches = {"bf16": read_launches()}
    expect_launches(launches["bf16"], "the bf16 ELL path",
                    gespmm_rows_bf16=28)
    if plan.b_dtype != "bfloat16":
        raise AssertionError("the bf16 ELL plan is not bf16")
    t = plan.rows
    row = {"name": "gespmm_rows_bf16", "route": "cuda",
           "source": "flex_tpu_torch/csrc/gespmm.cu",
           "replaces": "flex_tpu/ops/ell_spmm.py:171",
           "launches": launches["bf16"]["gespmm_rows_bf16"]}
    f32 = prepare_ell(g, dev=dev)
    A_csr = csr_tensor(torch, g)
    b_rows = distinct_cols(torch, t)
    ptxas = {"bf16": ptxas_summary(kernel_usage("gespmm", "rows_bf16_kernel")),
             "f32": ptxas_summary(kernel_usage("gespmm", "rows_kernelIf"))}
    row["ptxas"] = ptxas
    log("[bf16] ptxas, kernel 7's bf16 body by <lanes a row, 16-byte loads> "
        "beside the f32 body by <float, float4 loads, accumulate>: "
        + json.dumps(ptxas))
    lens = (t.units[:, 2] - t.units[:, 1]).cpu().numpy().astype(np.int64)
    for k in (K, 41, 32):
        Bk = torch.from_numpy(np.ascontiguousarray(B[:, :k])).cuda()
        Bb = to_bf16_padded(Bk)   # the plan's own cast
        out = plan(Bk)
        absprod, L = rows_absprod_and_len(torch, t, Bb.float())
        err = hold_to_plain(torch, "gespmm_rows_bf16", f"bf16 ELL plan k={k}",
                            out, ell_spmm_plain(plan, Bk), absprod, L)
        ms = time_cuda_ms(gespmm_rows_bf16, t, Bb, iters=20)
        contiguous_ms = time_cuda_ms(gespmm_rows_bf16, t, Bk.bfloat16(),
                                     iters=20) if k % 8 else ms
        f32_kernel_ms = time_cuda_ms(gespmm_rows, t, Bk, iters=20)
        plan_ms = time_cuda_ms(plan, Bk, iters=20)
        f32_ms = time_cuda_ms(f32, Bk, iters=20)
        ldb, lanes, per_warp = bf16_layout(k)
        n_w = -(-len(lens) // per_warp)
        warp_max = np.zeros(n_w * per_warp, np.int64)
        warp_max[:len(lens)] = lens
        divergence = float(warp_max.reshape(n_w, per_warp).max(1).sum()
                           * per_warp / max(int(lens.sum()), 1))
        # bytes of B rows the loads fetch: ldb bf16 a nonzero on the padded
        # cast, k f32 for the f32 instance
        tb_s = g.nnz * ldb * 2 / (ms * 1e-3) / 1e12
        f32_tb_s = g.nnz * k * 4 / (f32_kernel_ms * 1e-3) / 1e12
        plain_ms = time_cuda_ms(lambda: gespmm_rows_plain(t, Bb), iters=3)
        lib_ms = time_cuda_ms(torch.sparse.mm, A_csr, Bb.float(), iters=20)
        try:
            A_bf = A_csr.to(torch.bfloat16)
            bf16_csr = f"{time_cuda_ms(torch.sparse.mm, A_bf, Bb, iters=20):.4f} ms"
            del A_bf
        except (RuntimeError, NotImplementedError) as e:   # a library refusal
            bf16_csr = f"refused ({str(e).splitlines()[0][:120]})"
        nbytes = (g.nnz * 8 + 4 * (t.row_start.numel() + t.units.numel()
                                   + t.splits.numel())
                  + 2 * b_rows * k + 4 * g.m * k)
        bms, bby = bound(nbytes, 2 * g.nnz * k, peaks)
        sfx = "" if k == K else f"_k{k}"
        row.update({f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                    f"plain_ms{sfx}": plain_ms, f"bound_ms{sfx}": bms,
                    f"bound_by{sfx}": bby, f"library_ms{sfx}": lib_ms,
                    f"plan_ms{sfx}": plan_ms, f"f32_plan_ms{sfx}": f32_ms,
                    f"f32_kernel_ms{sfx}": f32_kernel_ms,
                    f"contiguous_b_ms{sfx}": contiguous_ms,
                    f"gather_tb_s{sfx}": tb_s,
                    f"f32_gather_tb_s{sfx}": f32_tb_s,
                    f"divergence{sfx}": divergence})
        if k in res:
            row.update({f"t_elap_ms{sfx}": res[k].t_elap_ms,
                        f"err_frac{sfx}": res[k].err_frac})
        log("[bf16] " + json.dumps({
            "k": k, "t_pre_s": res[k].t_pre_s if k in res else None,
            "t_elap_ms": res[k].t_elap_ms if k in res else None,
            "err_frac_bf16_scale": res[k].err_frac if k in res else None,
            "kernel_ms": ms,
            "kernel_ms_templated_body_record": BF16_TEMPLATED_RECORD_MS.get(k),
            "contiguous_b_kernel_ms": contiguous_ms,
            "f32_kernel_ms_same_run": f32_kernel_ms,
            "gathered_rows_tb_s": tb_s, "f32_gathered_rows_tb_s": f32_tb_s,
            "ldb": ldb, "lanes_per_row": lanes, "units_per_warp": per_warp,
            "divergence": divergence,
            "plan_ms": plan_ms, "f32_plan_ms_same_run": f32_ms,
            "f32_plan_ms_cli_record": ELL_CLI_RECORD_MS.get(k),
            "bytes_bound_ms": bms, "bound_by": bby, "bound_bytes": nbytes,
            "b_rows_named": b_rows, "plain_ms": plain_ms,
            "cusparse_f32_csr_on_widened_b_ms": lib_ms,
            "bf16_csr_call": bf16_csr, "card": smi}))
        del Bk, Bb, out, absprod, L
    del plan, f32, A_csr, t
    torch.cuda.empty_cache()

    reset_launches()
    r, wplan = bench_plan(bench_spmm, g, K, "windowed", dev=dev, B=B,
                          gold=gold, iters=10, tm=256, W=128, min_count=64,
                          sel=sel, b_dtype="bfloat16")
    launches["bf16_windowed"] = read_launches()
    expect_launches(launches["bf16_windowed"], "the bf16 windowed path",
                    window_spmm_fwd=14, gespmm_rows_bf16=14)
    if r.err_frac is None or r.err_frac > 1e-4:
        raise AssertionError(f"bf16 windowed: err_frac={r.err_frac}")
    log("[bf16] windowed with a bf16 residue " + json.dumps({
        "k": K, "t_pre_s": r.t_pre_s, "t_elap_ms": r.t_elap_ms,
        "err_frac_bf16_scale": r.err_frac, "b_dtype": wplan.b_dtype,
        "launches": launches["bf16_windowed"], "card": smi}))
    row["windowed_t_elap_ms"] = r.t_elap_ms
    del wplan
    torch.cuda.empty_cache()
    return row, launches


def phase_options(torch, g, dev, B, gold, sel, bench_spmm, smi):
    """[options] on the main path's graph at k = 128: the default build
    through ``bench_spmm`` (err_frac <= 1e-4), then each ``fused`` name
    (True, False, "scatter", "scatter2": one build for every name, so
    each must give the default's bits), ``step_order="lex"`` (its own
    selection) and ``impl="xla"`` (the dense half as the plain product),
    each through ``bench_spmm``.  Returns the launch counts."""
    from flex_tpu_torch.ops.window_spmm import prepare_windowed, window_select

    kw = dict(dev=dev, B=B, gold=gold, iters=10, tm=256, W=128,
              min_count=64)
    B_dev = torch.from_numpy(B).cuda()
    reset_launches()
    r, plan = bench_plan(bench_spmm, g, K, "windowed", sel=sel, **kw)
    C0 = plan(B_dev)
    del plan
    out = {"default": {"t_pre_s": r.t_pre_s, "t_elap_ms": r.t_elap_ms}}
    for fused in (True, False, "scatter", "scatter2"):
        torch.cuda.empty_cache()
        plan = prepare_windowed(g, dev=dev, sel=sel, tm=256, W=128,
                                min_count=64, fused=fused)
        require_same_bits(torch, f"fused={fused}", "the default build", C0,
                          plan(B_dev))
        out[f"fused={fused}"] = {"same_bits_as_default": True}
        del plan
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sel_lex = window_select(g, tm=256, W=128, min_count=64,
                            max_dense_bytes=6 << 30, step_order="lex")
    lex_host_s = time.perf_counter() - t0
    r, plan = bench_checked(bench_spmm, g, K, "windowed", "options lex",
                            sel=sel_lex, **kw)
    out["step_order=lex"] = {"t_pre_s": r.t_pre_s, "t_elap_ms": r.t_elap_ms,
                             "select_host_s": lex_host_s,
                             "steps": sel_lex["total_steps"]}
    del plan, sel_lex
    torch.cuda.empty_cache()
    r, plan = bench_checked(bench_spmm, g, K, "windowed",
                            "options impl=xla (the plain product)", sel=sel,
                            impl="xla", **kw)
    out["impl=xla (plain product)"] = {"t_pre_s": r.t_pre_s,
                                       "t_elap_ms": r.t_elap_ms}
    del plan, C0, B_dev
    torch.cuda.empty_cache()
    launches = read_launches()
    # 14 calls a benched plan (3 on the residue kernel, 2 on kernel 1),
    # and one more call of the default build and of each fused name
    expect_launches(launches, "the options", window_spmm_fwd=14 * 2 + 5,
                    gespmm_rows=14 * 3 + 5)
    log("[options] " + json.dumps({"k": K, "runs": out, "launches": launches,
                                   "card": smi}))
    return launches


def phase_sharded(torch, g, dev, B, gold, time_cuda_ms, smi):
    """[sharded] on ``make_mesh(4)`` (on a one-card machine four entries of
    cuda:0): ``prepare_ell_sharded`` in both B layouts and
    ``prepare_windowed_sharded`` on the main path's graph at k = 128, each
    against SciPy, with its tPre, tElap, the nnz of each shard, the
    launches of one call (one or more a shard), then g_B through the
    sharded windowed plan with its training backward.  These are four
    shards on one card, not a scaling figure.  Returns (summary, launch
    counts by path)."""
    from flex_tpu_torch.parallel import (
        make_mesh, prepare_ell_sharded, prepare_windowed_sharded,
    )

    mesh = make_mesh(4)
    log(f"[sharded] mesh {mesh}: four shards on "
        f"{torch.cuda.device_count()} card(s), not a scaling figure")
    B_dev = torch.from_numpy(B).cuda()
    out, launches = {}, {}
    for layout in ("replicated", "gathered"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = prepare_ell_sharded(g, mesh, b_layout=layout, dev=dev)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        reset_launches()
        C = plan(B_dev)
        launches["sharded_ell"] = one = read_launches()
        expect_launches(one, f"sharded ELL {layout}, one call",
                        gespmm_rows=4)
        err = res_check_logged(g, C, gold, f"sharded ell {layout}")
        del C
        ms = time_cuda_ms(plan, B_dev, iters=10)
        out[f"ell_{layout}"] = {
            "t_pre_s": t_pre, "t_elap_ms": ms, "err_frac": err,
            "shard_nnz": [p.nnz for p in plan.plans],
            "ici_bytes_per_call": plan.ici_bytes_per_call(g.n, K),
            "stats": {k: v for k, v in plan.stats.items()
                      if k != "bucket_shapes"},
            "launches_one_call": one["gespmm_rows"], "note": ONE_CARD}
        log(f"[sharded] ell {layout} " + json.dumps(out[f"ell_{layout}"]))
        del plan
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = prepare_windowed_sharded(g, mesh, tm=256, W=128, min_count=64,
                                    dev=dev)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    reset_launches()
    C = plan(B_dev)
    launches["sharded_windowed"] = one = read_launches()
    expect_launches(one, "sharded windowed, one call", window_spmm_fwd=4,
                    gespmm_rows=4)
    err = res_check_logged(g, C, gold, "sharded windowed")
    require_same_bits(torch, "the sharded windowed plan", "a second call", C,
                      plan(B_dev))
    del C
    ms = time_cuda_ms(plan, B_dev, iters=10)
    out["windowed"] = {
        "t_pre_s": t_pre, "t_elap_ms": ms, "err_frac": err,
        "shard_nnz": [int(g.row_ptr[r1] - g.row_ptr[r0])
                      for r0, r1 in plan.row_bounds],
        "shard_res_nnz": list(plan.res_shard_nnz),
        "shard_sel": [list(s) for s in plan.shard_sel],
        "stats": plan.stats, "launches_one_call": {
            k: v for k, v in one.items() if v}, "note": ONE_CARD}
    log("[sharded] windowed " + json.dumps(out["windowed"]))

    # g_B through the sharded windowed plan: kernel 3 and kernel 7 on the
    # residues' transposed plans, on every shard
    rng = np.random.default_rng(1)
    co_h = rng.random((g.m, K), dtype=np.float32)
    gold_t = np.asarray(g.to_scipy().T @ co_h, dtype=np.float32)
    tplan = plan.for_training()
    del plan
    co = torch.from_numpy(co_h).cuda()
    Bg = B_dev.clone().requires_grad_()
    reset_launches()
    (tplan(Bg) * co).sum().backward()
    launches["sharded_grad"] = one = read_launches()
    expect_launches(one, "sharded windowed gradient", window_spmm_fwd=4,
                    window_bwd_gB=4, gespmm_rows=8)
    err_g = res_check_logged(g, Bg.grad, gold_t, "sharded windowed g_B",
                             row_nnz=np.bincount(g.col, minlength=g.n))

    def grad_call():
        b = B_dev.clone().requires_grad_()
        (tplan(b) * co).sum().backward()

    grad_ms = time_cuda_ms(grad_call, iters=5)
    out["windowed_grad"] = {"err_frac": err_g, "ms": grad_ms,
                            "launches": {k: v for k, v in one.items() if v}}
    log("[sharded] windowed g_B " + json.dumps(out["windowed_grad"])
        + f" ({smi}; {ONE_CARD})")
    del tplan, Bg, co, B_dev
    torch.cuda.empty_cache()
    return out, launches


def phase_parallel_2d(torch, g, dev, smi):
    """[parallel_2d] GCN(128 -> 128 -> 41) through ``make_train_step_2d`` on
    a (2, 2) mesh (rows over "x" in a sharded ELL plan, the weights'
    column blocks over "y"), Adam 1e-2: the first step's loss against the
    one-device ``make_train_step``'s from the same initial parameters
    (rtol 1e-4), 2 warm-up and 5 timed steps, a finite and falling loss,
    ms/step.  Four mesh entries on one card: not a scaling figure.
    Returns the launch counts of the 7 steps."""
    from flex_tpu_torch.io.csv_loader import make_features
    from flex_tpu_torch.models import GCN, make_train_step
    from flex_tpu_torch.ops.ell_spmm import prepare_ell
    from flex_tpu_torch.parallel import (
        Mesh, make_mesh, make_train_step_2d, prepare_ell_sharded,
    )

    mesh = Mesh(np.asarray(make_mesh(4).devices).reshape(2, 2), ("x", "y"))
    d_in, d_hid, n_cls = 128, 128, 41
    X = torch.from_numpy(make_features(g, d_in)).cuda()
    y, mask = node_labels(torch, g.m, n_cls)

    def model():
        return GCN(d_in, d_hid, n_cls, nnz=g.nnz,
                   generator=torch.Generator().manual_seed(0)).cuda()

    local = model()
    lstep = make_train_step(local, prepare_ell(g, dev=dev), torch.optim.Adam(
        local.parameters(), lr=1e-2))
    loss_1 = float(lstep(X, y, mask))
    del local, lstep
    torch.cuda.empty_cache()

    net = model()
    plan = prepare_ell_sharded(g, mesh, axis="x", dev=dev)
    step = make_train_step_2d(net, plan, torch.optim.Adam(
        net.parameters(), lr=1e-2), mesh)
    reset_launches()
    losses = [step(X, y, mask) for _ in range(2)]            # warm-up
    timed, step_ms, host_ms = timed_steps(torch, step, (X, y, mask), 5)
    launches = read_launches()
    losses = [float(x) for x in losses + timed]
    # a step: 2 shards x (2 forwards + 2 g_B through the transposed plans)
    expect_launches(launches, "7 steps of the 2-D GCN", gespmm_rows=56)
    if abs(losses[0] - loss_1) > 1e-4 * abs(loss_1):
        raise AssertionError(f"2-D first loss {losses[0]} != one-device "
                             f"{loss_1}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"2-D loss {losses}: not finite and falling")
    ms = float(np.median(step_ms))
    log("[parallel_2d] " + json.dumps({
        "mesh": str(mesh), "first_loss": losses[0],
        "one_device_first_loss": loss_1, "losses": losses,
        "ms_per_step": ms, "ms_per_step_host": host_ms, "step_ms": step_ms,
        "launches_7_steps": launches,
        "note": ONE_CARD,
        "card": smi}))
    del plan, step, net, X
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the headline, the entry points and the examples
# ---------------------------------------------------------------------------

# the phases whose launch counts join every row as well
ENTRY_PHASES = ("headline", "entry", "dryrun_multichip",
                "example_gcn_windowed", "example_gcn_pubmed",
                "example_gat_pubmed")
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "t_pre_s",
                 "t_elap_ms", "pre_elap_ratio", "method", "err_frac",
                 "model_elap_ratio", "secondary_ell_gflops",
                 "secondary_ell_pre_ratio", "device")
EXAMPLE_STEPS = 5
# each example's hand kernels, by wrapper
EXAMPLE_WRAPPERS = {
    "gcn_windowed": ("window_spmm_fwd", "window_bwd_gB", "gespmm_rows"),
    "gcn_pubmed": ("gespmm_rows",),
    "gat_pubmed": ("gespmm_rows",)}


def phase_headline(g, cli_auto):
    """[headline] ``python3 bench_torch.py`` in a child process, on the graph
    that ``load_graph`` cached: exit 0, exactly one stdout line with the
    headline's keys, err_frac <= 1e-4, value > 0, and the method that
    ``suggest`` chooses here.  For a method the command line checks, its
    kernels launch 15 times (the cold call, 3 warm-up, 10 timed, the checked
    one) and kernel 7 13 more (the secondary ELL row: warm-up and timed).
    Returns (the line as a dict, the child's launch counts)."""
    from flex_tpu_torch.bench.autotune import suggest

    sug = suggest(g, K, win_min_count=64, max_dense_bytes=6 << 30)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "bench_torch.py"], cwd=root,
                       capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in p.stderr.splitlines():
        log(f"[headline] | {line}")
    if p.returncode != 0:
        raise AssertionError(f"[headline] exited {p.returncode}")
    lines = p.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"[headline] printed {len(lines)} stdout lines")
    out = json.loads(lines[0])
    missing = [key for key in HEADLINE_KEYS if key not in out]
    if missing:
        raise AssertionError(f"[headline] line lacks {missing}")
    if not (out["err_frac"] <= 1e-4 and out["value"] > 0):
        raise AssertionError(f"[headline] err_frac {out['err_frac']}, value "
                             f"{out['value']}")
    if out["method"] != sug.method:
        raise AssertionError(f"[headline] ran {out['method']}, suggest "
                             f"chooses {sug.method}")
    m = re.search(r"kernel launches: (\{.*\})\s*$", p.stderr, re.M)
    if m is None:
        raise AssertionError("[headline] printed no launch counts")
    launches = json.loads(m.group(1))
    plan = sug.method + (" transposed" if sug.prep_kwargs.get("transposed")
                         else "")
    if plan in CLI_WRAPPERS:
        want = {w: 15 for w in CLI_WRAPPERS[plan]}
        want["gespmm_rows"] = want.get("gespmm_rows", 0) + 13
        expect_launches(launches, "[headline]", **want)
    elif launches["gespmm_rows"] < 13:
        raise AssertionError(f"[headline] launched {launches}")
    log(f"[headline] {lines[0]}")
    log("[headline] " + json.dumps({
        "t_elap_ms": out["t_elap_ms"],
        "cli_auto_k128_t_elap_ms": cli_auto["t_elap_ms"],
        "cli_auto_k128_method": cli_auto["method"], "seconds": secs,
        "launches": launches}))
    return out, launches


def phase_entry(torch, time_cuda_ms, smi):
    """[entry] ``entry()``: its forward on the card against the same
    forward through the plan's plain version (max |diff| <= 1e-4 *
    max(1, max |plain|)), a second call with the same bits, kernel 7
    launched once a layer; then ``dryrun_multichip(4)`` on one card, which
    must launch kernels 1, 3 and 7.  Returns (the launch counts of the two
    forwards, those of the dry run)."""
    from flex_tpu_torch.entry import dryrun_multichip, entry
    from flex_tpu_torch.ops.ell_spmm import ell_spmm_plain

    fn, (model, plan, X) = entry()
    with torch.no_grad():
        reset_launches()
        out = fn(model, plan, X)
        again = fn(model, plan, X)
        torch.cuda.synchronize()
        launches = read_launches()
        ref = fn(model, lambda B: ell_spmm_plain(plan, B), X)
        ms = time_cuda_ms(fn, model, plan, X, iters=20)
        plain_ms = time_cuda_ms(fn, model, lambda B: ell_spmm_plain(plan, B),
                                X, iters=20)
    expect_launches(launches, "two entry() forwards", gespmm_rows=4)
    require_same_bits(torch, "entry()'s forward", "the Pubmed-sized graph",
                      out, again)
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    if tuple(out.shape) != (X.shape[0], 3) or not bool(
            torch.isfinite(out).all()) or err > 1e-4 * scale:
        raise AssertionError(f"entry(): output {tuple(out.shape)}, max |diff| "
                             f"{err} against plain (scale {scale})")
    del fn, model, plan, X, out, again, ref
    reset_launches()
    t0 = time.perf_counter()
    loss = dryrun_multichip(4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dry = read_launches()
    if min(dry[w] for w in ("window_spmm_fwd", "window_bwd_gB",
                            "gespmm_rows")) < 1:
        raise AssertionError(f"dryrun_multichip(4) launched {dry}")
    log("[entry] " + json.dumps({
        "forward_ms": ms, "forward_plain_ms": plain_ms, "max_abs_err": err,
        "scale": scale, "launches_two_forwards": launches,
        "dryrun_loss": loss, "dryrun_seconds": secs,
        "dryrun_launches": dry, "note": ONE_CARD, "card": smi}))
    torch.cuda.empty_cache()
    return launches, dry


def check_example_plan(torch, g, plan, label):
    """Kernels 1 and 3 on the windowed example's own plan at the widths
    its layers give them (64, then 8 after W2), each against its plain
    version: the forward on the example's features, g_B on a seeded
    cotangent of plan(B) carried to the dense half.  Returns the worst
    max_abs_err of each."""
    from flex_tpu_torch.io import make_features

    rng = np.random.default_rng(3)
    X = torch.from_numpy(make_features(g, 64)).cuda()
    t = {"first": plan.first, "out_panel": plan.out_panel,
         "win_step": plan.win_step, "A": plan.A}
    ts, tg, _ = plan.bwd_tabs
    tabs = {"slot_s": ts, "slot_g": tg, "slot_ptr": plan.slot_ptr,
            "n_blk_used": plan.n_blk_used, "units": plan.slot_units}
    errs = {"window_spmm_fwd": 0.0, "window_bwd_gB": 0.0}
    for k in (64, 8):
        B = X if k == X.shape[1] else X[:, :k].contiguous()
        e = check_window_kernel(torch, dict(t, B=B), plan.n_used_panels,
                                plan.W, plan.panel_step_ptr,
                                f"{label} k={k}", units=plan.panel_units)
        errs["window_spmm_fwd"] = max(errs["window_spmm_fwd"], e)
        co = torch.from_numpy(rng.random((plan.m, k), dtype=np.float32))
        e = check_gB_kernel(torch, tabs, plan.out_panel, plan.A,
                            dense_cotangent(torch, plan, co.cuda()), plan.W,
                            f"{label} k={k}")
        errs["window_bwd_gB"] = max(errs["window_bwd_gB"], e)
    return errs


def phase_examples(torch, smi):
    """[examples] each training example at its default size for
    ``EXAMPLE_STEPS`` steps on the card: a finite loss that falls, the
    median ms/step (host clock, each step ends by reading its loss), its
    peak memory above what the process held before it, and each of its
    hand kernels launched.  The windowed example's plan, caught as it is
    built, then holds kernels 1 and 3 to their plain versions at its
    widths.  Returns the launch counts by example."""
    from flex_tpu_torch.examples import (
        train_gat_pubmed, train_gcn_pubmed, train_gcn_windowed,
    )
    from flex_tpu_torch.ops import window_spmm

    built = []
    prepare = window_spmm.prepare_windowed

    def catch_plan(g, *args, **kw):
        plan = prepare(g, *args, **kw)
        built.append((g, plan))
        return plan

    out = {}
    for name, mod in (("gcn_windowed", train_gcn_windowed),
                      ("gcn_pubmed", train_gcn_pubmed),
                      ("gat_pubmed", train_gat_pubmed)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        window_spmm.prepare_windowed = catch_plan
        try:
            reset_launches()
            t0 = time.perf_counter()
            r = mod.main(EXAMPLE_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
        finally:
            window_spmm.prepare_windowed = prepare
        losses = [r["loss0"]] + r["losses"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"[examples] {name}: loss {losses}: not "
                                 f"finite and falling")
        if min(launches[w] for w in EXAMPLE_WRAPPERS[name]) < 1:
            raise AssertionError(f"[examples] {name} launched {launches}")
        peak = torch.cuda.max_memory_allocated() - held
        errs = None
        if name == "gcn_windowed":
            if len(built) != 1:
                raise AssertionError(f"[examples] {name} built {len(built)} "
                                     f"windowed plans")
            errs = check_example_plan(torch, *built.pop(),
                                      "the windowed example's plan")
        log(f"[examples] {name} " + json.dumps({
            "steps": EXAMPLE_STEPS, "losses": losses,
            "ms_per_step": r["ms_per_step"], "seconds": secs,
            "peak_memory_above_held": peak, "held_before": held,
            "launches": launches, "max_abs_err_vs_plain": errs,
            "card": smi}))
        out[f"example_{name}"] = launches
    return out


# ---------------------------------------------------------------------------
# the probes of experiments/: kernels 8-11
# ---------------------------------------------------------------------------

# the probes' mains: each timed call is 1 checked + 3 warm-up + 10 timed
# (3 timed in m3_row_dma); m6_vmem_probe launches 48..227 KB, and 228 KB
# is refused before it launches
MICRO_LAUNCHES = dict(ell_reduce=28, row_gather_sum=21, smem_probe=5,
                      slab_gather=42)


def require_plain_bits(torch, name, label, out, ref):
    """A kernel whose plain version takes its sums in the kernel's order,
    or copies: the same bits.  Returns max_abs_err (0)."""
    if out.shape != ref.shape or not torch.equal(out, ref):
        diff = (float((out - ref).abs().max()) if out.shape == ref.shape
                else f"shape {tuple(out.shape)} != {tuple(ref.shape)}")
        raise AssertionError(f"{name} on {label} differs from plain: {diff}")
    log(f"[kernel-vs-plain] {name} {label}: the plain version's bits")
    return 0.0


def check_ell_reduce(torch, v, Bg, label):
    """Kernel 11 (fmaf over j in order) against the plain product and sum,
    to the f32 order bound 2·w·eps·Σ_j |v·Bg|."""
    from flex_tpu_torch.experiments import micro

    out = micro.ell_reduce(v, Bg)
    ref = micro.ell_reduce_plain(v, Bg)
    absprod = (v.abs()[:, :, None] * Bg.abs()).sum(1)
    return hold_to_plain(torch, "ell_reduce", label, out, ref, absprod,
                         v.shape[1])


def phase_micro_kernels_vs_plain(torch, dev="cuda"):
    """Phase 3 for kernels 8-11 at the edges of their shapes: kernel 8 with
    0, 1, 7 and 1001 rows a step, k = 128, 64 and 36, both ring depths;
    kernel 9 at 48 and 227 KB; kernel 10 in both placements, with and
    without bf16 rounding, on a slab of 1000 rows (not a multiple of the
    cluster's 16 blocks) at k = 36; kernel 11 at w = 40 (two passes of 32)
    and k = 200 (two column slices)."""
    from flex_tpu_torch.experiments import micro

    gen = torch.Generator(device=dev).manual_seed(5)
    B = torch.rand((5000, 128), generator=gen, device=dev) * 2 - 1
    for S, n, depth, k in ((3, 0, 8, 128), (3, 1, 16, 128), (4, 7, 16, 128),
                           (5, 1001, 8, 64), (2, 300, 16, 36),
                           (9, 1024, 8, 128)):
        Bk = B[:, :k].contiguous()
        idx = torch.randint(0, 5000, (S, n), generator=gen, device=dev,
                            dtype=torch.int32)
        require_plain_bits(torch, "row_gather_sum",
                           f"{S} steps x {n} rows k={k} depth={depth}",
                           micro.row_gather_sum(Bk, idx, depth),
                           micro.row_gather_sum_plain(Bk, idx))
    x = torch.rand((8, 128), generator=gen, device=dev)
    for kb in (48, 227):
        require_plain_bits(torch, "smem_probe", f"{kb} KB",
                           micro.smem_probe(x, kb * 1024),
                           micro.smem_probe_plain(x, kb * 1024))
    slab = torch.rand((1000, 36), generator=gen, device=dev) * 2 - 1
    idx = torch.randint(0, 1000, (777,), generator=gen, device=dev,
                        dtype=torch.int32)
    for placement in micro.PLACEMENTS:
        for rnd in (False, True):
            require_plain_bits(
                torch, "slab_gather", f"U=1000 k=36 {placement} bf16={rnd}",
                micro.slab_gather(slab, idx, placement, rnd),
                micro.slab_gather_plain(slab, idx, rnd))
    for N, w, k in ((100, 40, 200), (7, 1, 4), (33, 32, 128)):
        v = torch.rand((N, w), generator=gen, device=dev) * 2 - 1
        Bg = torch.rand((N, w, k), generator=gen, device=dev) * 2 - 1
        check_ell_reduce(torch, v, Bg, f"N={N} w={w} k={k}")
    torch.cuda.synchronize()


def phase_winstep_kernel_vs_plain(torch, dev="cuda"):
    """Phase 3 for kernel 12: panels of 1, 8, 9 and 17 steps (one unit,
    exactly one, one plus one and three units) with an all-sentinel step
    and trailing empty panels, G = 4 and 8, k = 128, 41 (one B box of
    the column tile) and 200 (two column tiles), n % W != 0; W = 48
    (stages of 16) at G = 4; TM = 200 (a partial row tile: the second
    warpgroup's rows past TM), also at W = 48; a misaligned B.  Each
    launched twice for equal bits."""
    rng = np.random.default_rng(12)
    steps = [1, 8, 9, 17]
    for G, W, TM in ((4, 128, 256), (8, 128, 256), (4, 48, 256),
                     (4, 128, 200), (4, 48, 200)):
        t, n_panels, W, ptr = random_window_case(
            torch, rng, steps, 20_000 + 37, dev, TM=TM, G=G, W=W,
            sentinel_steps=(3,))
        for k in (K, 41, 200):
            B = t["B"] if k == K else \
                torch.rand((t["B"].shape[0], k), device=dev) * 2 - 1
            check_window_kernel(torch, dict(t, B=B), n_panels, W, ptr,
                                f"steps={steps} G={G} W={W} TM={TM} k={k}",
                                bf16=True)
        # B 4 bytes past a 16-byte boundary: the cast's copy is aligned
        buf = torch.rand((t["B"].numel() + 1,), device=dev) * 2 - 1
        Bm = buf[1:].view(t["B"].shape)
        check_window_kernel(torch, dict(t, B=Bm), n_panels, W, ptr,
                            f"steps={steps} G={G} W={W} TM={TM} misaligned B",
                            bf16=True)
        del t, buf, Bm
    torch.cuda.synchronize()


def micro_times(torch, time_cuda_ms, kernel, plain, library, args,
                iters=20):
    """(kernel ms, plain ms, library ms or None) on the same inputs."""
    ms = time_cuda_ms(kernel, *args, iters=iters)
    plain_ms = time_cuda_ms(plain, *args, iters=5)
    lib_ms = None if library is None else time_cuda_ms(library, *args,
                                                       iters=iters)
    return ms, plain_ms, lib_ms


def launch_path_us(torch, x, nbytes, n=2000):
    """Host-clock microseconds a call of kernel 9's ``kernels.launch``
    alone (its arguments made once) and of its wrapper, over ``n`` calls
    each, the card synchronised at the end."""
    from flex_tpu_torch import kernels
    from flex_tpu_torch.experiments import micro

    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), nbytes)
    res = []
    for call in (lambda: kernels.launch("micro", "flex_smem_probe", x.device,
                                        *args),
                 lambda: micro.smem_probe(x, nbytes)):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        res.append((time.perf_counter() - t0) / n * 1e6)
    return tuple(res)


def phase_micro(torch, peaks, time_cuda_ms, smi, kernel7_rows, kernel7_ms):
    """[micro] the four probes' ``main`` in process at the scripts' sizes
    (the launch counts set to 0 just before and read just after), u16x2's
    rebuilt rows bit-exact; then each of kernels 8-11 on the scripts'
    inputs held to its plain version (bits for 8, 9 and 10; the f32 order
    bound for 11), its time beside the plain version's, the library
    call's and the bound; kernels 8-10 and their library calls also on
    the card alone (``time_device_ms``: 200 calls in a CUDA graph),
    kernel 9 beside clone's, the empty launch's at 48 and 227 KB (its
    floor) and the host clock of ``kernels.launch`` alone.  Kernel 8 also
    at 7,520 steps of 1024 rows (m2_gather_bw's 7.70 M rows, through
    m3_row_dma's parameters) beside
    kernel 7's gather rate in this run: ``kernel7_rows`` B rows (one a
    nonzero of the main path's graph) in ``kernel7_ms``, its time at
    k = 128 on the GE-SpMM plan.  Kernel 10 in both placements, with and
    without bf16 rounding.  Returns the four rows of the kernels line."""
    import torch.nn.functional as F
    from flex_tpu_torch.bench.harness import time_device_ms
    from flex_tpu_torch.experiments import (
        micro, micro_dma_u16, micro_ellreduce, micro_tpu, micro_vmem_gather,
    )

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    res = {}
    reset_launches()
    for mod in (micro_ellreduce, micro_dma_u16, micro_tpu, micro_vmem_gather):
        name = mod.__name__.rsplit(".", 1)[1]
        log(f"[micro] {mod.__name__}.main(), as python -m {mod.__name__}:")
        t1 = time.perf_counter()
        res[name] = mod.main()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[micro] {name}: {time.perf_counter() - t1:.1f}s")
    launches = read_launches()
    expect_launches(launches, "the probes' mains", **MICRO_LAUNCHES)
    t_mains = time.perf_counter() - t0
    if not res["micro_dma_u16"]["u16x2"]["bits_equal"]:
        raise AssertionError("u16x2: the rebuilt rows are not B's bits")
    probe = res["micro_tpu"]["m6_vmem_probe"]
    log(f"[micro] u16x2 rebuilds f32 exactly (max abs diff "
        f"{res['micro_dma_u16']['u16x2']['max_abs_diff']}); smem probe: "
        f"{probe['ok_kb']} KB launched, {probe['refused_kb']} KB refused, "
        f"opt-in limit {probe['limit_bytes']} B")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    # kernel 8: E1 (64 steps, 16 deep), E2 (32 steps, 8 deep), 7.70 M rows
    B = torch.rand((262144, K), generator=gen, device=dev)
    k8 = {}
    for tag, S, depth in (("e1", 64, 16), ("e2", 32, 8),
                          ("7520_steps", 7520, 8)):
        idx = torch.randint(0, B.shape[0], (S, 1024), generator=gen,
                            device=dev, dtype=torch.int32)
        out = micro.row_gather_sum(B, idx, depth)
        require_plain_bits(torch, "row_gather_sum",
                           f"{S} steps x 1024 rows depth={depth}", out,
                           micro.row_gather_sum_plain(B, idx))
        lib_err = float((F.embedding_bag(idx, B, mode="sum") - out).abs()
                        .max())
        ms, plain_ms, lib_ms = micro_times(
            torch, time_cuda_ms,
            lambda b, i: micro.row_gather_sum(b, i, depth),
            micro.row_gather_sum_plain,
            lambda b, i: F.embedding_bag(i, b, mode="sum"), (B, idx))
        device_ms = time_device_ms(micro.row_gather_sum, B, idx, depth)
        lib_device_ms = time_device_ms(
            lambda b, i: F.embedding_bag(i, b, mode="sum"), B, idx)
        rows = idx.numel()
        distinct = int(torch.unique(idx).numel())
        bound_ms, bound_by = bound(distinct * K * 4 + rows * 4 + S * K * 4,
                                   rows * K, peaks)
        k8[tag] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "library_device_ms": lib_device_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_ms_gathered": rows * K * 4 / peaks["bytes"] * 1e3,
                   "rows": rows, "distinct_rows": distinct,
                   "g_rows_per_s": rows / ms / 1e6,
                   "gathered_tbps": rows * K * 4 / ms / 1e9,
                   "library_max_abs_diff": lib_err}
        log(f"[micro] row_gather_sum {tag}: " + json.dumps(k8[tag]))
        del idx, out
    big = k8["7520_steps"]
    k7_rate = kernel7_rows / kernel7_ms / 1e6
    take = res["micro_tpu"]["m2_gather_bw"]["m_rows_per_s"] / 1e3
    log(f"[micro] kernel 8 at {big['rows']} rows: {big['g_rows_per_s']:.3f} "
        f"G rows/s ({big['gathered_tbps']:.3f} TB/s of gathered rows); "
        f"kernel 7 in this run (GE-SpMM plan, k=128) gathers {kernel7_rows} "
        f"rows in {kernel7_ms:.4f} ms = {k7_rate:.3f} G rows/s "
        f"({k7_rate * K * 4 / 1e3:.3f} TB/s); m2_gather_bw's index_select "
        f"{take:.3f} G rows/s")
    del B
    e1 = k8["e1"]
    row8 = {
        "name": "row_gather_sum", "route": "cuda",
        "source": "flex_tpu_torch/csrc/micro.cu",
        "replaces": "experiments/micro_dma_u16.py:27",
        "also_replaces": "experiments/micro_tpu.py:141",
        "launches": launches["row_gather_sum"], "max_abs_err": 0.0,
        **{f: e1[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_device_ms")},
        **{f"{tag}_{f}": r[f] for tag, r in k8.items() if tag != "e1"
           for f in r},
        "e1_bound_ms_gathered": e1["bound_ms_gathered"],
        "kernel7_g_rows_per_s": k7_rate,
    }

    # kernel 9 at the limit: x through 227 KB.  It moves 8 KB, so a call's
    # events measure the host's path to the launch: its time, clone's and
    # the empty launch's are taken on the card alone (a CUDA graph of 200
    # calls), the per-call figures kept beside them
    x = torch.rand((8, 128), generator=gen, device=dev)
    nbytes = probe["limit_bytes"]
    require_plain_bits(torch, "smem_probe", f"{nbytes} B",
                       micro.smem_probe(x, nbytes),
                       micro.smem_probe_plain(x, nbytes))
    ms_call, plain_call, lib_call = micro_times(
        torch, time_cuda_ms, micro.smem_probe, micro.smem_probe_plain,
        lambda a, n: a.clone(), (x, nbytes))
    dev_ms = {f"{kb}kb": time_device_ms(micro.smem_probe, x, kb * 1024)
              for kb in (48, nbytes // 1024)}
    empty_ms = {f"{kb}kb": time_device_ms(micro.empty_probe, kb * 1024)
                for kb in (48, nbytes // 1024)}
    ms = time_device_ms(micro.smem_probe, x, nbytes)
    plain_ms = time_device_ms(micro.smem_probe_plain, x, nbytes)
    lib_ms = time_device_ms(lambda a: a.clone(), x)
    floor_ms = time_device_ms(micro.empty_probe, nbytes)
    launch_us, wrapper_us = launch_path_us(torch, x, nbytes)
    # 8 KB moved: the bytes bound; the empty launch at 227 KB is the floor
    bound_ms, bound_by = bound(2 * x.numel() * 4, 0, peaks)
    row9 = {"name": "smem_probe", "route": "cuda",
            "source": "flex_tpu_torch/csrc/micro.cu",
            "replaces": "experiments/micro_tpu.py:116",
            "launches": launches["smem_probe"], "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library_call": "x.clone()", "timing": "device: CUDA graph of "
            "200 calls", "launch_floor_ms": floor_ms,
            "device_ms_by_size": dev_ms, "empty_launch_ms_by_size": empty_ms,
            "per_call_ms": ms_call, "plain_per_call_ms": plain_call,
            "library_per_call_ms": lib_call, "launch_us": launch_us,
            "wrapper_us": wrapper_us,
            "largest_kb_launched": probe["ok_kb"],
            "refused_kb": probe["refused_kb"],
            "optin_limit_bytes": nbytes}
    log(f"[micro] smem_probe on the card alone: {ms * 1e3:.2f} us a call "
        f"at {nbytes} B ({dev_ms['48kb'] * 1e3:.2f} us at 48 KB); "
        f"x.clone() {lib_ms * 1e3:.2f} us; the empty launch "
        f"{floor_ms * 1e3:.2f} us ({empty_ms['48kb'] * 1e3:.2f} us at 48 "
        f"KB); plain {plain_ms * 1e3:.2f} us.  Per call, events around each "
        f"call: {ms_call * 1e3:.2f} us, clone {lib_call * 1e3:.2f} us.  Host "
        f"clock a call: kernels.launch alone {launch_us:.2f} us, the "
        f"wrapper {wrapper_us:.2f} us")

    # kernel 10: the script's slab and 16 steps of 8192 rows
    slab = torch.rand((micro_vmem_gather.U, micro_vmem_gather.K),
                      generator=gen, device=dev)
    idx = torch.randint(0, slab.shape[0], (micro_vmem_gather.STEPS * 8,
                                           micro_vmem_gather.RB),
                        generator=gen, device=dev, dtype=torch.int32)
    clusters = micro.cluster_occupancy(*slab.shape)
    k10 = {}
    for placement in micro.PLACEMENTS:
        for rnd in (False, True):
            require_plain_bits(
                torch, "slab_gather",
                f"{idx.numel()} rows placement={placement} bf16={rnd}",
                micro.slab_gather(slab, idx, placement, rnd),
                micro.slab_gather_plain(slab, idx, rnd))
            k10[(placement, rnd)] = micro_times(
                torch, time_cuda_ms,
                lambda s, i: micro.slab_gather(s, i, placement, rnd),
                lambda s, i: micro.slab_gather_plain(s, i, rnd),
                lambda s, i: torch.index_select(
                    s.bfloat16().float() if rnd else s, 0, i.reshape(-1)),
                (slab, idx))
    k10_device = {
        f"{pl}{'_bf16' if rnd else ''}_device_ms": time_device_ms(
            micro.slab_gather, slab, idx, pl, rnd)
        for pl in micro.PLACEMENTS for rnd in (False, True)}
    k10_device["library_device_ms"] = time_device_ms(
        torch.index_select, slab, 0, idx.reshape(-1))
    rows = idx.numel()
    bound_ms, bound_by = bound(rows * K * 4 + slab.numel() * 4 + rows * 4,
                               0, peaks)
    ms, plain_ms, lib_ms = k10[("l2", False)]
    row10 = {"name": "slab_gather", "route": "cuda",
             "source": "flex_tpu_torch/csrc/micro.cu",
             "replaces": "experiments/micro_vmem_gather.py:34",
             "launches": launches["slab_gather"], "max_abs_err": 0.0,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms,
             "clusters_of_16": clusters, "rows": rows,
             "device_ms": k10_device["l2_device_ms"],
             **{f"{pl}{'_bf16' if rnd else ''}_{f}": t
                for (pl, rnd), ts in k10.items()
                for f, t in zip(("ms", "plain_ms", "library_ms"), ts)},
             **k10_device}
    log(f"[micro] slab_gather: cudaOccupancyMaxActiveClusters = {clusters} "
        f"clusters of 16 blocks x {slab.shape[0] // 16 * K * 4} B; " +
        json.dumps({k: v for k, v in row10.items() if k.startswith(
            ("l2", "cluster", "library_device"))}))
    del slab, idx

    # kernel 11: the script's v and Bg (3.4 GB)
    v, Bg = micro_ellreduce.make_inputs(device=dev)
    err = check_ell_reduce(torch, v, Bg, "the script's N=208000 w=32 k=128")
    ms, plain_ms, lib_ms = micro_times(
        torch, time_cuda_ms, micro.ell_reduce, micro.ell_reduce_plain,
        lambda a, b: torch.bmm(a[:, None, :], b), (v, Bg))
    N, w, k = Bg.shape
    bound_ms, bound_by = bound(N * w * k * 4 + N * w * 4 + N * k * 4,
                               2 * N * w * k, peaks)
    row11 = {"name": "ell_reduce", "route": "cuda",
             "source": "flex_tpu_torch/csrc/micro.cu",
             "replaces": "experiments/micro_ellreduce.py:38",
             "also_replaces": "experiments/micro_ellreduce.py:63",
             "launches": launches["ell_reduce"], "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms,
             "library_call": "torch.bmm, TF32 off"}
    log(f"[micro] ell_reduce: {ms:.4f} ms, plain {plain_ms:.4f}, bmm "
        f"{lib_ms:.4f}, bound {bound_ms:.4f} ({bound_by})")
    del v, Bg
    torch.cuda.empty_cache()
    log(f"[micro] phase took {time.perf_counter() - t0:.1f}s (the four "
        f"mains {t_mains:.1f}s); {smi}")
    return [row8, row9, row10, row11]


# ---------------------------------------------------------------------------
# E7 and E8, the precision pair, the windowed and training studies
# ---------------------------------------------------------------------------

# the dense bf16 tensor-core rate of an H100 SXM5 at 700 W (NVIDIA's data
# sheet), kernel 12's operations bound
BF16_TC_PEAK = 989e12
# micro_winstep.main(): 5 rows of 1 checked + 3 warm-up + 10 timed calls,
# three on kernel 1 (highest) and two on kernel 12 (default)
WINSTEP_LAUNCHES = dict(window_spmm_fwd=42, window_step_bf16=28)


def winstep_bytes_flops(t, A, k):
    """Bytes (A, the distinct B windows and the step table read once, C
    written once) and operations of one E7 call on tables ``t``."""
    S, TM, GW = A.shape
    W = GW // (t["win"].numel() // S)
    distinct = int(t["win"].unique().numel())
    n_bytes = (A.numel() * 4 + distinct * W * k * 4 + t["win"].numel() * 4
               + t["n_panels"] * TM * k * 4)
    return n_bytes, 2 * S * TM * GW * k


def phase_winstep(torch, g, peaks, smi, dev="cuda"):
    """[winstep] micro_winstep.main() at the script's sizes (the counts
    set to 0 just before, read just after: kernel 1 runs its highest rows,
    kernel 12 its default rows); kernels 1 and 12 against their plain
    versions on E7's own G = 4 tables (main's first rows' window ids);
    kernel 12's ms at G = 4 and 8, plain, library, bound, launches, the B
    cast's ms apart, its ms with B's windows held in L2 and its tiles'
    waves over the SMs, its stages and shared memory a block and ptxas
    registers and spills; then the precision ladder, micro_precision.main() and
    high_precision_host.main() on the main path's graph.  Returns (kernel
    12's row, kernel 1's E7 columns, the launches)."""
    from flex_tpu_torch.bench.harness import time_cuda_ms
    from flex_tpu_torch.experiments import (
        high_precision_host, micro, micro_precision, micro_winstep as mw,
    )
    from flex_tpu_torch.ops.gespmm import to_bf16_padded

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("[winstep] flex_tpu_torch.experiments.micro_winstep.main(), as "
        "python -m flex_tpu_torch.experiments.micro_winstep:")
    reset_launches()
    res = mw.main()
    launches = read_launches()
    expect_launches(launches, "micro_winstep.main()", **WINSTEP_LAUNCHES)
    t_main = time.perf_counter() - t0
    torch.cuda.empty_cache()

    G, spp = 4, 4
    S = mw.WINDOWS // G
    t = mw.step_tables(G, S, spp, -(-mw.m // mw.W), np.random.default_rng(0),
                       dev)
    tabs = {"first": t["first"], "out_panel": t["out_panel"],
            "win_step": t["win"], "A": mw.make_a(G, S, device=dev),
            "B": mw.make_b_pad(device=dev)}
    label = f"E7 G={G} S={S} {spp} steps a panel"
    err1 = check_window_kernel(torch, tabs, t["n_panels"], mw.W, t["ptr"],
                               label, units=t["units"])
    err12 = check_window_kernel(torch, tabs, t["n_panels"], mw.W, t["ptr"],
                                label, units=t["units"], bf16=True)
    n_bytes, n_flops = winstep_bytes_flops(t, tabs["A"], mw.k)
    del tabs, t
    torch.cuda.empty_cache()
    bound1, by1 = bound(n_bytes, n_flops, peaks)
    t_b = n_bytes / peaks["bytes"] * 1e3
    t_f = n_flops / BF16_TC_PEAK * 1e3
    bound12, by12 = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
    d4, h4 = res[f"G={G} spp={spp} default"], res[f"G={G} spp={spp} highest"]
    d8, h8 = res["G=8 spp=4 default"], res["G=8 spp=4 highest"]
    ptxas = ptxas_summary(kernel_usage("winstep_bf16",
                                       "winstep_wgmma_kernel"))
    layout = micro.winstep_layout(mw.W)
    B_pad = mw.make_b_pad(device=dev)
    b_cast_ms = time_cuda_ms(to_bf16_padded, B_pad, iters=20)
    del B_pad
    # what limits it: the same A stream with B's windows drawn from 64
    # blocks (2 MB of bf16, held in L2), and the tiles' waves over the SMs
    l2_b = mw.run(G, S, "default", spp, device=dev, m=64 * mw.W,
                  yardsticks=False)
    l2_b.pop("out")
    torch.cuda.empty_cache()
    waves = S // spp / torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[winstep] kernel 12 (window_step_bf16) on E7 at G=4: "
        f"{d4['ms']:.4f} ms = {n_flops / d4['ms'] / 1e9:.1f} TFLOP/s bf16 "
        f"({d4['dma_gbps']:.0f} GB/s of the script's count, "
        f"{n_bytes / d4['ms'] / 1e9:.3f} TB/s of the bound's bytes); G=8 "
        f"{d8['ms']:.4f} ms; the B cast inside the call "
        f"{b_cast_ms:.4f} ms apart; plain {d4['plain_ms']:.4f} ms; library "
        f"({d4['library_call']}) {d4['library_ms']:.4f} ms, its gather "
        f"{d4['gather_ms']:.4f} and cast {d4['cast_ms']:.4f} ms apart; "
        f"bound {bound12:.4f} ms ({by12}: {n_bytes / 1e9:.3f} GB, "
        f"{n_flops / 1e9:.1f} GFLOP); launches "
        f"{launches['window_step_bf16']}; {layout['stages']} stages of "
        f"BK={layout['bk']}, {layout['smem_bytes']} B of shared memory a "
        f"block; ptxas {ptxas}; with B's windows held in L2 (64 blocks) "
        f"{l2_b['ms']:.4f} ms; {S // spp} tiles = {waves:.2f} waves of one "
        f"block an SM")
    log(f"[winstep] kernel 1 (window_spmm_fwd) on E7 at G=4: "
        f"{h4['ms']:.4f} ms = {n_flops / h4['ms'] / 1e9:.1f} TFLOP/s f32; "
        f"G=8 {h8['ms']:.4f} ms; one step a panel "
        f"{res['G=4 spp=1 highest']['ms']:.4f} ms; plain "
        f"{h4['plain_ms']:.4f} ms; library ({h4['library_call']}) "
        f"{h4['library_ms']:.4f} ms; bound {bound1:.4f} ms ({by1}); "
        f"launches {launches['window_spmm_fwd']}")

    log("[winstep] the precision ladder: micro_precision.main()")
    reset_launches()
    prec = micro_precision.main()
    launches_prec = read_launches()
    if prec["highest"]["frac_beyond_tol"] != 0.0:
        raise AssertionError(f"micro_precision: the f32 row has "
                             f"{prec['highest']['frac_beyond_tol']} beyond "
                             f"tolerance")
    log("[winstep] high_precision_host.main() on the main path's graph")
    hp = high_precision_host.main(graph=g)
    if hp["highest"]["n_bad"]:
        raise AssertionError(f"high_precision_host: the f32 dense half has "
                             f"{hp['highest']['n_bad']} rows beyond "
                             f"tolerance")
    torch.cuda.empty_cache()
    log(f"[winstep] phase took {time.perf_counter() - t0:.1f}s (main "
        f"{t_main:.1f}s); {smi}")
    row12 = {
        "name": "window_step_bf16", "route": "cuda",
        "source": "flex_tpu_torch/csrc/winstep_bf16.cu",
        "replaces": "experiments/micro_winstep.py:29",
        "launches": launches["window_step_bf16"], "max_abs_err": err12,
        "ms": d4["ms"], "plain_ms": d4["plain_ms"], "bound_ms": bound12,
        "bound_by": by12, "library_ms": d4["library_ms"],
        "library_call": d4["library_call"], "library_gather_ms":
        d4["gather_ms"], "library_cast_ms": d4["cast_ms"],
        "tflops": n_flops / d4["ms"] / 1e9, "ms_g8": d8["ms"],
        "plain_ms_g8": d8["plain_ms"], "library_ms_g8": d8["library_ms"],
        "b_cast_ms": b_cast_ms, "ms_b_in_l2": l2_b["ms"], "waves": waves,
        "stages": layout["stages"],
        "bk": layout["bk"], "smem_bytes": layout["smem_bytes"],
        "ptxas": ptxas,
        "launches_precision": launches_prec["window_step_bf16"],
        "ladder": {k: {f: v[f] for f in ("ms", "tflops", "max_rel",
                                         "frac_beyond_tol", "how")}
                   for k, v in prec.items() if k != "device"},
        "high_precision_host": {k: v for k, v in hp.items()
                                if k != "device"}}
    k1 = {"launches_winstep": launches["window_spmm_fwd"],
          "winstep_ms": h4["ms"], "winstep_ms_g8": h8["ms"],
          "winstep_ms_one_step_a_panel": res["G=4 spp=1 highest"]["ms"],
          "winstep_plain_ms": h4["plain_ms"],
          "winstep_library_ms": h4["library_ms"],
          "winstep_bound_ms": bound1, "winstep_bound_by": by1,
          "winstep_max_abs_err": err1,
          "winstep_tflops": n_flops / h4["ms"] / 1e9}
    return row12, k1, launches


def phase_band_v2(torch, kernel5_ms, smi):
    """[band_v2] pallas_band_v2.main() at the script's size (the counts set
    to 0 just before, read just after): kernel 5 on the script's split,
    err_frac <= 1e-4 against SciPy, its ms beside phase 12's."""
    from flex_tpu_torch.experiments import pallas_band_v2

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("[band_v2] flex_tpu_torch.experiments.pallas_band_v2.main(), as "
        "python -m flex_tpu_torch.experiments.pallas_band_v2:")
    reset_launches()
    r = pallas_band_v2.main()
    launches = read_launches()
    # 1 checked + 3 warm-up + 10 timed calls
    expect_launches(launches, "pallas_band_v2.main()", band_spmm_v2=14)
    if r["err_frac"] > 1e-4:
        raise AssertionError(f"pallas_band_v2: err_frac {r['err_frac']}")
    torch.cuda.empty_cache()
    log(f"[band_v2] kernel 5 on the script's split: {r['ms']:.4f} ms "
        f"({r['gflops']:.1f} GF/s, depth share read "
        f"{r['depth_read']:.4f}), phase 12's band_spmm_v2 on the pallas2 "
        f"plan's tables {kernel5_ms:.4f} ms; xla ref {r['xla_ms']:.4f} ms; "
        f"err_frac {r['err_frac']}; launches {launches['band_spmm_v2']}; "
        f"{time.perf_counter() - t0:.1f}s; {smi}")
    return r, launches


STUDY_SPECS = ("windowed,W=128,J=1024,mc=64", "windowed,W=128,J=1024,mc=128",
               "ell")
# refusals that the JAX package gives for the same config
# (tests/test_torch_studies.py holds the port to it)
SHARED_REFUSALS = ("transposed windowed requires W % 128 == 0",)
# kernels each study's path must launch
STUDY_KERNELS = {
    "bench_windowed": ("window_spmm_fwd", "gespmm_rows"),
    "profile_windowed_mc64": ("window_spmm_fwd", "gespmm_rows"),
    "profile_windowed_mc128": ("window_spmm_fwd", "gespmm_rows"),
    "sweep_windowed_r3": ("window_spmm_fwd", "gespmm_rows"),
    "sweep_windowed_r4": ("window_spmm_fwd", "window_spmm_t_fwd",
                          "gespmm_rows"),
    "bench_gcn_train": ("window_spmm_fwd", "window_bwd_gB", "gespmm_rows"),
}


def phase_studies(torch, g, smi):
    """[studies] the windowed and training studies in turn, each with the
    counts set to 0 just before it and read just after: gen_graphs (the
    headline's cache, which must be there), bench_windowed (mc 64, mc 128,
    ell), profile_windowed at mc 64 and 128, analyze_windows,
    subtile_occupancy, both sweeps in full, bench_gcn_train.  Every config
    runs, or is a refusal the JAX package shares.  Returns (the numbers
    PERF.md reads, launches by study)."""
    from flex_tpu_torch.experiments import (
        analyze_windows, bench_gcn_train, bench_windowed, gen_graphs,
        profile_windowed, subtile_occupancy, sweep_windowed_r3,
        sweep_windowed_r4,
    )

    t0 = time.perf_counter()
    out, launches, secs = {}, {}, {}

    def study(name, fn):
        torch.cuda.empty_cache()
        log(f"[studies] {name}:")
        reset_launches()
        t1 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t1
        launches[name] = read_launches()
        missing = [k for k in STUDY_KERNELS.get(name, ())
                   if launches[name][k] < 1]
        if missing:
            raise AssertionError(f"{name} never launched {missing}")
        log(f"[studies] {name}: {secs[name]:.1f}s, launches "
            f"{ {k: v for k, v in launches[name].items() if v} }")

    study("gen_graphs", lambda: gen_graphs.main(("reddit_posts",),
                                                ("rbdeg",)))
    if out["gen_graphs"] != {("reddit_posts", "rbdeg"): "cached"}:
        raise AssertionError(f"gen_graphs rebuilt the cache: "
                             f"{out['gen_graphs']}")
    study("bench_windowed", lambda: bench_windowed.main("rbdeg", STUDY_SPECS))
    for spec, r in out["bench_windowed"].items():
        if r.check is None or r.check.err_frac > 1e-4:
            raise AssertionError(f"bench_windowed {spec}: err_frac "
                                 f"{r.check and r.check.err_frac}")
    for mc in (64, 128):
        study(f"profile_windowed_mc{mc}",
              lambda mc=mc: profile_windowed.main(graph=g, mc=mc))
    study("analyze_windows", lambda: analyze_windows.main(graph=g))
    study("subtile_occupancy", lambda: subtile_occupancy.main(graph=g))
    study("sweep_windowed_r3", lambda: sweep_windowed_r3.main(graph=g))
    study("sweep_windowed_r4", lambda: sweep_windowed_r4.main(graph=g))
    refused = []
    for name in ("sweep_windowed_r3", "sweep_windowed_r4"):
        for tag, typ, msg in out[name]["failed"]:
            if typ != "ValueError" or not msg.startswith(SHARED_REFUSALS):
                raise AssertionError(f"{name} {tag} failed: {typ}: {msg}")
            refused.append(f"{name} {tag}: {msg}")
    study("bench_gcn_train", lambda: bench_gcn_train.main(graph=g))
    gcn = out["bench_gcn_train"]
    firsts = [gcn[n]["losses"][0] for n in ("windowed", "windowed+tbwd",
                                            "ell", "ell+tbwd")]
    if max(firsts) - min(firsts) > 1e-4 or not np.isfinite(firsts).all():
        raise AssertionError(f"bench_gcn_train: first losses {firsts}")
    bw = {spec: r.t_elap * 1e3 for spec, r in out["bench_windowed"].items()}
    summary = {
        "seconds": secs, "refused": refused,
        "bench_windowed_t_elap_ms": bw,
        "profile": {mc: {f: out[f"profile_windowed_mc{mc}"][f] for f in (
            "full_ms", "dense_ms", "res_ms", "coverage", "steps")}
            for mc in (64, 128)},
        "gcn_ms_per_step": {n: gcn[n]["ms_per_step"] for n in (
            "windowed", "windowed+tbwd", "ell", "ell+tbwd")},
        "grad_parity_max_rel": gcn["grad_parity_max_rel"],
        "sweep_r3": {k: v for k, v in out["sweep_windowed_r3"].items()
                     if k not in ("device", "failed")},
        "sweep_r4": {k: v for k, v in out["sweep_windowed_r4"].items()
                     if k not in ("device", "failed")},
    }
    log(f"[studies] refused (the JAX package refuses the same): {refused}")
    log("[studies] " + json.dumps(summary))
    log(f"[studies] phase took {time.perf_counter() - t0:.1f}s; {smi}")
    return summary, launches


def run_shard_phases(torch, g, dev, B, gold, sel, peaks, bench_spmm,
                     time_cuda_ms, smi):
    """[bf16], [options], [sharded], [parallel_2d], each with the counts
    set to 0 just before its path and read just after.  Returns (kernel
    7's bf16 row, launch counts by phase)."""
    t0 = time.perf_counter()
    row, launches = phase_bf16(torch, g, dev, B, gold, sel, peaks,
                               bench_spmm, time_cuda_ms, smi)
    launches["options"] = phase_options(torch, g, dev, B, gold, sel,
                                        bench_spmm, smi)
    sharded, by_path = phase_sharded(torch, g, dev, B, gold, time_cuda_ms,
                                     smi)
    launches.update(by_path)
    launches["parallel_2d"] = phase_parallel_2d(torch, g, dev, smi)
    row["sharded_ell_replicated_ms"] = sharded["ell_replicated"]["t_elap_ms"]
    log(f"[bf16..parallel_2d] phases took {time.perf_counter() - t0:.1f}s")
    return row, launches


def main() -> int:
    quick = "--quick" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import flex_tpu_torch  # noqa: F401  (fails outside a checkout)
    from flex_tpu_torch import kernels
    from flex_tpu_torch.bench.harness import bench_spmm, time_cuda_ms
    from flex_tpu_torch.bench.headline import load_graph
    from flex_tpu_torch.utils.device_info import peaks_for
    from flex_tpu_torch.ops.window_spmm import (
        FWD_CHUNK_STEPS, device_units, window_select, window_spmm_fwd,
        window_spmm_fwd_plain,
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
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", out)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", out)]
        log(f"[build] {src}: {len(regs)} kernels, most registers "
            f"{max(regs, default=0)}, most spill stores "
            f"{max(spills, default=0)} bytes")

    # 3. kernel vs plain
    phase_kernels_vs_plain(torch)
    phase_new_kernels_vs_plain(torch)
    phase_bf16_kernel_vs_plain(torch)
    phase_micro_kernels_vs_plain(torch)
    phase_winstep_kernel_vs_plain(torch)
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
    g = load_graph(csv=True)
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
    r, plan = bench_plan(bench_spmm, g, K, "windowed", dev=dev, B=B,
                         gold=gold, iters=10, tm=256, W=128, min_count=64,
                         sel=sel)
    launches = read_launches()
    # 3 warm-up + 10 timed + 1 checked call: the dense half and the
    # residue, and no other kernel
    expect_launches(launches, "the forward path", window_spmm_fwd=14,
                    gespmm_rows=14)
    peak_mem = torch.cuda.max_memory_allocated()
    if r.err_frac is None or r.err_frac > 1e-4:
        raise AssertionError(f"main path err_frac={r.err_frac} > 1e-4")

    B_dev = torch.from_numpy(B).to("cuda")
    C = plan(B_dev)
    if tuple(C.shape) != (g.m, K) or not bool(torch.isfinite(C).all()):
        raise AssertionError(f"main path output {tuple(C.shape)} is not a "
                             f"finite ({g.m}, {K}) tensor")
    del C
    # a second call gives the same bits: no unordered sum on the path
    require_same_bits(torch, "the windowed plan", "main path k=128",
                      plan(B_dev), plan(B_dev))
    dense_ms = time_cuda_ms(plan.dense_half, B_dev, iters=20)
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
    main_ms = r.t_elap_ms
    main_stats = {"n_steps": st["n_steps"], "n_res": st["n_res"]}

    # 5. kernels on the main path's tensors
    args = (plan.first, plan.out_panel, plan.win_step, plan.A, B_dev)
    kw = dict(n_panels=plan.n_used_panels, W=plan.W)
    tabs = {"first": plan.first, "out_panel": plan.out_panel,
            "win_step": plan.win_step, "A": plan.A}
    max_abs_err = check_window_kernel(
        torch, dict(tabs, B=B_dev), plan.n_used_panels, plan.W,
        plan.panel_step_ptr, "main path k=128", units=plan.panel_units)
    # the train step's second layer calls the kernel at k = 41
    B41 = B_dev[:, :41].contiguous()
    max_abs_err_41 = check_window_kernel(
        torch, dict(tabs, B=B41), plan.n_used_panels, plan.W,
        plan.panel_step_ptr, "main path k=41", units=plan.panel_units)
    check_plan_against_scipy(g, plan, np.ascontiguousarray(B[:, :41]),
                             np.ascontiguousarray(gold[:, :41]),
                             "windowed main path k=41")
    C_k = plan.dense_half(B_dev)
    dense_ms_41 = time_cuda_ms(plan.dense_half, B41, iters=20)
    plain_ms = time_cuda_ms(lambda: window_spmm_fwd_plain(*args, **kw),
                            iters=5)
    # one unit per panel: the same kernel with a block behind every whole panel
    whole = device_units(plan.panel_step_ptr.cpu().numpy(), 1 << 30, "cuda")
    whole_ms = time_cuda_ms(lambda: window_spmm_fwd(
        *args, panel_step_ptr=plan.panel_step_ptr, units=whole, **kw),
        iters=5)
    longest_ms = longest_panel_ms(torch, plan, B_dev, time_cuda_ms)
    rep = units_report(plan.panel_units)
    reduce_ms, scratch_bytes = reduce_pass_ms(
        torch, "window_spmm", "flex_window_spmm_reduce", plan.panel_units,
        plan.tm, K, plan.n_used_panels, time_cuda_ms)
    log(f"[kernels] window_spmm_fwd: steps per panel p50/p99/max "
        f"{steps_percentiles(plan)}; {rep['units']} units of at most "
        f"{FWD_CHUNK_STEPS} steps, steps per unit p50/p99/max "
        f"{rep['per_unit_p50_p99_max']}, {rep['split_owners']} panels split, "
        f"{rep['partial_tiles']} partial tiles = {scratch_bytes} scratch "
        f"bytes at k={K}, reduce pass alone {reduce_ms:.3f} ms; longest "
        f"panel alone {longest_ms:.3f} ms; one unit per panel "
        f"{whole_ms:.3f} ms; k=41 {dense_ms_41:.3f} ms; the whole-panel "
        f"kernel's record: {WHOLE_OWNER_RECORD_MS['window_spmm_fwd']}")
    n_win, n_bytes, n_flops = window_bytes_flops(plan, K)
    bound_ms, bound_by = bound(n_bytes, n_flops, peaks)
    A_bsr = window_as_bsr(torch, plan)
    B_pad = B_dev.new_zeros((A_bsr.shape[1], K))
    B_pad[:g.n] = B_dev
    lib_err = float((torch.sparse.mm(A_bsr, B_pad) - C_k).abs().max())
    win_library_ms = time_cuda_ms(torch.sparse.mm, A_bsr, B_pad, iters=10)
    log(f"[kernels] window_spmm_fwd yardstick torch.sparse.mm(BSR "
        f"{plan.W}x{plan.W}): {win_library_ms:.3f} ms, max |diff| vs "
        f"kernel {lib_err:.3e}; whole product by torch.sparse.mm(CSR) "
        f"{library_ms:.3f} ms")
    del A_bsr, B_pad, C_k, B41
    rows = [{
        "name": "window_spmm_fwd", "route": "cuda",
        "source": "flex_tpu_torch/csrc/window_spmm.cu",
        "replaces": "flex_tpu/ops/window_spmm.py:958",
        "launches": launches["window_spmm_fwd"],
        "max_abs_err": max_abs_err, "ms": dense_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": win_library_ms, "max_abs_err_k41": max_abs_err_41,
        "ms_k41": dense_ms_41, "longest_panel_ms": longest_ms,
        "reduce_ms": reduce_ms, "ms_one_unit_per_panel": whole_ms,
        "scratch_bytes": scratch_bytes, "units": rep["units"],
        "whole_product_csr_library_ms": library_ms,
    }]
    log(f"[kernels] window_spmm_fwd: real windows {n_win}, "
        f"{n_flops / 1e12:.4f} TFLOP, {n_bytes / 1e9:.3f} GB, "
        f"{n_flops / (dense_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")

    # 6. gradient path, 7. training path, 8. the backward kernels
    launches_grad, gA_err, co, g_dense, tplan, launches_tgrad, grad_ms = \
        phase_gradient(torch, g, plan, B_dev, time_cuda_ms)
    launches_train = phase_training(torch, g, plan, tplan, B_dev,
                                    time_cuda_ms, smi,
                                    profile="--profile" in sys.argv[1:])
    # 7b. GraphSAGE on the same plan, with a checkpoint and a resume
    launches_sage = phase_sage(torch, g, plan, tplan, B_dev, smi)
    rows += phase_bwd_kernels(torch, g, plan, B_dev, co, g_dense, gA_err,
                              grad_ms, launches_grad, launches_train, peaks,
                              time_cuda_ms)
    residue = phase_residue(torch, plan, tplan, peaks, time_cuda_ms)
    log(f"[kernels] launches: forward path {launches}, gradient path "
        f"{launches_grad}, with the training backward {launches_tgrad}, 7 "
        f"train steps {launches_train}; before the unit kernels the windowed "
        f"tElap was {WHOLE_OWNER_RECORD_MS['windowed_t_elap']} ms and a "
        f"train step {WHOLE_OWNER_RECORD_MS['train_ms_per_step']} ms on this "
        f"card model, before the residue ran on kernel 7 "
        f"{REDESIGN_RECORD_MS['windowed_t_elap']} and "
        f"{REDESIGN_RECORD_MS['train_ms_per_step']} ms")
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
    torch.cuda.empty_cache()
    # 11b. GAT on the main path's graph
    gat = phase_gat(torch, g, dev, B_dev, peaks, time_cuda_ms, smi,
                    profile="--profile" in sys.argv[1:])
    torch.cuda.empty_cache()
    # the autotuner's rates and the GCN layer bench on the main path's graph
    kernel4_ms41 = next(r["ms"] for r in rows
                        if r["name"] == "window_spmm_t_fwd")
    rates, launches_autotune = phase_autotune(
        torch, g, dev, B_dev, sel, dense_ms, kernel4_ms41, time_cuda_ms)
    launches_gcn = phase_gcn_bench(g)
    del B_dev
    torch.cuda.empty_cache()
    # [bf16], [options], [sharded], [parallel_2d]
    bf16_row, launches_shard = run_shard_phases(
        torch, g, dev, B, gold, sel, peaks, bench_spmm, time_cuda_ms, smi)
    del dev, gold
    torch.cuda.empty_cache()
    # 12. band, on its own graph
    rows += phase_band(torch, peaks, bench_spmm, time_cuda_ms)
    # 13. panel, on its own graph
    panel = phase_panel(torch, peaks, bench_spmm, time_cuda_ms, smi)
    torch.cuda.empty_cache()
    # the command line on the main path's graph, then its sweep on Flickr's
    cli = phase_cli(main_ms, main_stats)
    sweep, launches_sweep = phase_sweep()
    # the headline in its own process, the entry points, the examples
    torch.cuda.empty_cache()
    _, launches_headline = phase_headline(g, cli["cli_auto_k128"])
    launches_entry, launches_dryrun = phase_entry(torch, time_cuda_ms, smi)
    launches_examples = phase_examples(torch, smi)
    # [micro] the probes of experiments/, kernels 8-11
    torch.cuda.empty_cache()
    micro_rows = phase_micro(torch, peaks, time_cuda_ms, smi, g.nnz,
                             gespmm_row["ms"])
    # [winstep], [band_v2], [studies]: E7, E8 and the studies
    torch.cuda.empty_cache()
    row12, k1_winstep, launches_winstep = phase_winstep(torch, g, peaks, smi)
    band_v2, launches_band_v2 = phase_band_v2(
        torch, next(r["ms"] for r in rows if r["name"] == "band_spmm_v2"),
        smi)
    studies, launches_studies = phase_studies(torch, g, smi)
    # kernel 7 also runs the main path's residue: its launches there, and
    # the residue's own numbers
    gespmm_row.update({
        "launches_forward_path": launches["gespmm_rows"],
        "launches_gradient_path": launches_grad["gespmm_rows"],
        "launches_training_bwd_gradient": launches_tgrad["gespmm_rows"],
        "launches_train_7_steps": launches_train["gespmm_rows"],
        "launches_sage_8_steps": launches_sage["gespmm_rows"],
        "launches_gat_7_steps": gat["launches_7_steps"]["gespmm_rows"],
        "launches_gat_per_step": gat["launches_per_step"],
        "gat_ms_per_step": gat["ms_per_step"],
        "launches_panel_hubs_path": panel["hubs"]["launches"],
        "launches_panel_no_hubs_path": panel["no_hubs"]["launches"]})
    for key, r in gat["kernel"].items():
        if isinstance(r, dict):
            gespmm_row.update({f"gat_{key}_{f}": v for f, v in r.items()})
        else:
            gespmm_row[f"gat_{key}_ms"] = r
    hubs = panel["hubs"]
    gespmm_row.update({f"panel_{f}": hubs[f] for f in (
        "hub_ms", "hub_plain_ms", "hub_bound_ms", "hub_err", "t_elap_ms")})
    gespmm_row["panel_library_ms"] = panel["library_ms"]
    for r in rows:   # kernels 1 and 3 also run SAGE's aggregation
        if r["name"] in ("window_spmm_fwd", "window_bwd_gB"):
            r["launches_sage_8_steps"] = launches_sage[r["name"]]
    for k, r in residue.items():
        gespmm_row.update({f"residue_{key}_k{k}": r[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "err", "bwd_ms",
            "bwd_with_pads_ms", "bwd_plain_ms", "bwd_library_ms",
            "bwd_bound_ms", "bwd_err")})
    rows.append(gespmm_row)
    rows.append(bf16_row)
    rows += micro_rows
    rows.append(row12)
    for r in rows:
        if r["name"] == "window_spmm_fwd":
            r.update(k1_winstep)
            r["mc64_vs_mc128_t_elap_ms"] = studies["bench_windowed_t_elap_ms"]
        if r["name"] == "band_spmm_v2":
            r.update({"launches_band_v2": launches_band_v2["band_spmm_v2"],
                      "band_v2_ms": band_v2["ms"],
                      "band_v2_err_frac": band_v2["err_frac"],
                      "band_v2_xla_ms": band_v2["xla_ms"]})
        r["launches_winstep"] = launches_winstep.get(r["name"], 0)
        r.update({f"launches_studies_{ph}": c.get(r["name"], 0)
                  for ph, c in launches_studies.items()})
    new_launches = {"autotune": launches_autotune, "gcn_bench": launches_gcn,
                    "sweep": launches_sweep, **launches_shard,
                    **{tag: c["launches"] for tag, c in cli.items()},
                    "headline": launches_headline, "entry": launches_entry,
                    "dryrun_multichip": launches_dryrun, **launches_examples}
    # the command-line processes print the package's counts alone: they
    # never import the probes, so kernels 8-11 launch 0 times there
    for r in rows:
        r.update({f"launches_{ph}": new_launches[ph].get(r["name"], 0)
                  for ph in NEW_PHASES + SHARD_PHASES + ENTRY_PHASES})
    if len(rows) != 13 or any(r["launches"] < 1 for r in rows):
        raise AssertionError(f"a kernel was never launched on its path: "
                             f"{[(r['name'], r['launches']) for r in rows]}")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
