"""Windowed-panel hybrid SpMM: dense window tiles + ELL residue, forward
and backward.

Counterpart of ``flex_tpu.ops.window_spmm``, with its options (step
order, G, ``fused``, ``impl``, ``b_dtype``; every ``fused`` name runs the
one build).
After a clustering ordering (rbdeg), each row
panel's nonzeros concentrate in a few W-aligned column blocks.  Blocks
with at least ``min_count`` nonzeros become dense (TM, W) tiles of A,
packed G to a step; a step is one (TM, G·W)x(G·W, k) product, and the
steps of one panel sum into its output rows.  Entries outside every kept
window form the residue, an ELL plan (:mod:`.ell_spmm`).  The two halves
add.

- :func:`window_select` (host, NumPy) picks the windows and lays out the
  steps; it is a copy of the JAX package's host selection.
- :func:`_build_windowed_ell` builds A, and the residue's ELL buckets, on
  the device from the resident CSR, in one value scatter.
- :func:`window_spmm_fwd` runs the dense half: the hand-written CUDA kernel
  ``csrc/window_spmm.cu`` for CUDA tensors, :func:`window_spmm_fwd_plain`
  for CPU tensors.
- :func:`work_units` cuts every panel's steps (every block rank's slots)
  into units of a few steps, one CUDA block each: long panels and slot
  chains no longer hold the card behind one block.  The units of a split
  panel write partial tiles, which a second kernel adds in unit order.
  The forward, g_B and the transposed forward run in units; g_A runs in
  the forward's units too (no sum across steps, so no second kernel).
- :func:`window_bwd_gA` and :func:`window_bwd_gB` are the dense half's two
  gradients (``csrc/window_spmm_bwd.cu``, plain versions beside them);
  :class:`_WindowSpmm` ties the three into one differentiable call, so a
  plan can be trained through (B and A's values; the tables are constants).
- ``prepare_windowed(transposed=True)`` lays each step's tile out
  transposed, (G·W, TM), for :func:`window_spmm_t_fwd`
  (``csrc/window_spmm_t.cu``): the narrow-k variant, whose work scales
  with k.  It computes Cᵀ = Bᵀ·Aᵀ; :class:`_WindowSpmmT` makes it
  differentiable, with both gradients in plain tensor ops as in the JAX
  package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.ell_spmm import (
    DEFAULT_WIDTHS, EllPlan, _gather_assembly_tables, check_b_dtype,
    ell_scatter_layout,
)
from flex_tpu_torch.ops.gespmm import row_tables
from flex_tpu_torch.ops.operands import (
    check_interpret, check_kernel_operands, check_operands,
)
from flex_tpu_torch.ops.units import work_units
from flex_tpu_torch.sparse.csr import (
    CSRGraph, indicator_cumsum, repeat_arange, repeat_values,
)
from flex_tpu_torch.sparse.device import (
    DeviceCSR, dense_operand, resident_csr, rows_from_row_ptr,
)

G = 4  # default windows per step (per-step product: (TM, G*W) x (G*W, k))

MIN_COVERAGE = 0.15
MAX_DENSE_BYTES = 8 << 30


# ---------------------------------------------------------------------------
# host selection (copy of the JAX package's host path)
# ---------------------------------------------------------------------------

def _host_panel_key(g, tm: int, W: int, P: int, nblk: int) -> np.ndarray:
    """Host (panel, block) key per nnz, int32 (P·nblk < 2^31 is checked by
    the caller), built without np.repeat: panel ids come from the
    indicator-cumsum over the panel start offsets."""
    m, nnz = g.m, g.nnz
    pstarts = g.row_ptr[np.minimum(
        np.arange(1, P, dtype=np.int64) * tm, m)]
    panel = indicator_cumsum(pstarts, nnz, dtype=np.int32)
    col32 = np.asarray(g.col, dtype=np.int32)
    block = (col32 >> (W.bit_length() - 1)) if W & (W - 1) == 0 \
        else col32 // np.int32(W)
    np.multiply(panel, np.int32(nblk), out=panel)
    np.add(panel, block, out=panel)
    return panel


def window_select(
    g: CSRGraph, tm: int = 256, W: int = 128, J: int = 1024,
    min_count: int = 128, dev: DeviceCSR | None = None, g_step: int = G,
    step_order: str = "row", max_dense_bytes: int | None = None,
) -> dict:
    """Window selection + step layout.

    Per panel: every W-aligned column block with ≥ ``min_count`` nnz is a
    window; a panel with more than ``J`` keeps the top ones by count.  Kept
    windows are sorted ascending by block id and packed into G-window
    steps, panels in row order, or with ``step_order="lex"`` in the
    lexicographic order of their first step's block ids (the JAX package's
    panel lexsort; the output permutation absorbs it).  With
    ``max_dense_bytes`` the count gate rises to the smallest value whose
    dense array fits the budget (the realized gate is ``min_count_eff``).

    Returns dict with:
      win_step   int32[total_steps*G] block ids (sentinel = nblk pads)
      out_panel  int32[total_steps]   dense output-panel index per step
      first      int32[total_steps]   1 on a panel's first step
      pstep0     int64[P]             panel -> first step (-1 if none)
      slot       int16[P*nblk]        0 = residue, j+1 = window slot j
      used       panels with windows, row_gather int32[P*tm]
      res_deg    int64[m] residue degree per row, unique_rc (bool)
      coverage, a_elems, dense_bytes, total_steps, n_used_panels, P,
      nblk, n_res, G, W, min_count_eff

    ``dev`` (a :class:`DeviceCSR` or None) is accepted and ignored: the
    JAX package counts windows on the device when given one, a TPU
    workaround; the port's count is the host pass below either way.
    """
    if dev is not None and not isinstance(dev, DeviceCSR):
        raise TypeError(f"dev must be a DeviceCSR or None, got "
                        f"{type(dev).__name__}")
    m, nnz = g.m, g.nnz
    J = min(J, 32000)  # slot table is int16 (values ≤ J+1)
    P = max(-(-m // tm), 1)
    nblk = max(-(-g.n // W), 1)
    if P * nblk >= 2**31:
        raise ValueError(
            f"P*nblk = {P}*{nblk} exceeds int32 — raise tm/W or shard rows")
    key_h = _host_panel_key(g, tm, W, P, nblk)
    cnt = np.bincount(key_h, minlength=P * nblk).reshape(P, nblk)

    min_count_eff = max(min_count, 1)
    if max_dense_bytes is not None:
        step_bytes = tm * g_step * W * 4

        def _bytes_at(t: int) -> int:
            nb = np.minimum((cnt >= t).sum(axis=1), J)
            return int((-(-nb[nb > 0] // g_step)).sum()) * step_bytes

        if _bytes_at(min_count_eff) > max_dense_bytes:
            lo, hi = min_count_eff, int(cnt.max()) + 1  # hi always fits
            while lo + 1 < hi:
                mid = (lo + hi) // 2
                if _bytes_at(mid) > max_dense_bytes:
                    lo = mid
                else:
                    hi = mid
            min_count_eff = hi

    valid = cnt >= min_count_eff
    nb_per = valid.sum(axis=1)
    over = np.where(nb_per > J)[0]
    for p in over:  # cap fat panels: keep the top-J blocks by count
        ids = np.where(valid[p])[0]
        keep = ids[np.argpartition(-cnt[p, ids], J - 1)[:J]]
        valid[p] = False
        valid[p, keep] = True
    nb_per = np.minimum(nb_per, J)

    used = np.where(nb_per > 0)[0]
    if step_order not in ("row", "lex"):
        raise ValueError(f"unknown step_order {step_order!r}")
    if step_order == "lex" and len(used):
        # panels ordered by their first step's block ids (sentinel nblk
        # past a panel's last window); np.nonzero walks `valid` row-major
        pw0, bw0 = np.nonzero(valid)
        seg_start = np.flatnonzero(np.r_[True, np.diff(pw0) != 0])
        keys = np.full((len(used), g_step), nblk, dtype=np.int64)
        for j in range(g_step):
            has = nb_per[used] > j
            keys[has, j] = bw0[seg_start[has] + j]
        used = used[np.lexsort(tuple(keys[:, j]
                                     for j in range(g_step - 1, -1, -1)))]
    S_per = -(-nb_per[used] // g_step)
    total_steps = int(S_per.sum())
    step_of = repeat_arange(S_per, total=total_steps)
    first = np.zeros(total_steps, dtype=np.int32)
    step_starts = np.concatenate([[0], np.cumsum(S_per)[:-1]]) \
        if total_steps else np.zeros(0, dtype=np.int64)
    if total_steps:
        first[step_starts] = 1
    pstep0 = np.full(P, -1, dtype=np.int64)
    pstep0[used] = step_starts

    # per-used-panel sorted window ids -> flat win_step with sentinel pads;
    # np.nonzero walks `valid` row-major, so pairs come grouped by panel
    # with blocks ascending
    win_step = np.full(total_steps * g_step, nblk, dtype=np.int32)
    slot = np.zeros(P * nblk, dtype=np.int16)
    if len(used):
        pw, bw = np.nonzero(valid)
        panel_first = np.r_[True, np.diff(pw) != 0]
        jj = np.arange(len(pw), dtype=np.int64) - repeat_values(
            np.arange(len(pw), dtype=np.int64)[panel_first],
            nb_per[pw[panel_first]], total=len(pw))
        dense_of_panel = np.full(P, -1, dtype=np.int64)
        dense_of_panel[used] = np.arange(len(used))
        flat_slot = step_starts[dense_of_panel[pw]] * g_step + jj
        win_step[flat_slot] = bw.astype(np.int32)
        slot[pw * nblk + bw] = (jj + 1).astype(np.int16)

    covered = int(cnt[valid].sum())
    a_elems = total_steps * tm * g_step * W

    # output assembly: graph row r of panel p lives at row
    # dense_index(p)*tm + r%tm of the dense half; panels without windows
    # point at an appended zero row
    row_src = np.full(P, -1, dtype=np.int64)
    row_src[used] = np.arange(len(used))
    total_rows = len(used) * tm
    rg = np.full(P * tm, total_rows, dtype=np.int64)
    if len(used):
        blockrows = (row_src[used][:, None] * tm
                     + np.arange(tm, dtype=np.int64)[None, :])
        rg[(used[:, None] * tm + np.arange(tm)[None, :]).ravel()] = \
            blockrows.ravel()

    # residue degree per row: windowed sum of the residue mask, as an
    # exclusive cumsum sampled at the row bounds
    mask32 = (slot[key_h] == 0).astype(np.int32)
    cs = np.empty(g.nnz + 1, np.int32)
    cs[0] = 0
    np.cumsum(mask32, out=cs[1:])
    res_deg = (cs[g.row_ptr[1:]] - cs[g.row_ptr[:-1]]).astype(np.int64)

    return {
        "G": g_step,
        "W": W,
        "min_count_eff": min_count_eff,
        "res_deg": res_deg,
        "unique_rc": pattern_is_unique(g),
        "win_step": win_step,
        "out_panel": step_of.astype(np.int32),
        "first": first,
        "pstep0": pstep0,
        "slot": slot,
        "used": used,
        "row_gather": rg.astype(np.int32),
        "coverage": covered / max(nnz, 1),
        "n_res": nnz - covered,
        "a_elems": a_elems,
        "dense_bytes": a_elems * 4,
        "total_steps": total_steps,
        "n_used_panels": len(used),
        "P": P,
        "nblk": nblk,
    }


def pattern_is_unique(g: CSRGraph, row_ptr_h: np.ndarray | None = None
                      ) -> bool:
    """Host duplicate-(row, col) detection: with columns sorted within rows
    a duplicate is an adjacent equal pair.  Unsorted rows return the
    conservative False (the build then sums duplicates).  ``row_ptr_h``,
    a host copy of the row pointers the caller already holds, is read in
    place of ``g.row_ptr``."""
    nnz = g.nnz
    if nnz <= 1:
        return True
    row_ptr = g.row_ptr if row_ptr_h is None else np.asarray(row_ptr_h)
    if row_ptr.shape != (g.m + 1,):
        raise ValueError(f"row_ptr_h must have {g.m + 1} entries, got "
                         f"{row_ptr.shape}")
    same_row = np.ones(nnz - 1, dtype=bool)
    b = np.asarray(row_ptr[1:-1], dtype=np.int64)
    b = b[(b > 0) & (b < nnz)]
    same_row[b - 1] = False  # position i compares entries i and i+1
    return not np.any(same_row & (g.col[1:] <= g.col[:-1]))


def panel_step_ptr(first: np.ndarray) -> np.ndarray:
    """int32[n_used+1]: the steps of used panel p are
    ``ptr[p] .. ptr[p+1]`` (a panel's steps are consecutive)."""
    return np.append(np.flatnonzero(first), len(first)).astype(np.int32)


def _bwd_tables(win_step_h: np.ndarray, out_panel_h: np.ndarray,
                nblk: int, g_step: int, W: int):
    """Host backward-slot tables from the selection's flat window list:
    real slots sorted ascending by block id, so the slots that meet one
    block of B are consecutive.  Returns ((slot_s, slot_g, panel_of, rank,
    bfirst, rows), n_blk_used), all O(n_windows) int32, or (None, 0) when
    there is no real window; ``rows`` are the B rows of the compact
    rank-indexed g_B output (copy of the JAX package's host tables)."""
    idx = np.flatnonzero(win_step_h != nblk)
    if not len(idx):
        return None, 0
    order = idx[np.argsort(win_step_h[idx], kind="stable")]
    blk_sorted = win_step_h[order].astype(np.int64)
    bfirst = np.r_[True, np.diff(blk_sorted) != 0]
    rank = (np.cumsum(bfirst) - 1).astype(np.int32)
    n_blk_used = int(rank[-1]) + 1
    uniq = blk_sorted[bfirst]
    rows = (uniq[:, None] * W + np.arange(W, dtype=np.int64)[None, :]
            ).ravel().astype(np.int32)
    slot_s = (order // g_step).astype(np.int32)
    return (slot_s, (order % g_step).astype(np.int32),
            out_panel_h[slot_s].astype(np.int32), rank,
            bfirst.astype(np.int32), rows), n_blk_used


def slot_ptr(bfirst: np.ndarray) -> np.ndarray:
    """int32[n_blk_used+1]: the sorted slots of rank r are
    ``ptr[r] .. ptr[r+1]`` (a CUDA grid has no step order, so the g_B
    kernel's block loops over its own slots instead of re-initialising on
    ``bfirst``)."""
    return np.append(np.flatnonzero(bfirst), len(bfirst)).astype(np.int32)


FWD_CHUNK_STEPS = 8   # most steps in one unit of the forward kernel
GB_CHUNK_SLOTS = 16   # most slots in one unit of the g_B kernel: equal work


def device_units(ptr: np.ndarray, chunk: int, device) -> tuple:
    """:func:`work_units` as a kernel wrapper takes them: (units, splits) as
    int32 tensors on ``device`` and the number of partial tiles."""
    units, splits = work_units(ptr, chunk)
    return (torch.from_numpy(units).to(device),
            torch.from_numpy(splits).to(device), int((units[:, 3] >= 0).sum()))


def bwd_device_tables(win_step_h, out_panel_h, nblk: int, g_step: int,
                      W: int, device) -> dict:
    """What the backward needs on ``device`` of :func:`_bwd_tables`, as a
    plan's fields: ``bwd_tabs`` = (slot_s, slot_g, rows), ``slot_ptr``,
    ``slot_units`` (:func:`device_units` of ``slot_ptr``) and ``n_blk_used``
    (None, None, None and 0 when there is no real window).  ``panel_of`` is
    ``out_panel[slot_s]`` and ``rank``/``bfirst`` are ``slot_ptr`` in
    another form, so they stay on the host."""
    tabs, n_blk = _bwd_tables(np.asarray(win_step_h), np.asarray(out_panel_h),
                              nblk, g_step, W)
    if tabs is None:
        return {"bwd_tabs": None, "slot_ptr": None, "slot_units": None,
                "n_blk_used": 0}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    ptr = slot_ptr(tabs[4])
    return {"bwd_tabs": (put(tabs[0]), put(tabs[1]), put(tabs[5])),
            "slot_ptr": put(ptr), "n_blk_used": n_blk,
            "slot_units": device_units(ptr, GB_CHUNK_SLOTS, device)}


def _device_tables(sel: dict, device: torch.device) -> dict:
    """The selection's tables as tensors on ``device``, made once and kept
    in ``sel`` so a repeated prepare moves nothing from the host."""
    cache = sel.setdefault("torch_tables", {})
    key = str(device)
    if key not in cache:
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        ptr = panel_step_ptr(sel["first"])
        cache[key] = {
            "slot": put(sel["slot"], np.int32),
            "pstep0": put(sel["pstep0"], np.int64),
            "first": put(sel["first"], np.int32),
            "out_panel": put(sel["out_panel"], np.int32),
            "win_step": put(sel["win_step"], np.int32),
            "row_gather": put(sel["row_gather"], np.int32),
            "panel_step_ptr": put(ptr, np.int32),
            "panel_units": device_units(ptr, FWD_CHUNK_STEPS, device),
        }
        # backward-slot tables ride with the forward ones, so a prepare
        # ships nothing new
        cache[key].update(bwd_device_tables(
            sel["win_step"], sel["out_panel"], sel["nblk"], sel["G"],
            sel["W"], device))
    return cache[key]


# ---------------------------------------------------------------------------
# device build
# ---------------------------------------------------------------------------

def _chunk_tables(res_deg: np.ndarray, bucket_meta, chunk_row):
    """Host (offset, length) of every chunk of the layout of
    :func:`.ell_spmm.ell_scatter_layout`: chunk i of a bucket of width w at
    base b starts at b + i·w; a row's t-th chunk holds min(w, deg - t·w)
    entries, a pad chunk none."""
    offs, ws, real, base = [], [], [], 0
    for w, n, n_real in bucket_meta:
        offs.append(base + np.arange(n, dtype=np.int64) * w)
        ws.append(np.full(n, w, dtype=np.int64))
        real.append(np.arange(n) < n_real)
        base += n * w
    if not offs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    offs, ws, real = (np.concatenate(x) for x in (offs, ws, real))
    row = np.asarray(chunk_row, dtype=np.int64)[real]
    run0 = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
    local = np.arange(len(row)) - np.repeat(run0, np.diff(np.r_[run0,
                                                               len(row)]))
    ln = np.zeros(len(offs), np.int64)
    ln[real] = np.minimum(ws[real], np.asarray(res_deg, np.int64)[row]
                          - local * ws[real])
    return offs, ln


def residue_layout(sel: dict, device, widths=DEFAULT_WIDTHS,
                   bucket_alloc: dict | None = None) -> dict:
    """The residue's padded ELL layout (:func:`.ell_spmm.ell_scatter_layout`
    of the selection's residue degrees, with each chunk's offset and
    length) on ``device``, made once and kept beside the selection's other
    device tables.  ``bucket_alloc`` pads the buckets to the common shapes
    of a sharded plan's shards."""
    tabs = _device_tables(sel, device)
    key = ("residue", tuple(widths),
           None if bucket_alloc is None else tuple(sorted(
               bucket_alloc.items())))
    if key not in tabs:
        bucket_meta, H, chunk_row, padded = ell_scatter_layout(
            sel["res_deg"], tuple(widths), bucket_alloc)
        off, ln = _chunk_tables(sel["res_deg"], bucket_meta, chunk_row)
        tabs[key] = {
            "h": torch.from_numpy(H).to(device),
            "chunk_row": torch.from_numpy(chunk_row).to(device),
            "off": torch.from_numpy(off).to(device),
            "len": torch.from_numpy(ln).to(device),
            "bucket_meta": bucket_meta, "padded": padded}
    return tabs[key]


def _build_windowed_ell(row_ptr, col, vals, slot_tab, pstep0, res, *,
                        layout):
    """Dense A and the residue's ELL buckets from the device CSR, in one
    value scatter into one f32 buffer: an entry inside a kept window goes
    to A, the others (the residue) to their slots of the padded flat store
    of ``res`` (:func:`residue_layout`), entry i of row r at
    ``h[r] + miss_rank(i)``.  A and the residue's values are views of the
    buffer.  Returns (A, buckets, chunk_row, rows), ``rows`` the residue's
    row-unit tables.

    A is step-major: window j of panel p lives in step pstep0[p] + j//G at
    in-step slot j%G, i.e. flat element
    (pstep0[p] + j//G)·(TM·G·W) + (row%TM)·(G·W) + (j%G)·W + col%W.
    With ``transposed`` (last of ``layout``) each step's tile is laid out
    (G·W, TM) instead: the same scatter with the in-step index terms
    swapped.  Duplicate (row, col) entries must sum in A, so the scatter
    accumulates unless the selection proved the pattern duplicate-free
    (``unique_rc``); in the residue they take distinct slots."""
    nnz, m, TM, W, nblk, total_steps, g_step, unique_rc, transposed = layout
    a_elems = total_steps * TM * g_step * W
    padded = res["padded"]
    rows = rows_from_row_ptr(row_ptr, nnz, m)
    col64 = col.long()
    p = rows // TM
    j1 = slot_tab[p * nblk + col64 // W].long()
    hit = j1 > 0
    j = j1 - 1
    flat = (pstep0[p] + j // g_step) * (TM * g_step * W)
    if transposed:
        flat += ((j % g_step) * W + col64 % W) * TM + rows % TM
    else:
        flat += (rows % TM) * (g_step * W) + (j % g_step) * W + col64 % W
    miss = ~hit
    ell_dest = res["h"].long()[rows] + torch.cumsum(miss, 0) - 1
    del rows, p, j1, j
    buf = torch.zeros(a_elems + padded, dtype=torch.float32,
                      device=col.device)
    buf.index_put_((torch.where(hit, flat, a_elems + ell_dest),), vals,
                   accumulate=not unique_rc)
    flat_c = torch.zeros(padded, dtype=torch.int32, device=col.device)
    flat_c[ell_dest[miss]] = col[miss]
    flat_v = buf[a_elems:]
    A = buf[:a_elems].view((total_steps, g_step * W, TM) if transposed
                           else (total_steps, TM, g_step * W))
    buckets, o = [], 0
    for w, n, _ in res["bucket_meta"]:
        buckets.append((flat_c[o:o + n * w].view(n, w),
                        flat_v[o:o + n * w].view(n, w)))
        o += n * w
    rows = row_tables(flat_c, flat_v, res["chunk_row"], res["off"],
                      res["len"], m)
    return A, tuple(buckets), res["chunk_row"], rows


# ---------------------------------------------------------------------------
# dense half: kernel wrapper + plain version
# ---------------------------------------------------------------------------

def _check_window_kernel_operands(W, aligned=(), **floats):
    """What the window kernels add to :func:`check_operands`."""
    if W % 16:
        raise ValueError(f"the window kernels need W % 16 == 0, got W={W}")
    check_kernel_operands(aligned, **floats)


def _window_rows(win_step, W, device):
    """B row index of every (step, window, row-in-window): i64 [S·G, W]."""
    return win_step.long()[:, None] * W + torch.arange(W, device=device)


def _padded(B, W):
    """B followed by zero rows up to (nblk+1)·W: the sentinel block, and
    the last block's rows ≥ n, read as zero (plain versions only)."""
    n, k = B.shape
    B_pad = B.new_zeros(((max(-(-n // W), 1) + 1) * W, k))
    B_pad[:n] = B
    return B_pad


def _check_units(units, device) -> None:
    """A caller's unit tables are (int32 [U, 4], int32 [P, 3], int) on
    ``device``."""
    if units is None:
        return
    tab, splits, _ = units
    check_operands({"units": (tab, (tab.shape[0], 4)),
                    "splits": (splits, (splits.shape[0], 3))}, {})
    if tab.device != device or splits.device != device:
        raise ValueError(f"the unit tables lie on {tab.device}, not {device}")


def reduce_partials(name, symbol, scratch, out, splits):
    """Second pass of a unit kernel: every output tile of ``out`` named in
    ``splits`` = its partial tiles of ``scratch`` ([n_parts, rows, k]) added
    in unit order (``csrc/window_tile.cuh:reduce_partials_kernel``)."""
    from flex_tpu_torch import kernels

    kernels.launch(name, symbol, out.device, scratch.data_ptr(),
                   out.data_ptr(), splits.data_ptr(), splits.shape[0],
                   scratch.shape[1] * scratch.shape[2])


def window_spmm_fwd_plain(first, out_panel, win_step, A, B, *, n_panels, W):
    """Plain PyTorch version of the dense half: gather the (S, G·W, k)
    window rows of B (sentinel block and rows ≥ n read as zero), one bmm,
    then ``index_add_`` of the step products into their panels.  Returns
    f32 [n_panels·TM, k]."""
    S, TM, _ = A.shape
    Bw = _padded(B, W)[_window_rows(win_step, W, B.device).view(S, -1)]
    out = torch.bmm(A, Bw)                             # [S, TM, k]
    C = A.new_zeros((n_panels, TM, B.shape[1]))
    C.index_add_(0, out_panel, out)
    return C.view(n_panels * TM, B.shape[1])


def check_step_operands(first, out_panel, win_step, A, B, *, n_panels, W,
                        panel_step_ptr, units=None) -> None:
    """The step tables, operands and units of kernel 1's interface: A f32
    [S, TM, G·W], B f32 [n, k], int32 tables of S, S·G and n_panels + 1
    entries, all on one device."""
    if A.dim() != 3 or B.dim() != 2:
        raise ValueError(f"A must be 3-D and B 2-D, got {A.dim()}, {B.dim()}")
    S, TM, GW = A.shape
    if W <= 0 or GW % W:
        raise ValueError(f"A's width {GW} is not a multiple of W={W}")
    check_operands({"first": (first, S), "out_panel": (out_panel, S),
                     "win_step": (win_step, S * (GW // W)),
                     "panel_step_ptr": (panel_step_ptr, n_panels + 1)},
                    {"A": A, "B": B})
    _check_units(units, A.device)


def launch_step_kernel(name, symbol, win_step, A, B, *, n_panels, W,
                       panel_step_ptr, units=None, kernel_B=None, extra=()):
    """Launch ``symbol`` of ``csrc/<name>.cu``, a kernel with kernel 1's
    C interface, over the panels' work units (derived from
    ``panel_step_ptr`` when ``units`` is None), then kernel 1's pass that
    adds a panel's partial tiles in unit order.  CUDA tensors checked by
    :func:`check_step_operands`; returns f32 [n_panels·TM, k].  The kernel
    is handed ``kernel_B`` (a copy of B in another layout) in B's place
    when given, and ``extra`` arguments after kernel 1's."""
    S, TM, GW = A.shape
    n, k = B.shape
    _check_window_kernel_operands(W, ("A",), A=A, B=B)
    if units is None:  # a trip to the host: a plan carries its own
        units = device_units(panel_step_ptr.cpu().numpy(), FWD_CHUNK_STEPS,
                             A.device)
    unit_tab, splits, n_parts = units
    from flex_tpu_torch import kernels

    out = torch.empty((n_panels * TM, k), dtype=torch.float32,
                      device=A.device)
    scratch = torch.empty((n_parts, TM, k), dtype=torch.float32,
                          device=A.device)
    kernels.launch(name, symbol, A.device, A.data_ptr(),
                   (B if kernel_B is None else kernel_B).data_ptr(),
                   win_step.data_ptr(), unit_tab.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), unit_tab.shape[0], TM, GW // W, W, n,
                   k, max(-(-n // W), 1), *extra)
    reduce_partials("window_spmm", "flex_window_spmm_reduce", scratch, out,
                    splits)
    return out


def window_spmm_fwd(first, out_panel, win_step, A, B, *, n_panels, W,
                    panel_step_ptr, units=None):
    """Dense half of the windowed hybrid: out[p] = Σ over used panel p's
    steps s and windows g of A[s][:, g·W:(g+1)·W] · B[win_step[s·G+g]·W : +W].
    Returns f32 [n_panels·TM, k].  ``units`` are the panels' work units
    (:func:`device_units` of ``panel_step_ptr`` and ``FWD_CHUNK_STEPS``);
    without them the CUDA path derives them from ``panel_step_ptr``.

    CUDA tensors launch ``csrc/window_spmm.cu`` (and count the launch in
    ``window_spmm_fwd.launches``): one kernel over the units and, where a
    panel has several, the pass that adds its partial tiles.  CPU tensors
    take :func:`window_spmm_fwd_plain`.  Anything else raises."""
    kw = dict(n_panels=n_panels, W=W)
    check_step_operands(first, out_panel, win_step, A, B, **kw,
                        panel_step_ptr=panel_step_ptr, units=units)
    if A.device.type == "cpu":
        return window_spmm_fwd_plain(first, out_panel, win_step, A, B, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"no window kernel for device {A.device}")
    out = launch_step_kernel("window_spmm", "flex_window_spmm_fwd", win_step,
                             A, B, **kw, panel_step_ptr=panel_step_ptr,
                             units=units)
    window_spmm_fwd.launches += 1
    return out


window_spmm_fwd.launches = 0


# ---------------------------------------------------------------------------
# dense half, backward: the two gradients, each a kernel with a plain version
# ---------------------------------------------------------------------------

def window_bwd_gA_plain(out_panel, win_step, g, B, *, TM, W):
    """Plain PyTorch version of g_A: gather each step's cotangent panel
    (S, TM, k) and its window rows of B (S, G·W, k; sentinel block and rows
    ≥ n as zero), one bmm over k.  Returns f32 [S, TM, G·W]."""
    S = out_panel.shape[0]
    k = B.shape[1]
    g_p = g.view(-1, TM, k)[out_panel.long()]                  # [S, TM, k]
    Bw = _padded(B, W)[_window_rows(win_step, W, B.device).view(S, -1)]
    return torch.bmm(g_p, Bw.transpose(1, 2))


def panel_runs(out_panel: np.ndarray) -> np.ndarray:
    """int32[runs+1]: the steps of the r-th run of equal ``out_panel`` are
    ``ptr[r] .. ptr[r+1]`` (a plan's panels, whose steps are consecutive)."""
    op = np.asarray(out_panel)
    starts = np.flatnonzero(np.r_[True, op[1:] != op[:-1]]) if len(op) else []
    return np.append(starts, len(op)).astype(np.int32)


def window_bwd_gA(out_panel, win_step, g, B, *, TM, W, units=None):
    """Gradient of the dense half wrt A's values:
    g_A[s][:, j·W:(j+1)·W] = g[out_panel[s]·TM : +TM] · B[win_step[s·G+j]·W : +W]ᵀ.
    Sentinel windows, and B rows ≥ n, give zeros.  Returns f32 [S, TM, G·W].
    ``units`` are the steps' work units, as the forward takes them (a plan's
    ``panel_units``); each CUDA block owns one and keeps its cotangent tile
    resident.  Without them the CUDA path derives them from the runs of
    ``out_panel`` (:func:`panel_runs`, ``FWD_CHUNK_STEPS``).

    CUDA tensors launch ``csrc/window_spmm_bwd.cu`` (and count the launch
    in ``window_bwd_gA.launches``); CPU tensors take
    :func:`window_bwd_gA_plain`.  Anything else raises."""
    if g.dim() != 2 or B.dim() != 2 or g.shape[1] != B.shape[1]:
        raise ValueError(f"g and B must be 2-D with one k, got "
                         f"{tuple(g.shape)}, {tuple(B.shape)}")
    S = out_panel.shape[0]
    if W <= 0 or TM <= 0 or g.shape[0] % TM or (S and win_step.shape[0] % S):
        raise ValueError(f"g rows {g.shape[0]} / win_step "
                         f"{win_step.shape[0]} do not fit TM={TM}, S={S}")
    G = win_step.shape[0] // S if S else 0
    check_operands({"out_panel": (out_panel, S),
                     "win_step": (win_step, S * G)}, {"g": g, "B": B})
    _check_units(units, g.device)
    if g.device.type == "cpu":
        return window_bwd_gA_plain(out_panel, win_step, g, B, TM=TM, W=W)
    if g.device.type != "cuda":
        raise ValueError(f"no window kernel for device {g.device}")
    _check_window_kernel_operands(W, g=g, B=B)
    if units is None:  # a trip to the host: a plan carries its own
        units = device_units(panel_runs(out_panel.cpu().numpy()),
                             FWD_CHUNK_STEPS, g.device)
    # the largest units first, so the last blocks to start are short ones
    tab = units[0]
    unit_tab = tab[torch.argsort(tab[:, 1] - tab[:, 2], stable=True)]
    n, k = B.shape
    from flex_tpu_torch import kernels

    # every tile is written by the kernel, sentinel tiles as zeros
    g_A = torch.empty((S, TM, G * W), dtype=torch.float32, device=g.device)
    kernels.launch("window_spmm_bwd", "flex_window_bwd_gA", g.device,
                   g.data_ptr(), B.data_ptr(), win_step.data_ptr(),
                   out_panel.data_ptr(), unit_tab.data_ptr(), g_A.data_ptr(),
                   unit_tab.shape[0], TM, G, W, n, k, max(-(-n // W), 1))
    window_bwd_gA.launches += 1
    return g_A


window_bwd_gA.launches = 0


def window_bwd_gB_plain(slot_s, slot_g, slot_ptr, out_panel, A, g, *, W,
                        n_blk_used):
    """Plain PyTorch version of the compact g_B: one bmm A[s]ᵀ·g_panel(s)
    per step (f32 [S, G·W, k], a (W, k) product per window), then
    ``index_add_`` of the real slots' products into their block's rank.
    Returns f32 [n_blk_used·W, k]."""
    S, TM, GW = A.shape
    k = g.shape[1]
    g_p = g.view(-1, TM, k)[out_panel.long()]                  # [S, TM, k]
    gw = torch.bmm(A.transpose(1, 2), g_p).view(S * (GW // W), W, k)
    flat = slot_s.long() * (GW // W) + slot_g.long()
    ptr = slot_ptr.long()
    rank = torch.repeat_interleave(
        torch.arange(n_blk_used, device=A.device), ptr[1:] - ptr[:-1],
        output_size=slot_s.shape[0])
    out = A.new_zeros((n_blk_used, W, k))
    out.index_add_(0, rank, gw[flat])
    return out.view(n_blk_used * W, k)


def window_bwd_gB(slot_s, slot_g, slot_ptr, out_panel, A, g, *, W,
                  n_blk_used, units=None):
    """Gradient of the dense half wrt B, compact: for the r-th distinct
    window block, rows r·W .. r·W+W of the result hold
    Σ over its slots t of A[s][:, slot_g[t]·W : +W]ᵀ · g[out_panel[s]·TM : +TM],
    s = slot_s[t].  Slots are sorted by block id:
    ``slot_ptr[r] .. slot_ptr[r+1]`` are the slots of rank r.
    Returns f32 [n_blk_used·W, k]; the caller scatters it to B's rows.
    ``units`` are the ranks' work units (:func:`device_units` of
    ``slot_ptr`` and ``GB_CHUNK_SLOTS``); without them the CUDA path derives
    them from ``slot_ptr``.

    CUDA tensors launch ``csrc/window_spmm_bwd.cu`` (and count the launch
    in ``window_bwd_gB.launches``): one kernel over the units and, where a
    rank has several, the pass that adds its partial tiles.  CPU tensors
    take :func:`window_bwd_gB_plain`.  Anything else raises."""
    if A.dim() != 3 or g.dim() != 2:
        raise ValueError(f"A must be 3-D and g 2-D, got {A.dim()}, {g.dim()}")
    S, TM, GW = A.shape
    if W <= 0 or GW % W or g.shape[0] % TM:
        raise ValueError(f"A's width {GW} / g's rows {g.shape[0]} do not fit "
                         f"W={W}, TM={TM}")
    n_win = slot_s.shape[0]
    check_operands({"slot_s": (slot_s, n_win), "slot_g": (slot_g, n_win),
                     "slot_ptr": (slot_ptr, n_blk_used + 1),
                     "out_panel": (out_panel, S)}, {"A": A, "g": g})
    _check_units(units, A.device)
    if A.device.type == "cpu":
        return window_bwd_gB_plain(slot_s, slot_g, slot_ptr, out_panel, A, g,
                                   W=W, n_blk_used=n_blk_used)
    if A.device.type != "cuda":
        raise ValueError(f"no window kernel for device {A.device}")
    _check_window_kernel_operands(W, ("A",), A=A, g=g)
    if units is None:  # a trip to the host: a plan carries its own
        units = device_units(slot_ptr.cpu().numpy(), GB_CHUNK_SLOTS, A.device)
    unit_tab, splits, n_parts = units
    k = g.shape[1]
    from flex_tpu_torch import kernels

    out = torch.empty((n_blk_used * W, k), dtype=torch.float32,
                      device=A.device)
    scratch = torch.empty((n_parts, W, k), dtype=torch.float32,
                          device=A.device)
    kernels.launch("window_spmm_bwd", "flex_window_bwd_gB", A.device,
                   A.data_ptr(), g.data_ptr(), slot_s.data_ptr(),
                   slot_g.data_ptr(), unit_tab.data_ptr(),
                   out_panel.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   unit_tab.shape[0], TM, GW // W, W, k)
    reduce_partials("window_spmm_bwd", "flex_window_bwd_gB_reduce", scratch,
                    out, splits)
    window_bwd_gB.launches += 1
    return out


window_bwd_gB.launches = 0


class _WindowSpmm(torch.autograd.Function):
    """The dense half as one differentiable call (counterpart of the JAX
    package's ``_window_pallas_vjp``): forward :func:`window_spmm_fwd`,
    backward :func:`window_bwd_gA` when A needs a gradient and
    :func:`window_bwd_gB` when B does.  The plan's integer tables are
    constants.  A plan stripped of its backward tables gets them derived
    again from ``win_step`` at each backward, so g_B has one route."""

    @staticmethod
    def forward(ctx, plan, A, B):
        ctx.plan = plan
        ctx.save_for_backward(A, B)
        return window_spmm_fwd(plan.first, plan.out_panel, plan.win_step, A,
                               B, n_panels=plan.n_used_panels, W=plan.W,
                               panel_step_ptr=plan.panel_step_ptr,
                               units=plan.panel_units)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        A, B = ctx.saved_tensors
        g = g.contiguous()
        W, n = plan.W, plan.n
        g_A = g_B = None
        if ctx.needs_input_grad[1]:
            g_A = window_bwd_gA(plan.out_panel, plan.win_step, g, B,
                                TM=A.shape[1], W=W, units=plan.panel_units)
        if ctx.needs_input_grad[2]:
            nblk = max(-(-n // W), 1)
            tabs = {"bwd_tabs": plan.bwd_tabs, "slot_ptr": plan.slot_ptr,
                    "slot_units": plan.slot_units,
                    "n_blk_used": plan.n_blk_used}
            if plan.bwd_tabs is None:
                tabs = bwd_device_tables(
                    plan.win_step.cpu().numpy(), plan.out_panel.cpu().numpy(),
                    nblk, A.shape[2] // W, W, A.device)
            # rows of the last block beyond n are computed and dropped
            g_B_pad = B.new_zeros((nblk * W, B.shape[1]))
            if tabs["bwd_tabs"] is not None:   # else no window is real
                slot_s, slot_g, rows = tabs["bwd_tabs"]
                blk = window_bwd_gB(slot_s, slot_g, tabs["slot_ptr"],
                                    plan.out_panel, A, g, W=W,
                                    n_blk_used=tabs["n_blk_used"],
                                    units=tabs["slot_units"])
                g_B_pad.index_copy_(0, rows.long(), blk)
            g_B = g_B_pad[:n]
        return None, g_A, g_B


# ---------------------------------------------------------------------------
# dense half, transposed (narrow k): kernel wrapper + plain version
# ---------------------------------------------------------------------------

def _window_cols_T(win_step, B_T, W):
    """(B_T padded with zero columns up to (nblk+1)·W: the sentinel block
    and the last block's columns ≥ n; i64 [S·G·W] column of every (step,
    window, row-in-window)).  Plain versions only."""
    k, n = B_T.shape
    B_pad = B_T.new_zeros((k, (max(-(-n // W), 1) + 1) * W))
    B_pad[:, :n] = B_T
    return B_pad, _window_rows(win_step, W, B_T.device).view(-1)


def window_spmm_t_fwd_plain(first, out_panel, win_step, A_T, B_T, *,
                            n_panels, W):
    """Plain PyTorch version of the transposed dense half: gather the
    (S, k, G·W) window columns of Bᵀ (sentinel block and columns ≥ n read
    as zero), one bmm with Aᵀ, ``index_add_`` of the step products into
    their panels.  Returns Cᵀ, f32 [k, n_panels·TM]."""
    S, GW, TM = A_T.shape
    k = B_T.shape[0]
    B_pad, cols = _window_cols_T(win_step, B_T, W)
    Bw = B_pad[:, cols].view(k, S, GW).permute(1, 0, 2)     # [S, k, G·W]
    out = torch.bmm(Bw, A_T)                                # [S, k, TM]
    C = A_T.new_zeros((n_panels, k, TM))
    C.index_add_(0, out_panel, out)
    return C.permute(1, 0, 2).reshape(k, n_panels * TM)


def reduce_partials_t(scratch, out_T, splits, n_panels):
    """Second pass of the transposed unit kernel: the tile of Cᵀ of every
    panel named in ``splits`` (k rows of TM floats, n_panels·TM apart) =
    its partial tiles of ``scratch`` ([n_parts, k, TM]) added in unit
    order (``csrc/window_tile.cuh:reduce_partials_strided_kernel``)."""
    from flex_tpu_torch import kernels

    _, k, TM = scratch.shape
    kernels.launch("window_spmm_t", "flex_window_spmm_t_reduce",
                   out_T.device, scratch.data_ptr(), out_T.data_ptr(),
                   splits.data_ptr(), splits.shape[0], n_panels, TM, k)


def window_spmm_t_fwd(first, out_panel, win_step, A_T, B_T, *, n_panels, W,
                      panel_step_ptr, units=None):
    """Transposed dense half of the windowed hybrid:
    outᵀ[:, p·TM : +TM] = Σ over used panel p's steps s and windows g of
    Bᵀ[:, win_step[s·G+g]·W : +W] · Aᵀ[s][g·W : (g+1)·W, :].
    ``A_T`` f32 [S, G·W, TM], ``B_T`` f32 [k, n] (the caller's transpose of
    B, not padded).  Returns Cᵀ, f32 [k, n_panels·TM].  ``units`` are the
    panels' work units (:func:`device_units` of ``panel_step_ptr`` and
    ``FWD_CHUNK_STEPS``); without them the CUDA path derives them from
    ``panel_step_ptr``.

    CUDA tensors launch ``csrc/window_spmm_t.cu`` (and count the launch in
    ``window_spmm_t_fwd.launches``): one kernel over the units and, where a
    panel has several, the pass that adds its partial tiles into its
    strided tile of Cᵀ.  CPU tensors take :func:`window_spmm_t_fwd_plain`.
    Anything else raises."""
    if A_T.dim() != 3 or B_T.dim() != 2:
        raise ValueError(f"A_T must be 3-D and B_T 2-D, got {A_T.dim()}, "
                         f"{B_T.dim()}")
    S, GW, TM = A_T.shape
    if W <= 0 or GW % W:
        raise ValueError(f"A_T's depth {GW} is not a multiple of W={W}")
    check_operands({"first": (first, S), "out_panel": (out_panel, S),
                     "win_step": (win_step, S * (GW // W)),
                     "panel_step_ptr": (panel_step_ptr, n_panels + 1)},
                    {"A_T": A_T, "B_T": B_T})
    _check_units(units, A_T.device)
    if A_T.device.type == "cpu":
        return window_spmm_t_fwd_plain(first, out_panel, win_step, A_T, B_T,
                                       n_panels=n_panels, W=W)
    if A_T.device.type != "cuda":
        raise ValueError(f"no window kernel for device {A_T.device}")
    k, n = B_T.shape
    # the kernel moves A_T and the result by float4 along TM
    if TM % 4:
        raise ValueError(f"the transposed window kernel needs TM % 4 == 0, "
                         f"got TM={TM}")
    _check_window_kernel_operands(W, ("A_T",), A_T=A_T, B_T=B_T)
    if units is None:  # a trip to the host: a plan carries its own
        units = device_units(panel_step_ptr.cpu().numpy(), FWD_CHUNK_STEPS,
                             A_T.device)
    unit_tab, splits, n_parts = units
    from flex_tpu_torch import kernels

    out = torch.empty((k, n_panels * TM), dtype=torch.float32,
                      device=A_T.device)
    scratch = torch.empty((n_parts, k, TM), dtype=torch.float32,
                          device=A_T.device)
    kernels.launch("window_spmm_t", "flex_window_spmm_t_fwd", A_T.device,
                   A_T.data_ptr(), B_T.data_ptr(), win_step.data_ptr(),
                   unit_tab.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   unit_tab.shape[0], n_panels, TM, GW // W, W, n, k,
                   max(-(-n // W), 1))
    reduce_partials_t(scratch, out, splits, n_panels)
    window_spmm_t_fwd.launches += 1
    return out


window_spmm_t_fwd.launches = 0


class _WindowSpmmT(torch.autograd.Function):
    """The transposed dense half as one differentiable call (counterpart
    of the JAX package's ``_window_pallas_t_vjp``): forward
    :func:`window_spmm_t_fwd`; backward in plain tensor ops, as there,
    g_Aᵀ(s) = Bᵀw(s)ᵀ · g_panelᵀ(s) and g_Bᵀ = Σ g_panelᵀ(s) · Aᵀ(s)ᵀ
    scatter-added into the gathered window columns."""

    @staticmethod
    def forward(ctx, plan, A_T, B_T):
        ctx.plan = plan
        ctx.save_for_backward(A_T, B_T)
        return window_spmm_t_fwd(plan.first, plan.out_panel, plan.win_step,
                                 A_T, B_T, n_panels=plan.n_used_panels,
                                 W=plan.W, panel_step_ptr=plan.panel_step_ptr,
                                 units=plan.panel_units)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        A_T, B_T = ctx.saved_tensors
        S, GW, TM = A_T.shape
        k, n = B_T.shape
        g_p = g.reshape(k, plan.n_used_panels, TM).permute(1, 0, 2)[
            plan.out_panel.long()]                            # [S, k, TM]
        B_pad, cols = _window_cols_T(plan.win_step, B_T, plan.W)
        g_AT = g_BT = None
        if ctx.needs_input_grad[1]:
            Bw = B_pad[:, cols].view(k, S, GW).permute(1, 2, 0)
            g_AT = torch.bmm(Bw, g_p)                         # [S, G·W, TM]
        if ctx.needs_input_grad[2]:
            gw = torch.bmm(g_p, A_T.transpose(1, 2))          # [S, k, G·W]
            g_BT = torch.zeros_like(B_pad).index_add_(
                1, cols, gw.permute(1, 0, 2).reshape(k, S * GW))[:, :n]
        return None, g_AT, g_BT


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WindowedPlan:
    """Hybrid plan: dense windowed half + ELL residue."""
    m: int
    n: int
    tm: int
    W: int
    n_used_panels: int
    A: torch.Tensor               # f32 [total_steps, TM, G*W]; transposed:
                                  # [total_steps, G*W, TM]
    first: torch.Tensor           # i32 [total_steps]
    out_panel: torch.Tensor       # i32 [total_steps]
    win_step: torch.Tensor        # i32 [total_steps*G] (sentinel = nblk)
    row_gather: torch.Tensor      # i32 [P*TM] output-assembly permutation
    panel_step_ptr: torch.Tensor  # i32 [n_used_panels+1]
    ell: EllPlan                  # residue
    coverage: float
    min_count_eff: int = 0
    # block-sorted slot tables of the backward, i32: (slot_s, slot_g, rows);
    # None = no real window, or derive them at each backward
    bwd_tabs: tuple | None = None
    n_blk_used: int = 0                      # distinct window blocks
    slot_ptr: torch.Tensor | None = None     # i32 [n_blk_used+1]
    transposed: bool = False  # Aᵀ step layout + the narrow-k kernel
    # work units of the unit kernels, (units i32 [U, 4], splits i32 [P, 3],
    # number of partial tiles): of the panels' steps (forward) and of the
    # ranks' slots (g_B); None = derive them at each call
    panel_units: tuple | None = None
    slot_units: tuple | None = None
    n_windows: int = 0       # real (non-sentinel) window slots
    covered_nnz: int = 0     # nnz inside kept windows
    # the dense half: "pallas" = kernel 1 (its port), "xla" = the plain
    # product window_spmm_fwd_plain (the counterpart of _window_xla)
    impl: str = "pallas"

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        return _windowed_call(self, B)

    @property
    def b_dtype(self) -> str:
        """The residue's gather dtype; the dense half is f32."""
        return self.ell.b_dtype

    def dense_half(self, B: torch.Tensor) -> torch.Tensor:
        """The windowed product alone, f32 [n_used_panels·TM, k];
        differentiable in B and in ``self.A``.  A transposed plan makes
        Bᵀ once per call, runs its kernel for Cᵀ and transposes back.
        ``impl="xla"`` (row-major only, as in the JAX package) takes the
        plain product on any device, differentiated by autograd."""
        if self.transposed:
            return _WindowSpmmT.apply(self, self.A, B.t().contiguous()).t()
        if self.impl == "xla":
            return window_spmm_fwd_plain(
                self.first, self.out_panel, self.win_step, self.A, B,
                n_panels=self.n_used_panels, W=self.W)
        return _WindowSpmm.apply(self, self.A, B)

    @property
    def stats(self) -> dict:
        """The JAX plan's format-inflation counters: ``pad_ratio`` = residue
        gathered rows / real residue nnz, ``step_fill`` = real window slots
        / (steps·G), ``dense_occ`` = covered nnz / dense elements; plus the
        longest panel's step count."""
        a_elems = int(np.prod(self.A.shape))
        s = {
            "coverage": round(self.coverage, 4),
            "dense_bytes": a_elems * 4,
            "n_steps": int(self.A.shape[0]),
            "n_res": self.ell.nnz,
            "W": self.W,
            "impl": self.impl,
            "min_count_eff": self.min_count_eff,
            "transposed": self.transposed,
            "pad_ratio": round(self.ell.padded_nnz / self.ell.nnz, 4)
            if self.ell.nnz else 1.0,  # empty residue: no inflation
            "max_steps_per_panel": int(
                (self.panel_step_ptr[1:] - self.panel_step_ptr[:-1]).max())
            if self.n_used_panels else 0,
        }
        if self.n_windows and self.A.dim() == 3:
            s["step_fill"] = round(
                self.n_windows / max(int(self.A.shape[0]) * self._g_step(), 1),
                4)
        if self.covered_nnz:
            s["dense_occ"] = round(self.covered_nnz / max(a_elems, 1), 6)
        return s

    def for_training(self) -> "WindowedPlan":
        """The plan a train step differentiates through
        (:func:`.models.common.training_plan`): this one with a transposed
        residue backward (:func:`with_training_bwd`; training
        differentiates only the parameters, and the adjacency is a
        constant)."""
        return self if self.ell.bwd_plan is not None \
            else with_training_bwd(self)

    def _g_step(self) -> int:
        return int(self.A.shape[1 if self.transposed else 2]) // self.W

    def traffic_model(self, k: int) -> dict:
        """Byte model (the JAX package's): dense windowed A read once; per
        window slot one (W, k) block of B (an upper bound); the output
        assembled by one m-row gather; plus the residue's ELL model."""
        st = self.stats
        by = (st["dense_bytes"]
              + st["n_steps"] * self._g_step() * self.W * k * 4
              + 3 * self.m * k * 4)
        res = self.ell.traffic_model(k) if self.ell.nnz else {"bytes": 0}
        return {"bytes": int(by) + res["bytes"]}


def _windowed_call(plan: WindowedPlan, B: torch.Tensor) -> torch.Tensor:
    if B.dim() != 2 or B.shape[0] != plan.n:
        raise ValueError(f"B must be ({plan.n}, k), got {tuple(B.shape)}")
    k = B.shape[1]
    if plan.A.shape[0]:
        out = plan.dense_half(B)
        cat = torch.cat([out, out.new_zeros((1, k))])
        dense = cat.index_select(0, plan.row_gather[:plan.m])
    else:
        dense = B.new_zeros((plan.m, k))
    # the residue adds into the dense half in place
    return dense if plan.ell.nnz == 0 else plan.ell(B, into=dense)


def prepare_windowed(
    g: CSRGraph,
    dev: DeviceCSR | None = None,
    tm: int = 256,
    W: int = 128,
    J: int = 1024,
    min_count: int = 128,
    min_coverage: float = MIN_COVERAGE,
    max_dense_bytes: int = MAX_DENSE_BYTES,
    b_dtype: str = "float32",
    interpret: bool | None = None,
    impl: str = "pallas",
    sel: dict | None = None,
    g_step: int = G,
    step_order: str = "row",
    fused: bool | str = True,
    transposed: bool = False,
    *,
    device=None,
) -> WindowedPlan:
    """Build the hybrid plan on ``dev``'s device (or ``device``, a keyword
    after the JAX parameters; CUDA when neither is given).  Refuses (ValueError) when windows would cover less
    than ``min_coverage`` of nnz.  When the dense array at ``min_count``
    would exceed ``max_dense_bytes`` the count gate rises until it fits
    (see :func:`window_select`, which also takes ``g_step`` and
    ``step_order``).  A ``sel`` from :func:`window_select` is reused, with
    its device tables.  ``transposed`` builds the Aᵀ step layout for the
    narrow-k kernel; such a plan carries no backward tables (its gradients
    are plain tensor ops).

    The JAX package's options: ``b_dtype`` is the residue's gather dtype
    (:func:`.ell_spmm.check_b_dtype`; the dense half stays f32).
    ``fused`` names one of the JAX package's builds (``True``, ``False``,
    ``"scatter"``, ``"scatter2"``); the port has one build for every name
    (:func:`_build_windowed_ell`, scatter2's: A and the residue in one
    value scatter), since on the JAX package's own tables the names differ
    only in how they are assembled.  ``fused="scatter2"`` keeps the JAX
    package's refusal of a combined buffer past int32 indexing, so the
    same calls are refused.  ``impl="xla"`` runs the dense half as the
    plain product.  ``interpret`` is accepted and ignored: the card has no
    interpret mode."""
    check_b_dtype(b_dtype)
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    if fused not in (True, False, "scatter", "scatter2"):
        raise ValueError(f"unknown fused {fused!r}")
    check_interpret(interpret)
    if transposed and W % 128 != 0:
        # kept from the JAX package, so the same calls are refused
        raise ValueError(
            f"transposed windowed requires W % 128 == 0, got W={W} — "
            f"use W=128 or transposed=False")
    dev = resident_csr(g, dev, device)
    device = dev.device
    cap = min(max_dense_bytes, (2**31 - 2) * 4)
    if sel is None:
        sel = window_select(g, tm=tm, W=W, J=J, min_count=min_count,
                            g_step=g_step, step_order=step_order,
                            max_dense_bytes=cap)
    if sel["dense_bytes"] > cap:
        raise ValueError(
            f"windowed dense array too big: {sel['dense_bytes']/1e9:.2f} GB")
    if sel["coverage"] < min_coverage:
        raise ValueError(
            f"window coverage {sel['coverage']:.3f} < {min_coverage} — "
            f"use 'ell' (or apply a clustering ordering like rbdeg first)")

    tabs = _device_tables(sel, device)
    res = residue_layout(sel, device)
    if fused == "scatter2" and sel["a_elems"] + res["padded"] >= 2**31:
        raise ValueError("scatter2 combined buffer exceeds int32 indexing")
    layout = (g.nnz, g.m, tm, W, sel["nblk"], sel["total_steps"], sel["G"],
              bool(sel["unique_rc"]), bool(transposed))
    A, buckets, chunk_row, res_rows = _build_windowed_ell(
        dev.row_ptr, dev.col, dev.vals, tabs["slot"], tabs["pstep0"], res,
        layout=layout)
    # the gather assembly, attached even to an empty residue, as the JAX
    # package's fused builds do
    res_deg = np.asarray(sel["res_deg"], dtype=np.int64)
    chunk1, extras = _gather_assembly_tables(
        chunk_row, m=g.m,
        n_extras=int(chunk_row.shape[0]) - int((res_deg > 0).sum()))
    ell = EllPlan(m=g.m, buckets=buckets, chunk_row=chunk_row,
                  padded_nnz=res["padded"], nnz=int(sel["n_res"]),
                  chunk1=chunk1, extras=extras, rows=res_rows,
                  b_dtype=b_dtype)
    return plan_from_selection(sel, tabs, A, ell, m=g.m, n=g.n, nnz=g.nnz,
                               tm=tm, W=W, transposed=transposed, impl=impl)


def plan_from_selection(sel: dict, tabs: dict, A, ell: EllPlan, *, m: int,
                        n: int, nnz: int, tm: int, W: int,
                        transposed: bool = False,
                        impl: str = "pallas") -> WindowedPlan:
    """The :class:`WindowedPlan` of a selection, its device tables
    (:func:`_device_tables`), the built A and the residue plan; ``nnz`` is
    the graph's (the selection's rows)."""
    return WindowedPlan(
        m=m, n=n, tm=tm, W=W, n_used_panels=int(sel["n_used_panels"]),
        A=A, first=tabs["first"], out_panel=tabs["out_panel"],
        win_step=tabs["win_step"], row_gather=tabs["row_gather"],
        panel_step_ptr=tabs["panel_step_ptr"], ell=ell,
        coverage=sel["coverage"],
        min_count_eff=int(sel["min_count_eff"]),
        bwd_tabs=None if transposed else tabs["bwd_tabs"],
        n_blk_used=0 if transposed else tabs["n_blk_used"],
        slot_ptr=None if transposed else tabs["slot_ptr"],
        transposed=bool(transposed),
        panel_units=tabs["panel_units"],
        slot_units=None if transposed else tabs["slot_units"],
        n_windows=int(np.count_nonzero(sel["win_step"] != sel["nblk"])),
        covered_nnz=int(nnz - sel["n_res"]), impl=impl,
    )


def spmm_windowed(g: CSRGraph, B, device=None, **kw) -> torch.Tensor:
    """:func:`prepare_windowed` (``kw``), then the call on B (NumPy or a
    tensor, moved to the plan's device)."""
    dev = resident_csr(g, kw.pop("dev", None), device)
    return prepare_windowed(g, dev=dev, **kw)(dense_operand(B, dev.device))


def with_training_bwd(plan: WindowedPlan) -> WindowedPlan:
    """Copy of ``plan`` whose residue ELL carries a transposed-pattern
    backward plan (:func:`.ell_spmm.with_bwd_plan`): the residue's g_B then
    runs as A_resᵀ·g through the ELL forward instead of autograd's
    scatter-add over the padded gathered rows.  Valid only when A's values
    are constants (a graph adjacency): gradients wrt the residue's values
    are not propagated."""
    if plan.ell.nnz == 0 or not plan.ell.buckets:
        return plan
    from flex_tpu_torch.ops.ell_spmm import with_bwd_plan

    return dataclasses.replace(plan, ell=with_bwd_plan(plan.ell, plan.n))
