"""The g_A kernel's schedule (csrc/window_spmm_bwd.cu), on the CPU: a NumPy
emulation of what each CUDA block does — one work unit of steps and one
256-row tile of TM, the cotangent tile resident in shared memory in depth
chunks of the cap (128), the unit's windows walked in order in column tiles
of 128, B streamed in stages of 16 depths zero-filled past k and past the
window's rows that exist, sentinel windows written as zeros first — against
``window_bwd_gA_plain`` and the JAX package's ``_window_bwd_gA_raw`` in
interpret mode (rtol = atol = 1e-5: f32 sums in another order), for the
forward's units of panels of 1, 8, 9 and 17 steps and for units of one
step.  Also: the wrapper's ``units=`` checks and the backward's use of
``plan.panel_units``.  The kernel itself runs only on a card:
tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.window_spmm import _window_bwd_gA_raw

from flex_tpu_torch.ops import window_spmm
from flex_tpu_torch.ops.window_spmm import (
    FWD_CHUNK_STEPS, device_units, panel_runs, panel_step_ptr,
    prepare_windowed, window_bwd_gA, window_bwd_gA_plain, work_units,
)
from test_torch_bwd import GRAD_KW, _grad_graph

TOL = dict(rtol=1e-5, atol=1e-5)
BM, BN, BK, KC = 256, 128, 16, 128   # row tile, column tile, stage, depth cap


def emulate_gA(out_panel, win_step, g, B, *, TM, W, units):
    """What the g_A kernel computes, block by block, in NumPy (f32 sums in
    the kernel's order: ascending depth).  Returns (g_A, writes per
    element, resident-tile loads)."""
    S = len(out_panel)
    G = len(win_step) // S
    n, k = B.shape
    nblk = max(-(-n // W), 1)
    n_ks = max(-(-k // BK), 1)
    depth = min(max(-(-k // BK) * BK, BK), KC)
    n_ct = -(-W // BN)
    gA = np.full((S, TM, G * W), np.nan, np.float32)
    writes = np.zeros(gA.shape, np.int32)
    loads = 0
    for _, lo, hi, _ in units:
        slots = range(lo * G, hi * G)
        for row0 in range(0, TM, BM):
            rows = min(BM, TM - row0)
            for sl in slots:                      # sentinels first
                if win_step[sl] >= nblk:
                    s, j = divmod(sl, G)
                    gA[s, row0:row0 + rows, j * W:(j + 1) * W] = 0
                    writes[s, row0:row0 + rows, j * W:(j + 1) * W] += 1
            held = None
            for sl in (x for x in slots if win_step[x] < nblk):
                s, j = divmod(sl, G)
                for ct in range(n_ct):
                    acc = np.zeros((BM, BN), np.float32)
                    for st in range(n_ks):
                        kk = st * BK
                        if kk % KC == 0 and held != (out_panel[s], kk):
                            held = (out_panel[s], kk)
                            loads += 1
                            Gt = np.zeros((BM, depth), np.float32)
                            d = min(depth, k - kk)
                            r0 = out_panel[s] * TM + row0
                            Gt[:rows, :d] = g[r0:r0 + rows, kk:kk + d]
                        Bs = np.zeros((BN, BK), np.float32)  # [column][depth]
                        b0 = win_step[sl] * W + ct * BN
                        c = max(0, min(BN, W - ct * BN, n - b0))
                        d = max(0, min(BK, k - kk))
                        Bs[:c, :d] = B[b0:b0 + c, kk:kk + d]
                        for q in range(BK):
                            acc += Gt[:, kk - held[1] + q, None] * Bs[None, :, q]
                    cols = min(BN, W - ct * BN)
                    c0 = j * W + ct * BN
                    gA[s, row0:row0 + rows, c0:c0 + cols] = acc[:rows, :cols]
                    writes[s, row0:row0 + rows, c0:c0 + cols] += 1
    return gA, writes, loads


def hand_tables(TM, G=4, W=128, n=3 * 128 + 77, seed=0):
    """Panels of 1, 8, 9 and 17 steps (one unit, one full unit, one unit
    plus one, two units plus one) and two trailing empty panels; block ids
    include the last, partial block (n % W != 0); a fraction of sentinel
    windows and one all-sentinel step."""
    rng = np.random.default_rng(seed)
    steps = np.array([1, FWD_CHUNK_STEPS, FWD_CHUNK_STEPS + 1,
                      2 * FWD_CHUNK_STEPS + 1])
    S, nblk = int(steps.sum()), -(-n // W)
    win = np.sort(rng.integers(0, nblk, (S, G)), axis=1)
    win[::3, -1] = nblk - 1
    win[rng.random((S, G)) < 0.25] = nblk
    win[FWD_CHUNK_STEPS + 4] = nblk               # an all-sentinel step
    out_panel = np.repeat(np.arange(len(steps)), steps).astype(np.int32)
    first = np.zeros(S, np.int32)
    first[np.r_[0, np.cumsum(steps)[:-1]]] = 1
    return first, out_panel, win.reshape(-1).astype(np.int32), len(steps) + 2


def _grain_units(first, grain):
    ptr = panel_step_ptr(first)
    return work_units(ptr, FWD_CHUNK_STEPS if grain == "units" else 1)[0]


@pytest.mark.parametrize("grain", ["units", "steps"])
@pytest.mark.parametrize("TM", [128, 256, 384])
@pytest.mark.parametrize("k", [16, 41, 128, 200])
def test_gA_schedule_matches_plain_and_pallas(k, TM, grain):
    W, n = 128, 3 * 128 + 77
    first, out_panel, win, n_panels = hand_tables(TM, W=W, n=n)
    rng = np.random.default_rng(k + TM)
    g = (2 * rng.random((n_panels * TM, k)) - 1).astype(np.float32)
    B = (2 * rng.random((n, k)) - 1).astype(np.float32)
    units = _grain_units(first, grain)
    if grain == "units":
        assert sorted(np.diff(units[:, 1:3]).ravel().tolist()) == \
            [1, 4, 5, 5, 6, 6, 8]
    else:
        assert len(units) == len(out_panel)
    gA, writes, loads = emulate_gA(out_panel, win, g, B, TM=TM, W=W,
                                   units=units)
    np.testing.assert_array_equal(writes, 1)      # every element once
    S, G = len(out_panel), len(win) // len(out_panel)
    sent = (win == -(-n // W)).reshape(S, G)
    assert sent[FWD_CHUNK_STEPS + 4].all()
    assert not gA.reshape(S, TM, G, W)[sent.nonzero()[0], :,
                                       sent.nonzero()[1]].any()
    # the resident tile is loaded once per (unit, row tile) with a real
    # window when k fits the cap, else once per depth chunk of every tile
    blocks = sum(bool((win[lo * G:hi * G] < -(-n // W)).any())
                 for _, lo, hi, _ in units) * -(-TM // BM)
    n_real = int((~sent).sum()) * -(-TM // BM)
    assert loads == (blocks if k <= KC else n_real * -(-k // KC))

    ref = window_bwd_gA_plain(torch.from_numpy(out_panel),
                              torch.from_numpy(win), torch.from_numpy(g),
                              torch.from_numpy(B), TM=TM, W=W)
    np.testing.assert_allclose(gA, ref.numpy(), **TOL)
    nblk = -(-n // W)
    B_pad = jnp.zeros(((nblk + 1) * W, k), jnp.float32).at[:n].set(B)
    pallas = np.asarray(_window_bwd_gA_raw(
        jnp.asarray(first), jnp.asarray(out_panel), jnp.asarray(win),
        jnp.asarray(g), B_pad, S=S, TM=TM, GW=G * W, W=W, k=k,
        n_panels=n_panels, precision=jax.lax.Precision.HIGHEST,
        interpret=True))
    np.testing.assert_allclose(gA, pallas, **TOL)


@pytest.mark.parametrize("W,G", [(64, 2), (256, 2)])
def test_gA_schedule_on_narrow_and_wide_windows(W, G):
    """A window narrower than the 128-column tile (half of it computed and
    dropped) and one of two column tiles, TM below the 256-row tile."""
    TM, n, k = 200, 5 * W + 9, 41
    first, out_panel, win, n_panels = hand_tables(TM, G=G, W=W, n=n, seed=3)
    rng = np.random.default_rng(1)
    g = (2 * rng.random((n_panels * TM, k)) - 1).astype(np.float32)
    B = (2 * rng.random((n, k)) - 1).astype(np.float32)
    gA, writes, _ = emulate_gA(out_panel, win, g, B, TM=TM, W=W,
                               units=_grain_units(first, "units"))
    np.testing.assert_array_equal(writes, 1)
    ref = window_bwd_gA_plain(torch.from_numpy(out_panel),
                              torch.from_numpy(win), torch.from_numpy(g),
                              torch.from_numpy(B), TM=TM, W=W)
    np.testing.assert_allclose(gA, ref.numpy(), **TOL)


def test_gA_schedule_on_a_plan_and_units_across_panels():
    """On a plan's own tables and units; and on units that cut across
    panels (one unit of all steps): the resident tile follows the panel."""
    plan = prepare_windowed(_grad_graph(), device="cpu", **GRAD_KW)
    S, TM, GW = plan.A.shape
    rng = np.random.default_rng(5)
    g = (2 * rng.random((plan.n_used_panels * TM, 41)) - 1).astype(np.float32)
    B = (2 * rng.random((plan.n, 41)) - 1).astype(np.float32)
    op, win = plan.out_panel.numpy(), plan.win_step.numpy()
    ref = window_bwd_gA_plain(plan.out_panel, plan.win_step,
                              torch.from_numpy(g), torch.from_numpy(B),
                              TM=TM, W=plan.W).numpy()
    np.testing.assert_array_equal(plan.panel_units[0].numpy(), work_units(
        panel_runs(op), FWD_CHUNK_STEPS)[0])
    for units in (plan.panel_units[0].numpy(), np.array([[0, 0, S, -1]])):
        gA, writes, loads = emulate_gA(op, win, g, B, TM=TM, W=plan.W,
                                       units=units)
        np.testing.assert_array_equal(writes, 1)
        np.testing.assert_allclose(gA, ref, **TOL)
    assert loads == len(np.unique(op)) * TM // BM > TM // BM


def test_panel_runs_are_the_forward_panels():
    first, out_panel, _, _ = hand_tables(256)
    np.testing.assert_array_equal(panel_runs(out_panel),
                                  panel_step_ptr(first))
    np.testing.assert_array_equal(panel_runs(np.zeros(0, np.int32)), [0])


def test_gA_wrapper_checks_its_unit_tables():
    """``units=`` as the forward takes it: on the CPU the plain version
    answers, and a malformed table raises there too."""
    plan = prepare_windowed(_grad_graph(), device="cpu", **GRAD_KW)
    TM, W = plan.tm, plan.W
    g = torch.ones((plan.n_used_panels * TM, 4))
    B = torch.ones((plan.n, 4))
    args = (plan.out_panel, plan.win_step, g, B)
    ref = window_bwd_gA(*args, TM=TM, W=W)
    torch.testing.assert_close(
        window_bwd_gA(*args, TM=TM, W=W, units=plan.panel_units), ref,
        rtol=0, atol=0)
    tab, splits, n_parts = plan.panel_units
    for bad in ((tab[:, :3], splits, n_parts), (tab.long(), splits, n_parts),
                (tab, splits[:, :2], n_parts)):
        with pytest.raises(ValueError):
            window_bwd_gA(*args, TM=TM, W=W, units=bad)


def test_backward_passes_the_plans_units(monkeypatch):
    seen = []
    fn = window_spmm.window_bwd_gA
    monkeypatch.setattr(window_spmm, "window_bwd_gA",
                        lambda *a, **kw: seen.append(kw) or fn(*a, **kw))
    plan = prepare_windowed(_grad_graph(), device="cpu", **GRAD_KW)
    A = plan.A.clone().requires_grad_()
    dataclasses.replace(plan, A=A).dense_half(
        torch.ones((plan.n, 4))).sum().backward()
    assert len(seen) == 1 and seen[0]["units"] is plan.panel_units
    assert A.grad is not None


def test_device_units_of_one_step_each():
    """The step grain is a table of one-step units."""
    tab, splits, n_parts = device_units(np.arange(6, dtype=np.int32), 1,
                                        "cpu")
    np.testing.assert_array_equal(tab[:, 1].numpy(), np.arange(5))
    np.testing.assert_array_equal(tab[:, 2].numpy(), np.arange(1, 6))
    assert splits.shape == (0, 3) and n_parts == 0
