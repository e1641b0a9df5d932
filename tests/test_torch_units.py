"""Work units of the window kernels that are cut across CUDA blocks (the
forward, g_B and the transposed forward), on the CPU: the unit tables
partition every panel's steps and every block rank's slots; a NumPy
two-pass emulation over the unit table (one partial tile per unit, a split
owner's partials added in unit order, into a strided tile of Cᵀ for the
transposed kernel) equals the plain versions and the JAX package's Pallas
kernels in interpret mode (rtol = atol = 1e-5: f32 sums in another order);
a plan converted from the JAX plan's arrays carries the same unit tables as
the port's own build.  The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.window_spmm import (
    _window_bwd_gB_raw, _window_pallas_raw, _window_pallas_t_raw,
)
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed

from flex_tpu_torch.convert import windowed_plan_from_numpy
from flex_tpu_torch.io import make_features
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
    FWD_CHUNK_STEPS, GB_CHUNK_SLOTS, device_units, panel_step_ptr,
    prepare_windowed, window_bwd_gB, window_bwd_gB_plain, window_spmm_fwd,
    window_spmm_fwd_plain, window_spmm_t_fwd, window_spmm_t_fwd_plain,
    work_units,
)
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import jax_graph
from test_torch_windowed import CASES, jax_windowed_dict

TOL = dict(rtol=1e-5, atol=1e-5)


def hub_graph(m=8192, W=128, tm=256, seed=11):
    """Panel 0 meets every column block (16 steps of 4 windows: two full
    units), every panel meets column block 5 (a chain of 32 slots) and its
    own diagonal blocks; values in (-1, 1)."""
    rng = np.random.default_rng(seed)
    nblk, P = m // W, m // tm
    rows, cols = [], []
    for b in range(nblk):                       # the hub panel
        rows.append(rng.integers(0, tm, 150))
        cols.append(b * W + rng.integers(0, W, 150))
    for p in range(1, P):
        for b in (5, 2 * p, 2 * p + 1):         # hub block + the diagonal
            rows.append(p * tm + rng.integers(0, tm, 150))
            cols.append(b * W + rng.integers(0, W, 150))
    key = np.unique(np.concatenate(rows) * m + np.concatenate(cols))
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    return CSRGraph.from_coo(key // m, key % m, vals, m, name="hub_panel")


HUB_KW = dict(tm=256, W=128, J=1024, min_count=64)
UNIT_CASES = dict(CASES, hub_panel=(hub_graph, HUB_KW))


def _check_partition(ptr, units, splits, chunk):
    ptr = np.asarray(ptr, np.int64)
    owner, lo, hi, part = units.T
    assert units.dtype == splits.dtype == np.int32
    assert np.all(np.diff(owner) >= 0) and np.all(hi - lo <= chunk)
    for i in range(len(ptr) - 1):
        mine = np.flatnonzero(owner == i)
        assert len(mine) >= 1                    # an empty owner keeps one
        assert lo[mine[0]] == ptr[i] and hi[mine[-1]] == ptr[i + 1]
        np.testing.assert_array_equal(lo[mine[1:]], hi[mine[:-1]])
        if len(mine) == 1:
            assert part[mine[0]] == -1
        else:
            assert np.all(hi[mine] > lo[mine])   # no empty unit in a split
            np.testing.assert_array_equal(np.diff(part[mine]), 1)
            row = splits[splits[:, 0] == i]
            assert row.tolist() == [[i, part[mine[0]], part[mine[-1]] + 1]]
    real = part[part >= 0]
    np.testing.assert_array_equal(real, np.arange(len(real)))
    assert len(splits) == len(np.unique(owner[part >= 0]))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_work_units_partition_hand_ranges(chunk):
    """Ranges of length 0, 1, chunk, chunk + 1 and many chunks."""
    length = np.array([0, 1, chunk, chunk + 1, 0, 7 * chunk + 2, 1, 0])
    ptr = np.concatenate([[0], np.cumsum(length)])
    units, splits = work_units(ptr, chunk)
    _check_partition(ptr, units, splits, chunk)
    per = np.bincount(units[:, 0], minlength=len(length))
    np.testing.assert_array_equal(per, np.maximum(-(-length // chunk), 1))
    u0, s0 = work_units(np.array([0]), chunk)
    assert u0.shape == (0, 4) and s0.shape == (0, 3)


@pytest.mark.parametrize("name", sorted(UNIT_CASES))
def test_plan_units_partition_steps_and_slots(name):
    make, kw = UNIT_CASES[name]
    plan = prepare_windowed(make(), device="cpu", **kw)
    units, splits, n_parts = plan.panel_units
    _check_partition(plan.panel_step_ptr.numpy(), units.numpy(),
                     splits.numpy(), FWD_CHUNK_STEPS)
    assert n_parts == int((units[:, 3] >= 0).sum())
    units, splits, n_parts = plan.slot_units
    _check_partition(plan.slot_ptr.numpy(), units.numpy(), splits.numpy(),
                     GB_CHUNK_SLOTS)
    assert n_parts == int((units[:, 3] >= 0).sum())
    assert int(units[-1, 2]) == plan.bwd_tabs[0].shape[0]
    if name == "hub_panel":
        steps = np.diff(plan.panel_step_ptr.numpy())
        assert steps.max() == 2 * FWD_CHUNK_STEPS and np.median(steps) == 1
        assert plan.panel_units[2] == 2 and plan.panel_units[1].shape[0] == 1
        assert np.diff(plan.slot_ptr.numpy()).max() == 2 * GB_CHUNK_SLOTS
        assert plan.slot_units[2] == 2


def test_units_of_a_plan_without_a_real_window():
    g = hub_graph()
    plan = prepare_windowed(g, device="cpu", min_coverage=0.0,
                            **dict(HUB_KW, min_count=10**6))
    assert plan.A.shape[0] == 0 and plan.slot_units is None
    assert plan.panel_units[0].shape == (0, 4) and plan.panel_units[2] == 0
    B = make_features(g, 8)
    C = plan(torch.from_numpy(B)).numpy()
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def _emulate_fwd(plan, B):
    """What csrc/window_spmm.cu computes, in NumPy: one tile per unit, then
    a split panel's partial tiles added in unit order."""
    S, TM, GW = plan.A.shape
    W, k = plan.W, B.shape[1]
    nblk = -(-plan.n // W)
    B_pad = np.zeros(((nblk + 1) * W, k), np.float32)
    B_pad[:plan.n] = B
    A, win = plan.A.numpy(), plan.win_step.numpy().reshape(S, -1)
    units, splits, n_parts = (np.asarray(t) for t in plan.panel_units)
    out = np.full((plan.n_used_panels, TM, k), np.nan, np.float32)
    scratch = np.full((int(n_parts), TM, k), np.nan, np.float32)
    for panel, lo, hi, part in units:
        acc = np.zeros((TM, k), np.float32)
        for s in range(lo, hi):
            for j, blk in enumerate(win[s]):
                if blk < nblk:
                    acc += A[s][:, j * W:(j + 1) * W] @ B_pad[blk * W:][:W]
        (out if part < 0 else scratch)[panel if part < 0 else part] = acc
    for panel, p_lo, p_hi in splits:
        acc = scratch[p_lo].copy()
        for p in range(p_lo + 1, p_hi):
            acc += scratch[p]
        out[panel] = acc
    return out.reshape(-1, k)


def _emulate_gB(plan, g):
    """What csrc/window_spmm_bwd.cu's g_B computes, in NumPy."""
    S, TM, GW = plan.A.shape
    W, k = plan.W, g.shape[1]
    A, panel_of = plan.A.numpy(), plan.out_panel.numpy()
    slot_s, slot_g, _ = (t.numpy() for t in plan.bwd_tabs)
    units, splits, n_parts = (np.asarray(t) for t in plan.slot_units)
    out = np.full((plan.n_blk_used, W, k), np.nan, np.float32)
    scratch = np.full((int(n_parts), W, k), np.nan, np.float32)
    for rank, lo, hi, part in units:
        acc = np.zeros((W, k), np.float32)
        for t in range(lo, hi):
            s, j = slot_s[t], slot_g[t]
            acc += A[s][:, j * W:(j + 1) * W].T @ g[panel_of[s] * TM:][:TM]
        (out if part < 0 else scratch)[rank if part < 0 else part] = acc
    for rank, p_lo, p_hi in splits:
        acc = scratch[p_lo].copy()
        for p in range(p_lo + 1, p_hi):
            acc += scratch[p]
        out[rank] = acc
    return out.reshape(-1, k)


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name", ["hub_panel", "variable_steps"])
def test_two_pass_forward_matches_plain_and_pallas(name, k):
    make, kw = UNIT_CASES[name]
    g = make()
    jp = j_prepare_windowed(jax_graph(g), **kw)
    plan = windowed_plan_from_numpy(jax_windowed_dict(jp), "cpu")
    B = make_features(g, k)
    emu = _emulate_fwd(plan, B)
    assert not np.isnan(emu).any()              # every tile was written
    args = (plan.first, plan.out_panel, plan.win_step, plan.A,
            torch.from_numpy(B))
    kw2 = dict(n_panels=plan.n_used_panels, W=plan.W)
    np.testing.assert_allclose(
        emu, window_spmm_fwd_plain(*args, **kw2).numpy(), **TOL)
    # the wrapper takes the unit tables and, on the CPU, the plain version
    via = window_spmm_fwd(*args, panel_step_ptr=plan.panel_step_ptr,
                          units=plan.panel_units, **kw2)
    np.testing.assert_allclose(emu, via.numpy(), **TOL)
    nblk = -(-g.n // plan.W)
    B_pad = jnp.zeros(((nblk + 1) * plan.W, k), jnp.float32).at[:g.n].set(B)
    ref = np.asarray(_window_pallas_raw(
        jp.first, jp.out_panel, jp.win_step, jp.A, B_pad,
        n_panels=jp.n_used_panels, W=jp.W, k=k,
        precision=jax.lax.Precision.HIGHEST, interpret=True))
    np.testing.assert_allclose(emu, ref, **TOL)


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name", ["hub_panel", "variable_steps"])
def test_two_pass_gB_matches_plain_and_pallas(name, k):
    make, kw = UNIT_CASES[name]
    g = make()
    jp = j_prepare_windowed(jax_graph(g), **kw)
    plan = windowed_plan_from_numpy(jax_windowed_dict(jp), "cpu")
    # a cotangent in (-0.5, 0.5): sums of 256 products stay near 1
    co = (np.random.default_rng(0).random(
        (plan.n_used_panels * plan.tm, k), np.float32) - 0.5)
    emu = _emulate_gB(plan, co)
    assert not np.isnan(emu).any()
    ts, tg, _ = plan.bwd_tabs
    args = (ts, tg, plan.slot_ptr, plan.out_panel, plan.A,
            torch.from_numpy(co))
    kw2 = dict(W=plan.W, n_blk_used=plan.n_blk_used)
    np.testing.assert_allclose(
        emu, window_bwd_gB_plain(*args, **kw2).numpy(), **TOL)
    via = window_bwd_gB(*args, units=plan.slot_units, **kw2)
    np.testing.assert_allclose(emu, via.numpy(), **TOL)
    slot_s, slot_g, panel_of, rank, bfirst, _ = jp.bwd_tabs
    ref = np.asarray(_window_bwd_gB_raw(
        slot_s, slot_g, panel_of, rank, bfirst, jp.A, jnp.asarray(co),
        TM=jp.tm, W=jp.W, k=k, n_panels=jp.n_used_panels,
        n_blk_used=jp.n_blk_used, precision=jax.lax.Precision.HIGHEST,
        interpret=True))
    np.testing.assert_allclose(emu, ref, **TOL)


@pytest.mark.parametrize("name", sorted(UNIT_CASES))
def test_convert_carries_the_same_unit_tables(name):
    make, kw = UNIT_CASES[name]
    g = make()
    mine = prepare_windowed(g, device="cpu", **kw)
    conv = windowed_plan_from_numpy(
        jax_windowed_dict(j_prepare_windowed(jax_graph(g), **kw)), "cpu")
    for field in ("panel_units", "slot_units"):
        a, b = getattr(mine, field), getattr(conv, field)
        assert a[2] == b[2]
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == y.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    # the transposed plan keeps the panels' units and has no slot tables
    t = prepare_windowed(g, device="cpu", transposed=True, **kw)
    np.testing.assert_array_equal(t.panel_units[0].numpy(),
                                  mine.panel_units[0].numpy())
    assert t.slot_units is None


def test_wrappers_reject_bad_unit_tables():
    make, kw = UNIT_CASES["hub_panel"]
    plan = prepare_windowed(make(), device="cpu", **kw)
    B = torch.ones((plan.n, 4))
    args = (plan.first, plan.out_panel, plan.win_step, plan.A, B)
    kw2 = dict(n_panels=plan.n_used_panels, W=plan.W,
               panel_step_ptr=plan.panel_step_ptr)
    units, splits, n_parts = plan.panel_units
    for bad in ((units.long(), splits, n_parts),
                (units[:, :3], splits, n_parts),
                (units, splits.view(-1), n_parts),
                (units.to("meta"), splits, n_parts)):
        with pytest.raises(ValueError):
            window_spmm_fwd(*args, units=bad, **kw2)
    ts, tg, _ = plan.bwd_tabs
    g = torch.ones((plan.n_used_panels * plan.tm, 4))
    with pytest.raises(ValueError):
        window_bwd_gB(ts, tg, plan.slot_ptr, plan.out_panel, plan.A, g,
                      W=plan.W, n_blk_used=plan.n_blk_used,
                      units=(units.long(), splits, n_parts))


# ---------------------------------------------------------------------------
# the transposed forward in units: partial (k, TM) tiles, strided Cᵀ tiles
# ---------------------------------------------------------------------------

def _emulate_t_fwd(t, B_T, units, n_panels, W):
    """What csrc/window_spmm_t.cu computes, in NumPy: one (k, TM) tile per
    unit, written into the panel's strided tile of Cᵀ (k rows, n_panels·TM
    apart) or into a partial tile; then a split panel's partial tiles added
    in unit order and stored into its tile of Cᵀ."""
    A_T, win = t["A_T"], t["win_step"].reshape(t["A_T"].shape[0], -1)
    k, n = B_T.shape
    TM = A_T.shape[2]
    nblk = -(-n // W)
    B_pad = np.zeros((k, (nblk + 1) * W), np.float32)
    B_pad[:, :n] = B_T
    tab, splits, n_parts = (np.asarray(x) for x in units)
    out = np.full((k, n_panels * TM), np.nan, np.float32)
    scratch = np.full((int(n_parts), k, TM), np.nan, np.float32)
    for panel, lo, hi, part in tab:
        acc = np.zeros((k, TM), np.float32)
        for s in range(lo, hi):
            for j, blk in enumerate(win[s]):
                if blk < nblk:
                    acc += B_pad[:, blk * W:(blk + 1) * W] @ \
                        A_T[s][j * W:(j + 1) * W]
        if part < 0:
            out[:, panel * TM:(panel + 1) * TM] = acc
        else:
            scratch[part] = acc
    for panel, p_lo, p_hi in splits:
        acc = scratch[p_lo].copy()
        for p in range(p_lo + 1, p_hi):
            acc += scratch[p]
        out[:, panel * TM:(panel + 1) * TM] = acc
    return out


def _hand_t_tables(TM=128, G=4, W=128, n=3000 + 5, seed=5):
    """Panels of 1, 8, 9 and 17 steps (one unit, exactly one unit, one
    unit plus one, two units plus one); panel 0's only step and one step
    inside each longer panel all sentinels; sentinels elsewhere, the last,
    partial block of B; sparse Aᵀ tiles in (-1, 1)."""
    rng = np.random.default_rng(seed)
    CS = FWD_CHUNK_STEPS
    steps = np.array([1, CS, CS + 1, 2 * CS + 1])
    S, nblk = int(steps.sum()), -(-n // W)
    win = np.sort(rng.integers(0, nblk, (S, G)), axis=1)
    win[::5, -1] = nblk - 1
    win[rng.random((S, G)) < 0.2] = nblk
    win[[0, 3, 12, 30]] = nblk
    first = np.zeros(S, np.int32)
    first[np.r_[0, np.cumsum(steps)[:-1]]] = 1
    A_T = ((2 * rng.random((S, G * W, TM)) - 1)
           * (rng.random((S, G * W, TM)) < 0.05)).astype(np.float32)
    return {"first": first,
            "out_panel": np.repeat(np.arange(len(steps)), steps).astype(
                np.int32),
            "win_step": win.reshape(-1).astype(np.int32), "A_T": A_T,
            "n": n, "W": W, "n_panels": len(steps)}


def _t_case(name):
    """Format tables of a transposed case: a JAX plan's arrays, or the
    hand tables."""
    if name == "hand":
        return _hand_t_tables()
    make, kw = UNIT_CASES[name]
    g = make()
    d = jax_windowed_dict(j_prepare_windowed(jax_graph(g), transposed=True,
                                             **kw))
    return {"first": d["first"], "out_panel": d["out_panel"],
            "win_step": d["win_step"], "A_T": d["A"], "n": g.n, "W": d["W"],
            "n_panels": d["n_used_panels"]}


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name", ["hand", "hub_panel", "variable_steps"])
def test_two_pass_transposed_matches_plain_and_pallas(name, k):
    t = _t_case(name)
    W, n_panels = t["W"], t["n_panels"]
    ptr = panel_step_ptr(t["first"])
    units = work_units(ptr, FWD_CHUNK_STEPS)
    units = (*units, int((units[0][:, 3] >= 0).sum()))
    if name in ("hand", "hub_panel"):
        assert units[2] > 0 and len(units[1]) >= 1     # a split panel
    rng = np.random.default_rng(k)
    B_T = (rng.random((k, t["n"]), np.float32) - 0.5)
    emu = _emulate_t_fwd(t, B_T, units, n_panels, W)
    assert not np.isnan(emu).any()              # every tile was written
    args = [torch.from_numpy(np.array(t[key])) for key in (
        "first", "out_panel", "win_step", "A_T")] + [torch.from_numpy(B_T)]
    kw = dict(n_panels=n_panels, W=W)
    np.testing.assert_allclose(
        emu, window_spmm_t_fwd_plain(*args, **kw).numpy(), **TOL)
    # the wrapper takes the unit tables and, on the CPU, the plain version
    via = window_spmm_t_fwd(*args, panel_step_ptr=torch.from_numpy(ptr),
                            units=device_units(ptr, FWD_CHUNK_STEPS, "cpu"),
                            **kw)
    np.testing.assert_allclose(emu, via.numpy(), **TOL)
    nblk = -(-t["n"] // W)
    kt = -(-k // 8) * 8                          # the Pallas kernel's k
    B_Tp = jnp.zeros((kt, (nblk + 1) * W), jnp.float32).at[:k, :t["n"]].set(
        B_T)
    ref = np.asarray(_window_pallas_t_raw(
        *(jnp.asarray(t[key]) for key in ("first", "out_panel", "win_step",
                                          "A_T")), B_Tp,
        n_panels=n_panels, W=W, k=kt, precision=jax.lax.Precision.HIGHEST,
        interpret=True))[:k]
    np.testing.assert_allclose(emu, ref, **TOL)
