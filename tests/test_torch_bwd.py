"""Backward of the PyTorch port against the JAX package, on the CPU: the
host backward tables (array equality), the plain versions of the two
backward kernels against the Pallas kernels in interpret mode, gradients of
whole plans wrt B and wrt A's values against ``jax.grad`` on the same
format arrays (carried across by ``convert``), and the transposed-pattern
ELL backward.

Tolerances: rtol 2e-4 / atol 1e-4 between the two packages (f32 sums
taken in different orders), 2e-3 against SciPy's Aᵀ·co, 1e-6 where only
the backward differs and the forward must not.  ``torch.autograd.gradcheck``
needs float64 and the format is f32 by contract, so it is not used; the
JAX gradients and the analytic Aᵀ·co stand in for it.  The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.ops.ell_spmm import with_bwd_plan as j_with_bwd_plan
from flex_tpu.ops.window_spmm import _bwd_tables as j_bwd_tables
from flex_tpu.ops.window_spmm import _window_bwd_gA_raw, _window_bwd_gB_raw
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed
from flex_tpu.ops.window_spmm import with_training_bwd as j_with_training_bwd

from flex_tpu_torch.convert import (
    ell_plan_from_numpy, windowed_plan_from_numpy,
)
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.ops import window_spmm
from flex_tpu_torch.ops.ell_spmm import (
    prepare_ell, prepare_ell_transpose, with_bwd_plan,
)
from flex_tpu_torch.ops.window_spmm import (
    _bwd_tables, prepare_windowed, slot_ptr, window_bwd_gA,
    window_bwd_gA_plain, window_bwd_gB, window_bwd_gB_plain, window_select,
    with_training_bwd,
)
from flex_tpu_torch.reorder import reorder
from test_torch_ell import (
    GRAPHS, assert_same_ell, hub_graph_with_empty_rows, jax_ell_dict,
    jax_graph,
)
from test_torch_windowed import CASES, jax_windowed_dict

TOL = dict(rtol=2e-4, atol=1e-4)


def _grad_graph():
    return community_graph(2000, 150_000, n_comm=4, seed=9, shuffle=False)


GRAD_KW = dict(tm=256, W=128, J=8, min_count=8)
TABLE_CASES = {
    "community": (CASES["community"][0], dict(tm=256, W=128, J=4,
                                              min_count=32)),
    "variable_steps": CASES["variable_steps"],
    # no block reaches the count gate: no step, no window, no table
    "empty_selection": (_grad_graph, dict(tm=256, W=128, J=8,
                                          min_count=10**6)),
}


def _co(shape, seed=0):
    return np.random.default_rng(seed).random(shape, np.float32)


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TABLE_CASES))
def test_bwd_tables_equal_jax(name):
    make, kw = TABLE_CASES[name]
    sel = window_select(make(), **kw)
    args = (sel["win_step"], sel["out_panel"], sel["nblk"], sel["G"],
            sel["W"])
    mine, n_mine = _bwd_tables(*args)
    ref, n_ref = j_bwd_tables(*args)
    assert n_mine == n_ref
    if name == "empty_selection":
        assert mine is None and ref is None and sel["total_steps"] == 0
        return
    assert len(mine) == len(ref) == 6 and n_mine > 0
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32


@pytest.mark.parametrize("name", ["community", "variable_steps"])
def test_slot_ptr_partitions_the_sorted_slots(name):
    make, kw = TABLE_CASES[name]
    sel = window_select(make(), **kw)
    (slot_s, slot_g, _, rank, bfirst, rows), n_blk = _bwd_tables(
        sel["win_step"], sel["out_panel"], sel["nblk"], sel["G"], sel["W"])
    ptr = slot_ptr(bfirst)
    assert ptr.dtype == np.int32 and len(ptr) == n_blk + 1
    assert ptr[0] == 0 and ptr[-1] == len(rank) and (np.diff(ptr) > 0).all()
    np.testing.assert_array_equal(np.repeat(np.arange(n_blk), np.diff(ptr)),
                                  rank)
    blk = sel["win_step"][slot_s.astype(np.int64) * sel["G"] + slot_g]
    np.testing.assert_array_equal(blk[ptr[:-1]] * sel["W"],
                                  rows.reshape(n_blk, -1)[:, 0])


def test_prepare_windowed_carries_the_tables():
    make, kw = TABLE_CASES["variable_steps"]
    g = make()
    sel = window_select(g, **kw)
    plan = prepare_windowed(g, device="cpu", sel=sel, **kw)
    ref, n_ref = j_bwd_tables(sel["win_step"], sel["out_panel"], sel["nblk"],
                              sel["G"], sel["W"])
    assert plan.n_blk_used == n_ref
    # the device holds slot_s, slot_g and rows; the rest stays on the host
    assert len(plan.bwd_tabs) == 3
    for t, r in zip(plan.bwd_tabs, (ref[0], ref[1], ref[5])):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), r)
    np.testing.assert_array_equal(plan.slot_ptr.numpy(), slot_ptr(ref[4]))
    # a repeated prepare reuses the cached device tables
    again = prepare_windowed(g, device="cpu", sel=sel, **kw)
    assert again.bwd_tabs[0] is plan.bwd_tabs[0]
    empty = prepare_windowed(_grad_graph(), device="cpu", tm=256, W=128,
                             J=8, min_count=10**6, min_coverage=0.0)
    assert empty.bwd_tabs is None and empty.n_blk_used == 0 \
        and empty.slot_ptr is None


# ---------------------------------------------------------------------------
# the two backward products: plain versions against Pallas in interpret mode
# ---------------------------------------------------------------------------

def _jax_plan_and_inputs(k):
    g = reorder(community_graph(3000, 300_000, n_comm=8, seed=5), "rbdeg")
    jplan = j_prepare_windowed(jax_graph(g), tm=256, W=128, J=6,
                               min_count=32)  # 6 windows: 2 sentinel pads
    B = make_features(g, k)
    co = _co((jplan.n_used_panels * jplan.tm, k))
    nblk = -(-g.n // jplan.W)
    B_pad = jnp.zeros(((nblk + 1) * jplan.W, k), jnp.float32).at[:g.n].set(B)
    return g, jplan, B, co, B_pad


@pytest.mark.parametrize("k", [8, 41, 128])
def test_gA_plain_matches_pallas_interpret(k):
    g, jp, B, co, B_pad = _jax_plan_and_inputs(k)
    S, TM, GW = jp.A.shape
    ref = np.asarray(_window_bwd_gA_raw(
        jp.first, jp.out_panel, jp.win_step, jnp.asarray(co), B_pad, S=S,
        TM=TM, GW=GW, W=jp.W, k=k, n_panels=jp.n_used_panels,
        precision=jax.lax.Precision.HIGHEST, interpret=True))
    t = windowed_plan_from_numpy(jax_windowed_dict(jp), "cpu")
    args = (t.out_panel, t.win_step, torch.from_numpy(co),
            torch.from_numpy(B))
    out = window_bwd_gA_plain(*args, TM=TM, W=t.W)
    assert tuple(out.shape) == (S, TM, GW)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # sentinel windows get zeros; the wrapper takes the plain version on CPU
    sent = (t.win_step == -(-g.n // t.W)).view(S, -1)
    assert bool(sent.any())
    assert not bool(out.view(S, TM, -1, t.W)[sent.nonzero(as_tuple=True)[0],
                                              :, sent.nonzero(as_tuple=True)[1]
                                              ].any())
    torch.testing.assert_close(window_bwd_gA(*args, TM=TM, W=t.W), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("k", [8, 41, 128])
def test_gB_plain_matches_pallas_interpret(k):
    g, jp, B, co, _ = _jax_plan_and_inputs(k)
    S, TM, GW = jp.A.shape
    slot_s, slot_g, panel_of, rank, bfirst, rows = jp.bwd_tabs
    ref = np.asarray(_window_bwd_gB_raw(
        slot_s, slot_g, panel_of, rank, bfirst, jp.A, jnp.asarray(co),
        TM=TM, W=jp.W, k=k, n_panels=jp.n_used_panels,
        n_blk_used=jp.n_blk_used, precision=jax.lax.Precision.HIGHEST,
        interpret=True))
    t = windowed_plan_from_numpy(jax_windowed_dict(jp), "cpu")
    assert t.n_blk_used == jp.n_blk_used
    for mine, theirs in zip(t.bwd_tabs, (slot_s, slot_g, rows)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(t.slot_ptr.numpy(),
                                  slot_ptr(np.asarray(bfirst)))
    ts, tg, _ = t.bwd_tabs
    out = window_bwd_gB_plain(ts, tg, t.slot_ptr, t.out_panel, t.A,
                              torch.from_numpy(co), W=t.W,
                              n_blk_used=t.n_blk_used)
    assert tuple(out.shape) == (t.n_blk_used * t.W, k)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    via = window_bwd_gB(ts, tg, t.slot_ptr, t.out_panel, t.A,
                        torch.from_numpy(co), W=t.W,
                        n_blk_used=t.n_blk_used)
    torch.testing.assert_close(via, out, rtol=0, atol=0)


def test_bwd_wrappers_reject_bad_arguments():
    plan = prepare_windowed(_grad_graph(), device="cpu", **GRAD_KW)
    TM, W = plan.tm, plan.W
    g = torch.ones((plan.n_used_panels * TM, 4))
    B = torch.ones((plan.n, 4))
    window_bwd_gA(plan.out_panel, plan.win_step, g, B, TM=TM, W=W)
    for bad in (dict(g=g.double()), dict(B=B[:, :3]),
                dict(out_panel=plan.out_panel.long()),
                dict(win_step=plan.win_step[:-1])):
        kw = dict(out_panel=plan.out_panel, win_step=plan.win_step, g=g, B=B)
        kw.update(bad)
        with pytest.raises(ValueError):
            window_bwd_gA(kw["out_panel"], kw["win_step"], kw["g"], kw["B"],
                          TM=TM, W=W)
    slot_s, slot_g, _ = plan.bwd_tabs
    good = dict(slot_s=slot_s, slot_g=slot_g,
                slot_ptr=plan.slot_ptr, out_panel=plan.out_panel, A=plan.A,
                g=g)
    window_bwd_gB(*good.values(), W=W, n_blk_used=plan.n_blk_used)
    for key, bad in (("slot_g", slot_g[:-1]), ("slot_ptr", plan.slot_ptr.long()),
                     ("g", g.double()), ("A", plan.A[0])):
        with pytest.raises(ValueError):
            window_bwd_gB(*dict(good, **{key: bad}).values(), W=W,
                          n_blk_used=plan.n_blk_used)
    with pytest.raises(ValueError):
        window_bwd_gB(*good.values(), W=96, n_blk_used=plan.n_blk_used)


# ---------------------------------------------------------------------------
# gradients of whole plans
# ---------------------------------------------------------------------------

def _port_grads(plan, B, co, wrt_A=True):
    Bt = torch.from_numpy(B).requires_grad_()
    A = plan.A.detach().clone().requires_grad_(wrt_A)
    (dataclasses.replace(plan, A=A)(Bt) * torch.from_numpy(co)).sum().backward()
    return Bt.grad.numpy(), None if A.grad is None else A.grad.numpy()


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("tables", [True, False], ids=["tables", "fallback"])
def test_windowed_grads_match_jax(tables, k):
    """d/dB and d/dA of (plan(B)·co).sum(): the port on the CPU against
    jax.grad on the JAX plan (Pallas backward kernels in interpret mode
    with tables, the step-wise formulation without), and g_B against
    SciPy's Aᵀ·co.  A port plan stripped of its tables derives them again
    in the backward, so its g_B still goes through ``window_bwd_gB``."""
    g = _grad_graph()
    B, co = make_features(g, k), _co((g.m, k))
    jplan = j_prepare_windowed(jax_graph(g), **GRAD_KW)
    assert jplan.bwd_tabs is not None and jplan.ell.nnz > 0
    if not tables:
        jplan = dataclasses.replace(jplan, bwd_tabs=None, n_blk_used=0)
    gA_ref, gB_ref = jax.grad(
        lambda A, b: (dataclasses.replace(jplan, A=A)(b) * co).sum(),
        argnums=(0, 1))(jplan.A, jnp.asarray(B))
    plan = windowed_plan_from_numpy(jax_windowed_dict(jplan), "cpu")
    assert plan.bwd_tabs is not None and plan.n_blk_used == 16
    if not tables:
        plan = dataclasses.replace(plan, bwd_tabs=None, n_blk_used=0,
                                   slot_ptr=None)
    gB, gA = _port_grads(plan, B, co)
    np.testing.assert_allclose(gB, np.asarray(gB_ref), **TOL)
    np.testing.assert_allclose(gA, np.asarray(gA_ref), **TOL)
    np.testing.assert_allclose(gB, g.to_scipy().T @ co, rtol=2e-3, atol=2e-3)


def test_windowed_grad_of_own_build_and_n_not_multiple_of_W():
    """The port's own prepare (tables from its selection), on a graph whose
    last column block is partial and selected: rows ≥ n of that block are
    computed and dropped."""
    from flex_tpu_torch.sparse.csr import CSRGraph

    rng = np.random.default_rng(4)
    m = 300
    key = np.unique(np.repeat(np.arange(m), 40) * m
                    + rng.integers(0, m, m * 40))
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    g = CSRGraph.from_coo(key // m, key % m, vals, m, name="partial_block")
    B, co = make_features(g, 8), _co((g.m, 8))
    plan = prepare_windowed(g, device="cpu", tm=256, W=128, J=8, min_count=8)
    assert int(plan.bwd_tabs[2].max()) == 3 * 128 - 1 >= g.n
    gB, _ = _port_grads(plan, B, co)
    assert gB.shape == (g.n, 8)
    np.testing.assert_allclose(gB, g.to_scipy().T @ co, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("needs", ["A", "B", "both"])
def test_backward_runs_only_the_gradients_asked_for(monkeypatch, needs):
    calls = []
    for name in ("window_bwd_gA", "window_bwd_gB"):
        fn = getattr(window_spmm, name)
        monkeypatch.setattr(
            window_spmm, name,
            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    plan = prepare_windowed(_grad_graph(), device="cpu", **GRAD_KW)
    A = plan.A.clone().requires_grad_(needs != "B")
    B = torch.ones((plan.n, 4), requires_grad=needs != "A")
    dataclasses.replace(plan, A=A).dense_half(B).sum().backward()
    want = {"A": ["window_bwd_gA"], "B": ["window_bwd_gB"],
            "both": ["window_bwd_gA", "window_bwd_gB"]}[needs]
    assert calls == want
    assert (A.grad is None) == (needs == "B")
    assert (B.grad is None) == (needs == "A")


# ---------------------------------------------------------------------------
# residue: transposed-pattern ELL backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_prepare_ell_transpose_tables_match_jax(name):
    """Same transposed buckets as the JAX package, pad entries counted into
    transposed row 0's degree included."""
    g = GRAPHS[name]()
    jplan = j_prepare_ell(jax_graph(g))
    ref = j_with_bwd_plan(jplan, g.n).bwd_plan
    port = prepare_ell_transpose(prepare_ell(g, device="cpu"), g.n)
    assert_same_ell(port, jax_ell_dict(ref))
    assert port.m == g.n and port.nnz == jplan.padded_nnz > g.nnz
    # a difference by design: the port's with_bwd_plan drops the pad
    # entries (measured faster on the card; the same g_B), so its tables
    # are prepare_ell_transpose's without them, not the JAX package's
    dropped = with_bwd_plan(prepare_ell(g, device="cpu"), g.n).bwd_plan
    assert dropped.nnz == g.nnz < ref.nnz
    assert_same_ell(dropped, jax_ell_dict(
        prepare_ell_transpose(prepare_ell(g, device="cpu"), g.n,
                              keep_pads=False)))


def test_prepare_ell_transpose_of_empty_plan():
    from flex_tpu_torch.sparse.csr import CSRGraph

    g = CSRGraph.from_arrays(np.zeros(5, np.int64), [], [])
    t = with_bwd_plan(prepare_ell(g, device="cpu"), 7)
    assert t.bwd_plan.buckets == () and t.bwd_plan.m == 7
    B = torch.ones((7, 3), requires_grad=True)
    t(B).sum().backward()
    assert torch.count_nonzero(B.grad) == 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_with_bwd_plan_parity(name):
    """with_bwd_plan: same forward (1e-6); g_B equal to autograd through the
    plain plan, to the JAX custom VJP, and to the analytic Aᵀ·co."""
    g = GRAPHS[name]()
    B, co = make_features(g, 16), _co((g.m, 16))
    plan = prepare_ell(g, device="cpu")
    tplan = with_bwd_plan(plan, g.n)
    assert tplan.bwd_plan is not None and plan.bwd_plan is None
    grads = []
    for p in (plan, tplan):
        Bt = torch.from_numpy(B).requires_grad_()
        out = p(Bt)
        (out * torch.from_numpy(co)).sum().backward()
        grads.append((out.detach(), Bt.grad))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[1][1], grads[0][1], **TOL)
    jt = j_with_bwd_plan(j_prepare_ell(jax_graph(g)), g.n)
    g_jax = jax.grad(lambda b: (jt(b) * co).sum())(jnp.asarray(B))
    np.testing.assert_allclose(grads[1][1].numpy(), np.asarray(g_jax), **TOL)
    np.testing.assert_allclose(grads[1][1].numpy(), g.to_scipy().T @ co,
                               rtol=2e-3, atol=2e-3)


def test_ell_bwd_plan_into_accumulator():
    """The hybrid's ``into=`` path: the accumulator is updated in place
    inside the autograd function (marked dirty), and g flows both to it
    and to B."""
    g = hub_graph_with_empty_rows()
    tplan = with_bwd_plan(prepare_ell(g, device="cpu"), g.n)
    B = torch.from_numpy(make_features(g, 8)).requires_grad_()
    base = torch.full((g.m, 8), 0.5, requires_grad=True)
    co = torch.from_numpy(_co((g.m, 8)))
    acc = base * 2                      # a non-leaf, as the dense half is
    out = tplan(B, into=acc)
    assert out.data_ptr() == acc.data_ptr()
    (out * co).sum().backward()
    torch.testing.assert_close(base.grad, 2 * co)
    np.testing.assert_allclose(B.grad.numpy(), g.to_scipy().T @ co.numpy(),
                               rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(
        out.detach(), prepare_ell(g, device="cpu")(B.detach()) + 1.0,
        rtol=1e-6, atol=1e-6)


def test_ell_convert_carries_bwd_plan():
    g = hub_graph_with_empty_rows()
    jt = j_with_bwd_plan(j_prepare_ell(jax_graph(g)), g.n)
    d = jax_ell_dict(jt)
    d["bwd_plan"] = jax_ell_dict(jt.bwd_plan)
    plan = ell_plan_from_numpy(d, "cpu")
    assert_same_ell(plan.bwd_plan, d["bwd_plan"])
    B, co = make_features(g, 8), _co((g.m, 8))
    Bt = torch.from_numpy(B).requires_grad_()
    (plan(Bt) * torch.from_numpy(co)).sum().backward()
    g_jax = jax.grad(lambda b: (jt(b) * co).sum())(jnp.asarray(B))
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(g_jax), **TOL)


@pytest.mark.parametrize("k", [16, 128])
def test_windowed_training_bwd_parity(k):
    """with_training_bwd swaps the residue's autograd scatter for the
    transposed-pattern plan: same forward, same g_B (non-empty residue, so
    the in-place add runs inside the autograd function), no gradient
    through the residue's values."""
    g = _grad_graph()
    B, co = make_features(g, k), _co((g.m, k))
    plan = prepare_windowed(g, device="cpu", **GRAD_KW)
    tplan = with_training_bwd(plan)
    assert plan.ell.nnz > 0 and tplan.ell.bwd_plan is not None
    assert tplan.A is plan.A and tplan.bwd_tabs is plan.bwd_tabs
    Bt = torch.from_numpy(B)
    torch.testing.assert_close(tplan(Bt), plan(Bt), rtol=1e-6, atol=1e-6)
    g_auto, gA_auto = _port_grads(plan, B, co)
    g_cv, gA_cv = _port_grads(tplan, B, co)
    np.testing.assert_allclose(g_cv, g_auto, **TOL)
    np.testing.assert_allclose(gA_cv, gA_auto, rtol=0, atol=0)
    np.testing.assert_allclose(g_cv, g.to_scipy().T @ co, rtol=2e-3,
                               atol=2e-3)
    jt = j_with_training_bwd(j_prepare_windowed(jax_graph(g), **GRAD_KW))
    g_jax = jax.grad(lambda b: (jt(b) * co).sum())(jnp.asarray(B))
    np.testing.assert_allclose(g_cv, np.asarray(g_jax), **TOL)


def test_with_training_bwd_leaves_an_empty_residue_alone():
    make, kw = CASES["full_coverage"]
    plan = prepare_windowed(make(), device="cpu", **kw)
    assert plan.ell.nnz == 0
    assert with_training_bwd(plan) is plan
