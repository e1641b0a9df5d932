"""Card-only tests of the PyTorch port: the hand CUDA kernels (windowed
forward, g_A, g_B, transposed forward, the two band kernels, the row-unit
kernel of GE-SpMM, the ELL residue, the dynamic-value SpMM and its
edge-dot kernel (g_vals, with a GAT step at ``reddit-gat``'s widths), GAT's
edge-softmax kernel pair (against float64, and a GAT step with no host
sync), the panel
plan's hub rows, the probes' kernels 8-11 and kernel 12 with the E7 and
E8 mains) against their plain twins, the unit
kernels (g_A too) on the edges of their work units and the ranged band kernels on
empty, one-half and full ranges, whole plans on the card against SciPy,
repeat calls of whole plans and of g_B bit for bit, gradients against
SciPy's Aᵀ·co, and a few GCN train steps.  Every test is
marked ``cuda`` and skips without a card.  The file imports no JAX, so on
a machine with PyTorch alone it runs as
``python -m pytest --noconftest tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from flex_tpu_torch import (
    prepare_band, prepare_ell, prepare_gespmm, prepare_windowed, spmm,
)
from flex_tpu_torch.io import (
    banded_graph, community_graph, make_features, rmat_graph,
)
from flex_tpu_torch.ops.ell_spmm import (
    ell_spmm_plain, prepare_ell_transpose, with_bwd_plan,
)
from flex_tpu_torch.ops.gespmm import gespmm_rows, gespmm_rows_plain
from flex_tpu_torch.ops.pallas_band import (
    band_depth_ranges, band_spmm_v1, band_spmm_v1_plain, band_spmm_v2,
    band_spmm_v2_plain,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
    FWD_CHUNK_STEPS, GB_CHUNK_SLOTS, bwd_device_tables, device_units,
    window_bwd_gA, window_bwd_gA_plain, window_bwd_gB, window_bwd_gB_plain,
    window_spmm_fwd, window_spmm_fwd_plain, window_spmm_t_fwd,
    window_spmm_t_fwd_plain, with_training_bwd,
)
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check

pytestmark = pytest.mark.cuda
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _trailing_empty():
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(256), 40)
    key = np.unique(rows * 700 + rng.integers(0, 256, rows.shape))
    return CSRGraph.from_coo(key // 700, key % 700,
                             np.ones(len(key), np.float32), 700, name="tail")


def _dups():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 700, 8_000)
    cols = rng.integers(0, 700, 8_000)
    rows, cols = np.r_[rows, rows[:3000]], np.r_[cols, cols[:3000]]
    vals = (2 * rng.random(len(rows)) - 1).astype(np.float32)
    return CSRGraph.from_coo(rows, cols, vals, 700, name="dups")


CASES = {
    "community": (lambda: reorder(community_graph(3000, 300_000, n_comm=8,
                                                  seed=5), "rbdeg"),
                  dict(tm=256, W=128, J=4, min_count=32)),
    "trailing_empty": (_trailing_empty,
                       dict(tm=256, W=128, J=3, min_count=8)),
    "dups": (_dups, dict(tm=256, W=128, J=8, min_count=1, min_coverage=0.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_kernel_matches_plain(cuda, name):
    make, kw = CASES[name]
    plan = prepare_windowed(make(), device=cuda, **kw)
    B = torch.from_numpy(make_features(make(), 128)).to(cuda)
    before = window_spmm_fwd.launches
    out = plan.dense_half(B)
    assert window_spmm_fwd.launches == before + 1
    ref = window_spmm_fwd_plain(plan.first, plan.out_panel, plan.win_step,
                                plan.A, B, n_panels=plan.n_used_panels,
                                W=plan.W)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_window_kernel_random_tables(cuda):
    """Sentinels anywhere, n % W != 0, 1- and 40-step panels, trailing
    panels with no steps, k not a multiple of the 128-column tile:
    |kernel - plain| <= 2·L·eps32·(|A|·|B|), L = the panel's contraction
    length."""
    rng = np.random.default_rng(1)
    TM, G, W, n, k = 256, 4, 128, 3000 + 5, 136
    steps = np.array([1, 40, 3, 7])
    S, nblk = int(steps.sum()), -(-n // W)
    win = np.sort(rng.integers(0, nblk, (S, G)), axis=1)
    win[rng.random((S, G)) < 0.25] = nblk
    win[::5, -1] = nblk - 1
    ptr = np.r_[0, np.cumsum(steps), S, S].astype(np.int32)
    first = np.zeros(S, np.int32)
    first[ptr[:len(steps)]] = 1
    t = [torch.from_numpy(a).to(cuda) for a in (
        first, np.repeat(np.arange(len(steps)), steps).astype(np.int32),
        win.reshape(-1).astype(np.int32))]
    A = torch.rand((S, TM, G * W), device=cuda) * 2 - 1
    B = torch.rand((n, k), device=cuda) * 2 - 1
    kw = dict(n_panels=len(ptr) - 1, W=W)
    out = window_spmm_fwd(*t, A, B, panel_step_ptr=torch.from_numpy(ptr).to(
        cuda), **kw)
    ref = window_spmm_fwd_plain(*t, A, B, **kw)
    absprod = window_spmm_fwd_plain(*t, A.abs(), B.abs(), **kw)
    L = torch.from_numpy(np.diff(ptr) * G * W).to(cuda).double()
    tol = 2 * EPS32 * L.repeat_interleave(TM)[:, None] * absprod.double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())
    assert bool((out[len(steps) * TM:] == 0).all())  # trailing empty panels


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_windowed_plan_matches_scipy(cuda, name, k):
    make, kw = CASES[name]
    g = make()
    B = make_features(g, k)
    C = prepare_windowed(g, device=cuda, **kw)(
        torch.from_numpy(B).to(cuda)).cpu().numpy()
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def test_ell_plan_matches_scipy(cuda):
    g = CASES["community"][0]()
    B = make_features(g, 64)
    C = prepare_ell(g, device=cuda)(torch.from_numpy(B).to(cuda))
    assert res_check(spmm_scipy(g, B), C.cpu().numpy(), g.degrees).ok


def test_window_kernel_refuses_what_it_cannot_take(cuda):
    def tables(W, G=2, TM=256):
        t = [torch.tensor(a, dtype=torch.int32, device=cuda)
             for a in ([1], [0], [0] * G, [0, 1])]
        return t[:3], dict(n_panels=1, W=W, panel_step_ptr=t[3]), TM * G * W

    B = torch.ones((100, 8), device=cuda)
    t, kw, size = tables(W=40)
    with pytest.raises(ValueError, match="W % 16"):
        window_spmm_fwd(*t, torch.zeros(size, device=cuda).view(1, 256, 80),
                        B, **kw)
    t, kw, size = tables(W=128)
    A = torch.zeros(size + 1, device=cuda)[1:].view(1, 256, 256)
    with pytest.raises(ValueError, match="aligned"):
        window_spmm_fwd(*t, A, B, **kw)


@pytest.mark.parametrize("k", [41, 64, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_kernels_match_plain(cuda, name, k):
    """g_A and g_B kernels on a plan's own tables against their plain
    versions (f32 sums in another order: rtol=atol=1e-4)."""
    make, kw = CASES[name]
    plan = prepare_windowed(make(), device=cuda, **kw)
    g = torch.rand((plan.n_used_panels * plan.tm, k), device=cuda) * 2 - 1
    B = torch.rand((plan.n, k), device=cuda) * 2 - 1
    before = (window_bwd_gA.launches, window_bwd_gB.launches)
    gA = window_bwd_gA(plan.out_panel, plan.win_step, g, B, TM=plan.tm,
                       W=plan.W)
    slot_s, slot_g, _ = plan.bwd_tabs
    kw3 = dict(W=plan.W, n_blk_used=plan.n_blk_used)
    gB = window_bwd_gB(slot_s, slot_g, plan.slot_ptr, plan.out_panel, plan.A,
                       g, **kw3)
    assert (window_bwd_gA.launches, window_bwd_gB.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        gA, window_bwd_gA_plain(plan.out_panel, plan.win_step, g, B,
                                TM=plan.tm, W=plan.W), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        gB, window_bwd_gB_plain(slot_s, slot_g, plan.slot_ptr,
                                plan.out_panel, plan.A, g, **kw3),
        rtol=1e-4, atol=1e-4)
    sentinel = (plan.win_step == -(-plan.n // plan.W)).view(len(gA), -1)
    S, TM = gA.shape[:2]
    s_idx, j_idx = sentinel.nonzero(as_tuple=True)
    assert not bool(gA.view(S, TM, -1, plan.W)[s_idx, :, j_idx].any())


@pytest.mark.parametrize("training_bwd", [False, True])
def test_windowed_grad_matches_scipy_on_card(cuda, training_bwd):
    g = CASES["community"][0]()
    plan = prepare_windowed(g, device=cuda, **CASES["community"][1])
    assert plan.ell.nnz > 0
    if training_bwd:
        plan = with_training_bwd(plan)
    co = np.random.default_rng(0).random((g.m, 41), np.float32)
    B = torch.from_numpy(make_features(g, 41)).to(cuda).requires_grad_()
    (plan(B) * torch.from_numpy(co).to(cuda)).sum().backward()
    np.testing.assert_allclose(B.grad.cpu().numpy(), g.to_scipy().T @ co,
                               rtol=2e-3, atol=2e-3)


def test_plan_without_tables_still_launches_the_gB_kernel(cuda):
    """A plan stripped of its backward tables derives them again: on the
    card its g_B comes from the kernel, never from plain tensor ops."""
    import dataclasses

    g = CASES["community"][0]()
    plan = prepare_windowed(g, device=cuda, **CASES["community"][1])
    co = torch.rand((g.m, 41), device=cuda)
    grads = []
    for p in (plan, dataclasses.replace(plan, bwd_tabs=None, slot_ptr=None,
                                        n_blk_used=0)):
        B = torch.from_numpy(make_features(g, 41)).to(cuda).requires_grad_()
        n3 = window_bwd_gB.launches
        (p(B) * co).sum().backward()
        assert window_bwd_gB.launches == n3 + 1
        grads.append(B.grad)
    # without a bwd_plan the residue's g_B is a plain scatter-add, which
    # sums in an order of its own on each run
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


def test_gcn_trains_on_card(cuda):
    from flex_tpu_torch.models import GCN, make_train_step

    g = CASES["community"][0]()
    plan = prepare_windowed(g, device=cuda, **CASES["community"][1])
    rng = np.random.default_rng(0)
    X = torch.from_numpy(make_features(g, 32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 7, g.m)).to(cuda)
    model = GCN(32, 32, 7, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0)).to(cuda)
    step = make_train_step(model, plan,
                           torch.optim.Adam(model.parameters(), lr=1e-2))
    n3 = window_bwd_gB.launches
    losses = [float(step(X, y, torch.ones(g.m, device=cuda)))
              for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert window_bwd_gB.launches == n3 + 10


# ---------------------------------------------------------------------------
# the unit kernels (forward and g_B) on the edges of their work units
# ---------------------------------------------------------------------------

def _unit_edge_tables(cuda, TM, G, W, n, seed=3):
    """Random step tables whose panels have 1, one unit, one unit plus one
    and five units plus three steps (and trailing panels with none), whose
    block ids 0..3 lie in chains of the same four kinds of slots, with one
    all-sentinel step, sentinels elsewhere and the last, partial block."""
    rng = np.random.default_rng(seed)
    CS, CL = FWD_CHUNK_STEPS, GB_CHUNK_SLOTS
    steps = np.array([1, CS, CS + 1, 5 * CS + 3, 2])
    chains = (1, CL, CL + 1, 5 * CL + 3)
    S, nblk = int(steps.sum()), -(-n // W)
    win = rng.integers(len(chains), nblk, (S, G))
    win[::5, -1] = nblk - 1
    win[rng.random((S, G)) < 0.2] = nblk
    win[CS + 3] = nblk                            # an all-sentinel step
    free = np.setdiff1d(np.arange(S), [CS + 3])
    pos = rng.permutation(len(free) * G)[:sum(chains)]
    win[free[pos // G], pos % G] = np.repeat(np.arange(len(chains)), chains)
    ptr = np.r_[0, np.cumsum(steps), S, S].astype(np.int32)
    first = np.zeros(S, np.int32)
    first[ptr[:len(steps)]] = 1
    out_panel = np.repeat(np.arange(len(steps)), steps).astype(np.int32)
    win = win.reshape(-1).astype(np.int32)
    bwd = bwd_device_tables(win, out_panel, nblk, G, W, cuda)
    assert tuple(np.diff(bwd["slot_ptr"].cpu().numpy())[:4]) == chains
    t = {key: torch.from_numpy(a).to(cuda) for key, a in (
        ("first", first), ("out_panel", out_panel), ("win_step", win),
        ("ptr", ptr))}
    t["A"] = torch.rand((S, TM, G * W), device=cuda) * 2 - 1
    return t, len(ptr) - 1, bwd


@pytest.mark.parametrize("k", [1, 32, 41, 64, 128, 200])
@pytest.mark.parametrize("TM,G,W,n", [(256, 4, 128, 9000 + 5),
                                      (200, 2, 64, 3000 + 5)])
def test_unit_kernels_on_chunk_edges(cuda, TM, G, W, n, k):
    """Both unit kernels against plain (|diff| <= 2·L·eps32·(|a|·|b|), L the
    contraction length) with TM a multiple of the 128-row tile or not,
    n % W != 0, every column tile (k = 1, 32, 41, 64, 128, 200) and both copy
    widths (k % 4 == 0 or not); with the caller's unit tables and with
    derived ones; a second launch gives the same bits."""
    t, n_panels, bwd = _unit_edge_tables(cuda, TM, G, W, n)
    args = (t["first"], t["out_panel"], t["win_step"], t["A"])
    B = torch.rand((n, k), device=cuda) * 2 - 1
    kw = dict(n_panels=n_panels, W=W)
    units = device_units(t["ptr"].cpu().numpy(), FWD_CHUNK_STEPS, cuda)
    assert units[2] == 2 + 6 and units[1].shape[0] == 2
    out = window_spmm_fwd(*args, B, panel_step_ptr=t["ptr"], units=units, **kw)
    for again in (units, None):
        assert torch.equal(out, window_spmm_fwd(
            *args, B, panel_step_ptr=t["ptr"], units=again, **kw))
    ref = window_spmm_fwd_plain(*args, B, **kw)
    absprod = window_spmm_fwd_plain(*args[:3], t["A"].abs(), B.abs(), **kw)
    L = (t["ptr"][1:] - t["ptr"][:-1]).double() * G * W
    tol = 2 * EPS32 * L.repeat_interleave(TM)[:, None] * absprod.double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())
    assert bool((out[5 * TM:] == 0).all())        # trailing empty panels

    g = torch.rand((n_panels * TM, k), device=cuda) * 2 - 1
    slot_s, slot_g, _ = bwd["bwd_tabs"]
    gargs = (slot_s, slot_g, bwd["slot_ptr"], t["out_panel"], t["A"])
    kw3 = dict(W=W, n_blk_used=bwd["n_blk_used"])
    gB = window_bwd_gB(*gargs, g, units=bwd["slot_units"], **kw3)
    for again in (bwd["slot_units"], None):
        assert torch.equal(gB, window_bwd_gB(*gargs, g, units=again, **kw3))
    ref = window_bwd_gB_plain(*gargs, g, **kw3)
    absprod = window_bwd_gB_plain(*gargs[:4], t["A"].abs(), g.abs(), **kw3)
    L = (bwd["slot_ptr"][1:] - bwd["slot_ptr"][:-1]).double() * TM
    tol = 2 * EPS32 * L.repeat_interleave(W)[:, None] * absprod.double()
    assert bool(((gB.double() - ref.double()).abs() <= tol).all())


def test_unit_kernels_take_a_misaligned_B_and_refuse_the_rest(cuda):
    """B and g move by 4-byte copies when they are not 16-byte aligned; A
    must be aligned, and every operand contiguous."""
    TM, G, W, n, k = 256, 4, 128, 2000, 64
    t, n_panels, bwd = _unit_edge_tables(cuda, TM, G, W, n)
    args = (t["first"], t["out_panel"], t["win_step"])
    kw = dict(n_panels=n_panels, W=W, panel_step_ptr=t["ptr"])
    B = torch.rand(n * k + 1, device=cuda)[1:].view(n, k)
    assert B.data_ptr() % 16
    torch.testing.assert_close(
        window_spmm_fwd(*args, t["A"], B, **kw),
        window_spmm_fwd(*args, t["A"], B.clone(), **kw), rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        window_spmm_fwd(*args, t["A"],
                        torch.rand((k, n), device=cuda).t(), **kw)
    A_off = torch.zeros(t["A"].numel() + 1, device=cuda)[1:].view_as(t["A"])
    with pytest.raises(ValueError, match="aligned"):
        window_spmm_fwd(*args, A_off, B, **kw)
    slot_s, slot_g, _ = bwd["bwd_tabs"]
    gargs = (slot_s, slot_g, bwd["slot_ptr"], t["out_panel"])
    kw3 = dict(W=W, n_blk_used=bwd["n_blk_used"])
    g = torch.rand(n_panels * TM * k + 1, device=cuda)[1:].view(-1, k)
    torch.testing.assert_close(
        window_bwd_gB(*gargs, t["A"], g, **kw3),
        window_bwd_gB(*gargs, t["A"], g.clone(), **kw3), rtol=0, atol=0)
    with pytest.raises(ValueError, match="aligned"):
        window_bwd_gB(*gargs, A_off, g, **kw3)
    with pytest.raises(ValueError, match="contiguous"):
        window_bwd_gB(*gargs, t["A"],
                      torch.rand((k, n_panels * TM), device=cuda).t(), **kw3)
    with pytest.raises(ValueError, match="unit tables lie on"):
        window_bwd_gB(*gargs, t["A"], g.clone(), units=tuple(
            x.cpu() if torch.is_tensor(x) else x
            for x in bwd["slot_units"]), **kw3)


def _gA_tol(t, g, B, TM, W):
    """2·k·eps32·(|g|·|B|ᵀ): two length-k f32 sums in different orders."""
    absprod = window_bwd_gA_plain(t["out_panel"], t["win_step"], g.abs(),
                                  B.abs(), TM=TM, W=W)
    return 2 * B.shape[1] * EPS32 * absprod.double()


@pytest.mark.parametrize("k", [16, 41, 128, 200])
@pytest.mark.parametrize("TM,G,W,n", [(256, 4, 128, 9000 + 5),
                                      (128, 4, 128, 9000 + 5),
                                      (384, 4, 128, 9000 + 5),
                                      (200, 2, 64, 3000 + 5)])
def test_gA_kernel_on_unit_edges(cuda, TM, G, W, n, k):
    """g_A on the forward's units of panels of 1, 8, 9 and 43 steps with an
    all-sentinel step, against plain (|diff| <= 2·k·eps32·(|g|·|B|ᵀ));
    k = 200 walks the resident tile's depth in two chunks.  Sentinel tiles
    are exactly zero; a second launch, one-step units and derived units
    give the same bits."""
    t, n_panels, _ = _unit_edge_tables(cuda, TM, G, W, n)
    S = t["out_panel"].shape[0]
    g = torch.rand((n_panels * TM, k), device=cuda) * 2 - 1
    B = torch.rand((n, k), device=cuda) * 2 - 1
    args = (t["out_panel"], t["win_step"], g, B)
    units = device_units(t["ptr"].cpu().numpy(), FWD_CHUNK_STEPS, cuda)
    n3 = window_bwd_gA.launches
    gA = window_bwd_gA(*args, TM=TM, W=W, units=units)
    assert window_bwd_gA.launches == n3 + 1
    steps = device_units(np.arange(S + 1, dtype=np.int32), 1, cuda)
    for again in (units, steps, None):
        assert torch.equal(gA, window_bwd_gA(*args, TM=TM, W=W, units=again))
    ref = window_bwd_gA_plain(*args, TM=TM, W=W)
    assert bool(((gA.double() - ref.double()).abs()
                 <= _gA_tol(t, g, B, TM, W)).all())
    sent = (t["win_step"] == -(-n // W)).view(S, G)
    assert bool(sent[FWD_CHUNK_STEPS + 3].all())
    assert not bool(gA.view(S, TM, G, W).permute(0, 2, 1, 3)[sent].any())


def test_gA_kernel_takes_a_misaligned_g_and_refuses_the_rest(cuda):
    """At k = 41 g and B move by 4-byte copies, aligned or not: the same
    bits.  Operands must be contiguous, the unit tables on the card."""
    TM, G, W, n, k = 256, 4, 128, 2000, 41
    t, n_panels, _ = _unit_edge_tables(cuda, TM, G, W, n)
    units = device_units(t["ptr"].cpu().numpy(), FWD_CHUNK_STEPS, cuda)
    op, win = t["out_panel"], t["win_step"]
    g = torch.rand(n_panels * TM * k + 1, device=cuda)[1:].view(-1, k)
    B = torch.rand(n * k + 1, device=cuda)[1:].view(n, k)
    assert g.data_ptr() % 16 and B.data_ptr() % 16
    out = window_bwd_gA(op, win, g, B, TM=TM, W=W, units=units)
    assert torch.equal(out, window_bwd_gA(op, win, g.clone(), B.clone(),
                                          TM=TM, W=W, units=units))
    assert bool(((out.double() - window_bwd_gA_plain(
        op, win, g, B, TM=TM, W=W).double()).abs()
        <= _gA_tol(t, g, B, TM, W)).all())
    with pytest.raises(ValueError, match="contiguous"):
        window_bwd_gA(op, win, torch.rand((k, n_panels * TM),
                                          device=cuda).t(), B, TM=TM, W=W)
    with pytest.raises(ValueError, match="unit tables lie on"):
        window_bwd_gA(op, win, g, B, TM=TM, W=W, units=tuple(
            x.cpu() if torch.is_tensor(x) else x for x in units))
    with pytest.raises(ValueError):
        window_bwd_gA(op, win, g, B, TM=TM, W=W,
                      units=(units[0][:, :3], units[1], units[2]))


def test_gA_of_a_plan_is_the_backward_and_repeats_its_bits(cuda):
    """A.grad of a plan's gradient call is the kernel's g_A in the plan's
    units, bit for bit, on every call."""
    make, kw = CASES["community"]
    g = make()
    plan = prepare_windowed(g, device=cuda, **kw)
    co = torch.rand((g.m, 41), device=cuda)
    B = torch.from_numpy(make_features(g, 41)).to(cuda)
    grads = []
    for _ in range(2):
        A = plan.A.detach().clone().requires_grad_()
        (dataclasses.replace(plan, A=A)(B) * co).sum().backward()
        grads.append(A.grad)
    assert torch.equal(grads[0], grads[1])
    gd = torch.zeros((plan.n_used_panels * plan.tm + 1, 41), device=cuda)
    gd.index_add_(0, plan.row_gather[:plan.m], co)
    gA = window_bwd_gA(plan.out_panel, plan.win_step, gd[:-1].contiguous(),
                       B, TM=plan.tm, W=plan.W, units=plan.panel_units)
    torch.testing.assert_close(grads[0], gA, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the other strategies: transposed windowed, band, GE-SpMM, the baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [32, 41, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_t_kernel_matches_plain(cuda, name, k):
    """The transposed kernel on a plan's own tables against its plain
    version (f32 sums in another order: rtol=atol=1e-4), and the whole
    transposed plan against SciPy."""
    make, kw = CASES[name]
    g = make()
    plan = prepare_windowed(g, device=cuda, transposed=True, **kw)
    assert plan.transposed and plan.bwd_tabs is None
    B = make_features(g, k)
    B_dev = torch.from_numpy(B).to(cuda)
    B_T = B_dev.t().contiguous()
    before = window_spmm_t_fwd.launches
    args = (plan.first, plan.out_panel, plan.win_step, plan.A, B_T)
    out = window_spmm_t_fwd(*args, n_panels=plan.n_used_panels, W=plan.W,
                            panel_step_ptr=plan.panel_step_ptr)
    assert window_spmm_t_fwd.launches == before + 1
    ref = window_spmm_t_fwd_plain(*args, n_panels=plan.n_used_panels,
                                  W=plan.W)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    C = plan(B_dev)
    assert window_spmm_t_fwd.launches == before + 2
    assert res_check(spmm_scipy(g, B), C.cpu().numpy(), g.degrees).err_frac == 0


def _t_unit_tables(cuda, TM, G=4, W=128, n=9000 + 5, seed=7):
    """Panels of 1, 8, 9 and 17 steps and two trailing panels with none;
    panel 0's only step and one step inside each longer panel all
    sentinels, sentinels elsewhere, the last, partial block of B."""
    rng = np.random.default_rng(seed)
    CS = FWD_CHUNK_STEPS
    steps = np.array([1, CS, CS + 1, 2 * CS + 1])
    S, nblk = int(steps.sum()), -(-n // W)
    win = np.sort(rng.integers(0, nblk, (S, G)), axis=1)
    win[::5, -1] = nblk - 1
    win[rng.random((S, G)) < 0.2] = nblk
    win[[0, 3, 12, 30]] = nblk
    ptr = np.r_[0, np.cumsum(steps), S, S].astype(np.int32)
    first = np.zeros(S, np.int32)
    first[ptr[:len(steps)]] = 1
    t = {key: torch.from_numpy(a).to(cuda) for key, a in (
        ("first", first),
        ("out_panel", np.repeat(np.arange(len(steps)), steps).astype(
            np.int32)),
        ("win_step", win.reshape(-1).astype(np.int32)), ("ptr", ptr))}
    t["A_T"] = torch.rand((S, G * W, TM), device=cuda) * 2 - 1
    return t, len(ptr) - 1, W


@pytest.mark.parametrize("k", [16, 32, 41, 64, 100])
@pytest.mark.parametrize("TM", [256, 128])
def test_window_t_kernel_on_unit_edges(cuda, TM, k):
    """The transposed unit kernel against plain (|diff| <= 2·L·eps32·
    (|b|·|a|), L the panel's contraction length) with both panel-row tiles
    (TM 256 and 128), every tile over k, a Bᵀ that is not 16-byte
    aligned, split panels whose partial tiles go through the strided
    reduce pass; with the caller's unit tables and with derived ones, a
    second launch gives the same bits."""
    t, n_panels, W = _t_unit_tables(cuda, TM)
    n = 9000 + 5
    buf = torch.rand(k * n + 1, device=cuda) * 2 - 1
    B_T = buf[1:].view(k, n)
    assert B_T.data_ptr() % 16
    args = (t["first"], t["out_panel"], t["win_step"], t["A_T"])
    kw = dict(n_panels=n_panels, W=W)
    units = device_units(t["ptr"].cpu().numpy(), FWD_CHUNK_STEPS, cuda)
    assert units[2] == 2 + 3 and units[1].shape[0] == 2
    before = window_spmm_t_fwd.launches
    out = window_spmm_t_fwd(*args, B_T, panel_step_ptr=t["ptr"], units=units,
                            **kw)
    assert window_spmm_t_fwd.launches == before + 1
    for again in (units, None):
        assert torch.equal(out, window_spmm_t_fwd(
            *args, B_T, panel_step_ptr=t["ptr"], units=again, **kw))
    assert torch.equal(out, window_spmm_t_fwd(
        *args, B_T.clone(), panel_step_ptr=t["ptr"], units=units, **kw))
    ref = window_spmm_t_fwd_plain(*args, B_T, **kw)
    absprod = window_spmm_t_fwd_plain(*args[:3], t["A_T"].abs(), B_T.abs(),
                                      **kw)
    L = (t["ptr"][1:] - t["ptr"][:-1]).double() * t["A_T"].shape[1]
    tol = 2 * EPS32 * L.repeat_interleave(TM)[None, :] * absprod.double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())
    assert bool((out[:, 4 * TM:] == 0).all())      # trailing empty panels
    assert bool((out[:, :TM] == 0).all())          # an all-sentinel panel


def test_transposed_plan_without_units_still_launches_its_kernel(cuda):
    """A transposed plan stripped of its unit tables derives them at each
    call: on the card its forward still comes from the kernel, with the
    same bits."""
    import dataclasses

    g = CASES["community"][0]()
    plan = prepare_windowed(g, device=cuda, transposed=True,
                            **CASES["community"][1])
    B = torch.from_numpy(make_features(g, 41)).to(cuda)
    outs = []
    for p in (plan, dataclasses.replace(plan, panel_units=None)):
        before = window_spmm_t_fwd.launches
        outs.append(p.dense_half(B))
        assert window_spmm_t_fwd.launches == before + 1
    assert torch.equal(outs[0], outs[1])


def test_transposed_grad_matches_scipy_on_card(cuda):
    g = CASES["community"][0]()
    plan = prepare_windowed(g, device=cuda, transposed=True,
                            **CASES["community"][1])
    co = np.random.default_rng(0).random((g.m, 41), np.float32)
    B = torch.from_numpy(make_features(g, 41)).to(cuda).requires_grad_()
    before = (window_spmm_t_fwd.launches, window_bwd_gB.launches)
    (plan(B) * torch.from_numpy(co).to(cuda)).sum().backward()
    # forward by the kernel, backward in plain tensor ops
    assert (window_spmm_t_fwd.launches, window_bwd_gB.launches) == (
        before[0] + 1, before[1])
    np.testing.assert_allclose(B.grad.cpu().numpy(), g.to_scipy().T @ co,
                               rtol=2e-3, atol=2e-3)


def test_window_t_kernel_refuses_what_it_cannot_take(cuda):
    t = [torch.tensor(a, dtype=torch.int32, device=cuda)
         for a in ([1], [0], [0, 0], [0, 1])]
    kw = dict(n_panels=1, W=128, panel_step_ptr=t[3])
    B_T = torch.ones((8, 300), device=cuda)
    with pytest.raises(ValueError, match="TM % 4"):
        window_spmm_t_fwd(*t[:3], torch.zeros((1, 256, 6), device=cuda), B_T,
                          **kw)
    A_T = torch.zeros(256 * 8 + 1, device=cuda)[1:].view(1, 256, 8)
    with pytest.raises(ValueError, match="aligned"):
        window_spmm_t_fwd(*t[:3], A_T, B_T, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        window_spmm_t_fwd(*t[:3], torch.zeros((1, 256, 8), device=cuda),
                          torch.ones((300, 8), device=cuda).t(), **kw)


BAND_CASES = {
    "band5000": (lambda: banded_graph(5000, 300, 40.0, seed=3),
                 dict(tm=256)),                       # m % tm != 0
    "band600": (lambda: banded_graph(600, 64, 8.0, seed=7),
                dict(tm=256, min_density=0.005)),
    "tm8": (lambda: banded_graph(300, 40, 6.0, seed=2),
            dict(tm=8, min_density=0.0)),
}


@pytest.mark.parametrize("k", [41, 128])
@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_band_kernels_match_plain_and_scipy(cuda, name, k):
    make, kw = BAND_CASES[name]
    g = make()
    B = make_features(g, k)
    B_dev = torch.from_numpy(B).to(cuda)
    gold = spmm_scipy(g, B)
    p2 = prepare_band(g, device=cuda, **kw)
    p1 = prepare_band(g, device=cuda, impl="pallas", **kw)
    before = (band_spmm_v2.launches, band_spmm_v1.launches)
    out2 = band_spmm_v2(*p2.band, p2.ws, B_dev)
    out1 = band_spmm_v1(p1.band, p1.ws, B_dev)
    assert (band_spmm_v2.launches, band_spmm_v1.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out2, band_spmm_v2_plain(*p2.band, p2.ws,
                                                        B_dev),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out1, band_spmm_v1_plain(p1.band, p1.ws,
                                                        B_dev),
                               rtol=1e-5, atol=1e-5)
    for plan in (p2, p1, prepare_band(g, device=cuda, impl="xla", **kw)):
        C = plan(B_dev).cpu().numpy()
        assert res_check(gold, C, g.degrees).err_frac == 0, plan.impl


def _band_range_case(cuda, P, TM, W, n, k, seed=6):
    """Random split halves whose 128-row tiles have an empty range (tile 0
    of panel 0), the left half only (panel 1, tile 0), the right half
    only (panel 1, tile 1), a narrow range inside the right half (panel 2)
    and the full depth (the rest); windows anywhere in B, every third past
    n."""
    rng = np.random.default_rng(seed)
    a = [torch.rand((P, TM, W), device=cuda) * 2 - 1 for _ in range(2)]
    a[0][0, :128] = 0
    a[1][0, :128] = 0
    a[1][1, :128] = 0
    a[0][1, 128:] = 0
    a[0][2] = 0
    a[1][2, :, 40:] = 0
    a[1][2, :, :8] = 0
    iW = rng.integers(0, -(-n // W), P)
    iW[::3] = -(-n // W) - 1
    B = torch.rand((n, k), device=cuda) * 2 - 1
    return a, torch.from_numpy(iW.astype(np.int32)).to(cuda), B


@pytest.mark.parametrize("k", [32, 41, 128, 200])
@pytest.mark.parametrize("TM,W", [(256, 768), (200, 256)])
def test_band_v2_kernel_on_depth_ranges(cuda, TM, W, k):
    """The ranged kernel against plain (|diff| <= 2·2W·eps32·(|a|·|b|)) on
    empty, one-half, narrow and full-depth ranges, every column tile and
    both copy widths; launched again, with the table derived, and on a
    table of full-depth ranges: the same bits (a skipped column is a zero
    of A, whose FMAs add exact zeros)."""
    a, iW, B = _band_range_case(cuda, 5, TM, W, 9000 + 5, k)
    ranges = band_depth_ranges(*a)
    r = ranges.cpu().numpy()
    assert tuple(r[0, 0]) == (0, 0) and r[1, 0, 1] <= W and r[1, 1, 0] >= W
    assert tuple(r[2, 0]) == (W + 0, W + 48) and tuple(r[3, 0]) == (0, 2 * W)
    before = band_spmm_v2.launches
    out = band_spmm_v2(*a, iW, B, ranges=ranges)
    assert band_spmm_v2.launches == before + 1
    full = ranges.clone()
    full[..., 0], full[..., 1] = 0, 2 * W
    for again in (ranges, None, full):
        assert torch.equal(out, band_spmm_v2(*a, iW, B, ranges=again))
    assert bool((out[:128] == 0).all())             # the empty tile
    ref = band_spmm_v2_plain(*a, iW, B)
    tol = 2 * 2 * W * EPS32 * band_spmm_v2_plain(
        a[0].abs(), a[1].abs(), iW, B.abs()).double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())


@pytest.mark.parametrize("k", [32, 41, 128, 200])
def test_band_v1_kernel_is_unchanged(cuda, k):
    """Kernel 6, now on kernel 5's ranged ring: against plain on windows
    anywhere in B, every third past n, TM not a multiple of 128, tiles
    with an empty, a narrow and the full range; two launches, the table
    derived and a table of full-depth ranges give the same bits."""
    rng = np.random.default_rng(k)
    P, TM, W, n = 6, 200, 256, 5000 + 3
    band = torch.rand((P, TM, W), device=cuda) * 2 - 1
    band[0, :128] = 0                                   # an empty tile
    band[1, :, 40:] = 0
    band[1, :, :8] = 0                                  # a narrow range
    ws = rng.integers(0, -(-n // 128), P)
    ws[::3] = -(-n // 128) - 1
    ws = torch.from_numpy(ws.astype(np.int32)).to(cuda)
    B = torch.rand((n, k), device=cuda) * 2 - 1
    ranges = band_depth_ranges(band)
    r = ranges.cpu().numpy()
    assert tuple(r[0, 0]) == (0, 0) and tuple(r[1, 0]) == (0, 48)
    before = band_spmm_v1.launches
    out = band_spmm_v1(band, ws, B, ranges=ranges)
    assert band_spmm_v1.launches == before + 1
    full = ranges.clone()
    full[..., 0], full[..., 1] = 0, W
    for again in (ranges, None, full):
        assert torch.equal(out, band_spmm_v1(band, ws, B, ranges=again))
    assert bool((out[:128] == 0).all())
    ref = band_spmm_v1_plain(band, ws, B)
    tol = 2 * W * EPS32 * band_spmm_v1_plain(band.abs(), ws, B.abs()).double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())


def test_band_kernels_refuse_what_they_cannot_take(cuda):
    iW = torch.zeros(2, dtype=torch.int32, device=cuda)
    B = torch.ones((500, 8), device=cuda)
    narrow = torch.zeros((2, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="W % 128"):
        band_spmm_v2(narrow, narrow, iW, B)
    with pytest.raises(ValueError, match="W % 128"):
        band_spmm_v1(narrow, iW, B)
    off = torch.zeros(2 * 16 * 128 + 1, device=cuda)[1:].view(2, 16, 128)
    with pytest.raises(ValueError, match="aligned"):
        band_spmm_v1(off, iW, B)
    strided = torch.zeros((2, 16, 256), device=cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        band_spmm_v2(strided, strided, iW, B)
    with pytest.raises(ValueError, match="several devices"):
        band_spmm_v1(torch.zeros((2, 16, 128), device=cuda), iW, B.cpu())


def _hub_and_empty(w=32, m=3000):
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 3 * w, m)
    deg[:4] = (0, w, w + 1, 40 * w - 5)
    rows = np.repeat(np.arange(m), deg)
    vals = (2 * rng.random(len(rows)) - 1).astype(np.float32)
    return CSRGraph.from_coo(rows, rng.integers(0, m, len(rows)), vals, m,
                             name="hub_and_empty")


def _rows_tol(t, B, into=None):
    """2·L·eps32·(|A|·|B|) per row (L its length), plus |into|: the
    rounding bound of two f32 sums of a row in different orders."""
    absprod = gespmm_rows_plain(dataclasses.replace(t, vals=t.vals.abs()),
                                B.abs()).double()
    u = t.units.long()
    L = torch.zeros(t.m, dtype=torch.float64, device=B.device).index_add_(
        0, u[:, 0], (u[:, 2] - u[:, 1]).double())
    tol = 2 * L[:, None] * EPS32 * absprod + 1e-6
    return tol if into is None else tol + 2 * EPS32 * into.abs().double()


def _assert_rows_close(out, ref, tol):
    assert bool(((out.double() - ref.double()).abs() <= tol).all())


@pytest.mark.parametrize("k", [8, 41, 128, 200])
@pytest.mark.parametrize("w", [7, 32, 40])
def test_gespmm_kernel_matches_plain_and_scipy(cuda, w, k):
    """k a multiple of 4 or not, within one 128-column slice or beyond; w
    below, at and above a warp's 32 entries; pad chunks, empty rows and a
    row of 40 chunks (several units and the reduce pass); launched again,
    the same bits."""
    g = _hub_and_empty()
    plan = prepare_gespmm(g, w=w, device=cuda)
    assert plan.rows.splits.shape[0] > 0
    B = make_features(g, k)
    B_dev = torch.from_numpy(B).to(cuda)
    before = gespmm_rows.launches
    out = plan(B_dev)
    assert gespmm_rows.launches == before + 1
    assert torch.equal(out, plan(B_dev))
    _assert_rows_close(out, gespmm_rows_plain(plan.rows, B_dev),
                       _rows_tol(plan.rows, B_dev))
    C = out.cpu().numpy()
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0
    assert np.all(C[g.degrees == 0] == 0.0)


@pytest.mark.parametrize("k", [16, 41, 128])
def test_ell_residue_kernel_with_into_matches_plain(cuda, k):
    """The windowed plan's residue and its transposed plan, without its pad
    entries (``with_training_bwd``) and with them (row 0 holds all), and
    ``prepare_ell``'s plan, through the row-unit kernel, added into an
    accumulator in place, against the plain version; repeat calls give the
    same bits."""
    make, kw = CASES["community"]
    g = make()
    plan = with_training_bwd(prepare_windowed(g, device=cuda, **kw))
    for ell in (plan.ell, plan.ell.bwd_plan, prepare_ell(g, device=cuda),
                prepare_ell_transpose(plan.ell, g.n)):
        n = int(ell.rows.cols.max()) + 1
        B = torch.rand((n, k), device=cuda) * 2 - 1
        base = torch.rand((ell.m, k), device=cuda) * 2 - 1
        before = gespmm_rows.launches
        out = ell(B, into=base.clone())
        assert gespmm_rows.launches == before + 1
        assert torch.equal(out, ell(B, into=base.clone()))
        ref = ell_spmm_plain(ell, B, into=base.clone())
        _assert_rows_close(out, ref, _rows_tol(ell.rows, B, base))


@pytest.mark.parametrize("into", [False, True])
@pytest.mark.parametrize("k", [1, 7, 16, 41, 64])
def test_grouped_kernel_gives_the_warp_instances_bits(cuda, k, into):
    """At k <= 64 kernel 7 runs in lane groups (one launch, counted in
    ``grouped_launches`` beside ``launches``): on split rows and a
    zero-degree row, with and without ``into``, its output is bit for bit
    the first k columns of the one-unit-a-warp instance on B widened with
    zeros to 128 columns (that k = 128 call is not counted as grouped),
    on B as it is and misaligned, and it holds to the plain version."""
    g = _hub_and_empty()
    t = prepare_gespmm(g, device=cuda).rows
    assert t.splits.shape[0] > 0 and (g.degrees == 0).any()
    B = torch.rand((g.n, k), device=cuda) * 2 - 1
    wide = torch.zeros((g.n, 128), device=cuda)
    wide[:, :k] = B
    base = wide_base = None
    if into:
        base = torch.rand((g.m, k), device=cuda) * 2 - 1
        wide_base = torch.zeros((g.m, 128), device=cuda)
        wide_base[:, :k] = base
    before = (gespmm_rows.launches, gespmm_rows.grouped_launches)
    want = gespmm_rows(t, wide, into=wide_base)[:, :k]
    assert (gespmm_rows.launches, gespmm_rows.grouped_launches) == (
        before[0] + 1, before[1])
    out = gespmm_rows(t, B, into=None if base is None else base.clone())
    assert (gespmm_rows.launches, gespmm_rows.grouped_launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(out, want)
    mis = torch.empty(g.n * k + 1, device=cuda)[1:].view(g.n, k)
    mis.copy_(B)   # scalar loads at any k
    assert torch.equal(
        gespmm_rows(t, mis, into=None if base is None else base.clone()), want)
    ref = gespmm_rows_plain(t, B, into=None if base is None else base.clone())
    _assert_rows_close(out, ref, _rows_tol(t, B, base))
    if not into:
        assert np.all(out.cpu().numpy()[g.degrees == 0] == 0.0)


def test_repeat_calls_are_bit_equal(cuda):
    """A second call equals the first bit for bit: the GE-SpMM plan, the
    ELL plan with ``into=``, the windowed forward and its g_B through
    ``with_training_bwd`` (no atomics and no unordered sum on any of
    them)."""
    make, kw = CASES["community"]
    g = make()
    B = torch.from_numpy(make_features(g, 41)).to(cuda)
    ge = prepare_gespmm(g, device=cuda)
    assert torch.equal(ge(B), ge(B))
    ell = prepare_ell(g, device=cuda)
    base = torch.rand((g.m, 41), device=cuda)
    assert torch.equal(ell(B, into=base.clone()), ell(B, into=base.clone()))
    plan = with_training_bwd(prepare_windowed(g, device=cuda, **kw))
    assert torch.equal(plan(B), plan(B))
    co = torch.rand((g.m, 41), device=cuda)
    grads = []
    for _ in range(2):
        Bg = B.clone().requires_grad_()
        (plan(Bg) * co).sum().backward()
        grads.append(Bg.grad)
    assert torch.equal(grads[0], grads[1])


def test_residue_without_bwd_plan_gives_the_plain_gradient(cuda):
    """A residue on the card without a ``bwd_plan`` stays differentiable in
    B: its forward is the kernel, and so is its g_B, on the transposed plan
    that the first backward builds and keeps (``with_bwd_plan``'s, so its
    bits; a second backward builds none), summed in a fixed order: within
    1e-5 of the order-free float64 Aᵀ·co, where autograd through the plain
    version, an unordered sum on the card, is held within 1e-4;
    ``into``'s cotangent is g."""
    g = CASES["community"][0]()
    ell = prepare_ell(g, device=cuda)
    assert ell.bwd_plan is None
    co = torch.rand((g.m, 32), device=cuda)
    want = g.to_scipy().astype(np.float64).T @ co.cpu().double().numpy()
    B0 = torch.from_numpy(make_features(g, 32)).to(cuda)
    grads = []
    before = gespmm_rows.launches
    for fn in (ell, ell, lambda B, into: ell_spmm_plain(ell, B, into)):
        B = B0.clone().requires_grad_()
        base = torch.ones((g.m, 32), device=cuda, requires_grad=True)
        (fn(B, into=base.clone()) * co).sum().backward()
        grads.append((B.grad, base.grad))
    assert gespmm_rows.launches == before + 4
    kept = ell._kept_bwd
    assert ell.bwd_plan is None and kept is not None
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], co)
    np.testing.assert_allclose(grads[0][0].cpu().double().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[2][0].cpu().double().numpy(), want,
                               rtol=1e-4, atol=1e-4)
    # with a bwd_plan the same gradient comes from the same kernel
    tb = with_bwd_plan(ell, g.n)
    B = B0.clone().requires_grad_()
    before = gespmm_rows.launches
    (tb(B) * co).sum().backward()
    assert gespmm_rows.launches == before + 2
    assert torch.equal(B.grad, grads[0][0]) and ell._kept_bwd is kept


def test_gespmm_kernel_refuses_what_it_cannot_take(cuda):
    plan = prepare_gespmm(_hub_and_empty(), device=cuda)
    t = plan.rows
    B = torch.ones((plan.m, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gespmm_rows(t, torch.ones((8, plan.m), device=cuda).t())
    with pytest.raises(ValueError, match="several devices"):
        gespmm_rows(t, B.cpu())
    with pytest.raises(ValueError, match="int32"):   # when the table is made
        dataclasses.replace(t, cols=t.cols.long())
    with pytest.raises(ValueError, match="contiguous"):
        gespmm_rows(t, B, into=torch.ones((8, plan.m), device=cuda).t())
    off = torch.zeros(t.units.numel() + 1, dtype=torch.int32,
                      device=cuda)[1:].view(-1, 4)
    with pytest.raises(ValueError, match="aligned"):
        dataclasses.replace(t, units=off)
    with pytest.raises(ValueError, match="contiguous"):
        gespmm_rows(t, B, vals=torch.ones((2 * t.cols.shape[0],),
                                          device=cuda)[::2])


@pytest.mark.parametrize("method", ["xla", "bcoo", "ell", "gespmm", "panel"])
def test_spmm_methods_run_on_the_card_by_default(cuda, method):
    g = rmat_graph(2048, 32768, seed=3)
    B = make_features(g, 32)
    C = spmm(g, B, method=method)
    assert C.device.type == "cuda"
    assert res_check(spmm_scipy(g, B), C.cpu().numpy(), g.degrees).err_frac == 0


@pytest.mark.parametrize("k", [16, 41, 128])
def test_dyn_spmm_forward_and_gB_match_plain(cuda, k):
    """The dynamic-value SpMM on the row-unit kernel: the forward over the
    CSR and g_B over the transposed pattern against the kernel's plain
    version on the same tables, each launched once; g_vals against SciPy;
    a second forward gives the same bits."""
    from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell

    g = _hub_and_empty()
    plan = prepare_dyn_ell(g, device=cuda)
    rng = np.random.default_rng(k)
    vals = torch.from_numpy((2 * rng.random(g.nnz) - 1).astype(
        np.float32)).to(cuda).requires_grad_()
    B = torch.from_numpy(rng.standard_normal((g.n, k)).astype(
        np.float32)).to(cuda).requires_grad_()
    co = torch.rand((g.m, k), device=cuda) * 2 - 1
    before = gespmm_rows.launches
    out = plan(vals, B)
    assert gespmm_rows.launches == before + 1
    assert torch.equal(out, plan(vals, B))
    (out * co).sum().backward()
    assert gespmm_rows.launches == before + 3
    fwd = dataclasses.replace(plan.fwd, vals=vals.detach())
    bwd = dataclasses.replace(plan.bwd, vals=vals.detach()[plan.perm])
    _assert_rows_close(out, gespmm_rows_plain(fwd, B.detach()),
                       _rows_tol(fwd, B.detach()))
    _assert_rows_close(B.grad, gespmm_rows_plain(bwd, co), _rows_tol(bwd, co))
    rows = np.repeat(np.arange(g.m), g.degrees)
    want = (co.cpu().numpy()[rows] * B.detach().cpu().numpy()[g.col]).sum(1)
    np.testing.assert_allclose(vals.grad.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4)


def _dots_bound(g, gm, B):
    """float64 dot products of every CSR edge, and the f32 rounding bound
    of a k-term dot product summed in any order."""
    rows = np.repeat(np.arange(g.m), g.degrees)
    gr, Bc = gm.double()[rows], B.double()[g.col]
    k = max(B.shape[1], 1)
    return (gr * Bc).sum(1), 2 * k * EPS32 * (gr.abs() * Bc.abs()).sum(1) \
        + 1e-30


@pytest.mark.parametrize("k", [0, 1, 7, 16, 41, 64, 65, 128, 256, 257])
def test_edge_dots_kernel_matches_float64_dots(cuda, k):
    """g_vals on the edge-dot kernel: one launch (grouped at k <= 64, no
    plain call; none at k = 0, where every dot is 0), every edge's dot
    product within the f32 order bound of
    float64 dots, on split rows and zero-degree rows, at one pass and two
    (k = 257); a second launch gives the same bits; g and B as
    non-16-byte-aligned views take scalar loads and hold to the same
    bound (the same bits where k % 4 != 0, where both load by scalars)."""
    from flex_tpu_torch.ops.dyn_ell import edge_dots_rows, prepare_dyn_ell

    g = _hub_and_empty()
    plan = prepare_dyn_ell(g, device=cuda)
    assert plan.fwd.splits.shape[0] > 0 and (g.degrees == 0).any()
    gm = torch.rand((g.m, k), device=cuda) * 2 - 1
    B = torch.rand((g.n, k), device=cuda) * 2 - 1
    before = (edge_dots_rows.launches, edge_dots_rows.grouped_launches,
              edge_dots_rows.plain_calls)
    out = plan.edge_dots(gm, B)
    assert (edge_dots_rows.launches, edge_dots_rows.grouped_launches,
            edge_dots_rows.plain_calls) == (
        before[0] + (k > 0), before[1] + (0 < k <= 64), before[2])
    assert torch.equal(out, plan.edge_dots(gm, B))
    want, tol = _dots_bound(g, gm, B)
    assert bool(((out.double() - want).abs() <= tol).all())
    mg = torch.empty(g.m * k + 1, device=cuda)[1:].view(g.m, k)
    mB = torch.empty(g.n * k + 1, device=cuda)[1:].view(g.n, k)
    mg.copy_(gm)
    mB.copy_(B)
    mis = plan.edge_dots(mg, mB)
    assert bool(((mis.double() - want).abs() <= tol).all())
    if k % 4:
        assert torch.equal(mis, out)


def test_edge_dots_kernel_refuses_what_it_cannot_take(cuda):
    from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell

    g = _hub_and_empty()
    plan = prepare_dyn_ell(g, device=cuda)
    gm, B = torch.ones((g.m, 8), device=cuda), torch.ones((g.n, 8),
                                                          device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        plan.edge_dots(torch.ones((8, g.m), device=cuda).t(), B)
    with pytest.raises(ValueError, match="several devices"):
        plan.edge_dots(gm, B.cpu())
    off = torch.zeros(plan.fwd.units.numel() + 1, dtype=torch.int32,
                      device=cuda)[1:].view(-1, 4)
    with pytest.raises(ValueError, match="aligned"):   # when it is made
        dataclasses.replace(plan.fwd, units=off)


def test_gat_step_on_the_edge_dot_kernel_matches_the_plain_plan(cuda):
    """``reddit-gat``'s layers (4 × 256 concatenated, 4 × 256 with the
    skip, 6 × 41 averaged) on a small graph with self-loops: a step
    launches the edge-dot kernel once a head (8 at k = 256, 6 grouped at
    k = 41) and the edge-softmax kernels once a head each way, and takes
    no plain call; the first step's parameter gradients match those
    through the plain dynamic plan (all tensor ops: the plain scores and
    softmax, g_vals by autograd's gathers) within 1e-4 of each
    parameter's largest."""
    from flex_tpu_torch.models import GAT, gat_loss, prepare_attention
    from flex_tpu_torch.ops.dyn_ell import DynEllPlan, edge_dots_rows
    from flex_tpu_torch.ops.edge_softmax import (
        edge_attention_plain, edge_attention_rows, edge_attention_rows_bwd,
    )

    g = _with_self_loops(community_graph(2000, 40_000, n_comm=4, seed=2))
    ag = prepare_attention(g, device=cuda)

    class PlainDynPlan(DynEllPlan):
        def __call__(self, vals, B):
            return gespmm_rows_plain(dataclasses.replace(self.fwd, vals=vals),
                                     B)

        def edge_attention(self, s_src, s_dst, negative_slope=0.2):
            return edge_attention_plain(self, s_src, s_dst, negative_slope)

    plain = dataclasses.replace(ag, plan=PlainDynPlan(**{
        f.name: getattr(ag.plan, f.name)
        for f in dataclasses.fields(ag.plan)}))
    model = GAT(32, layers=[(4, 256, True), (4, 256, True), (6, 41, False)],
                skip=2, generator=torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((g.m, 32)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 41, g.m)).to(cuda)
    mask = torch.ones(g.m, device=cuda)
    counters = [(edge_dots_rows, "launches"),
                (edge_dots_rows, "grouped_launches"),
                (edge_dots_rows, "plain_calls"),
                (edge_attention_rows, "launches"),
                (edge_attention_rows, "plain_calls"),
                (edge_attention_rows_bwd, "launches"),
                (edge_attention_rows_bwd, "plain_calls")]
    grads = []
    for p in (ag, plain):
        before = [getattr(fn, c) for fn, c in counters]
        model.zero_grad(set_to_none=True)
        gat_loss(model, p, X, y, mask).backward()
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()})
        counts = tuple(getattr(fn, c) - b
                       for (fn, c), b in zip(counters, before))
        assert counts == ((14, 6, 0, 14, 0, 14, 0) if p is ag
                          else (0, 0, 0, 0, 0, 0, 0))
    for n, ref in grads[1].items():
        assert bool(grads[0][n].isfinite().all())
        assert float((grads[0][n] - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max()), n


def _with_self_loops(base):
    loops = np.arange(base.m)
    rows = np.r_[np.repeat(loops, base.degrees), loops]
    return CSRGraph.from_coo(rows, np.r_[base.col, loops],
                             np.ones(len(rows), np.float32), base.m,
                             name="loops")


def _attention_graph(m=3000):
    """Rows of 5000, 1000, 257, 256 and 255 edges, rows of one edge,
    empty rows and rows of up to 120 edges; columns 0 and 1 of about 3000
    and 300 edges (the kernels' warp takes up to 256, a block 2048 at
    once)."""
    rng = np.random.default_rng(5)
    deg = rng.integers(0, 121, m)
    deg[:5] = (5000, 1000, 257, 256, 255)
    deg[5:60] = 1
    deg[60:90] = 0
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(2, m, len(rows))
    cols[rng.choice(len(rows), 3300, replace=False)[:3000]] = 0
    cols[rng.choice(len(rows), 300, replace=False)] = 1
    return CSRGraph.from_coo(rows, cols, np.ones(len(rows), np.float32), m,
                             name="attention")


def _attention_case(cuda, g, seed):
    """s_src, s_dst (z of both signs) and a cotangent w on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = torch.randn((2, g.m), generator=gen, device=cuda) * 3
    w = torch.randn(g.nnz, generator=gen, device=cuda)
    return s[0].contiguous(), (s[1] - 0.5).contiguous(), w


def _attention_float64(plan, s_src, s_dst, w, slope):
    """alpha and the gradients of (alpha·w).sum() in s_src and s_dst in
    float64 (the plain composition and its formulas), and the f32 bounds
    of each, from the size of the scores and the rows' lengths L (the
    rounding of a sum of L terms grows as √L): alpha64·eps32·(2·|z|max +
    4·√L + 8) an edge, L its row's; eps32·(2·|z|max + 4·√Lmax +
    8)·Σ|terms| a gradient, the terms alpha·(|w| + |t|) of its row or
    column.  The plain version stays within a sixth of them on the CPU."""
    from flex_tpu_torch.ops.edge_softmax import (
        edge_attention_bwd_plain, edge_attention_plain,
    )

    a, b, w = s_src.double(), s_dst.double(), w.double()
    alpha = edge_attention_plain(plan, a, b, slope)
    d_src, d_dst = edge_attention_bwd_plain(plan, alpha, w, a, b, slope)
    z = a.index_select(0, plan.rows) + b.index_select(0, plan.cols.long())
    L = (plan.row_ptr[1:] - plan.row_ptr[:-1]).double()
    zmax = float(z.abs().max())
    t = alpha.new_zeros(plan.m).index_add_(0, plan.rows, alpha * w)
    terms = alpha * (w.abs() + t.abs().index_select(0, plan.rows))
    k = EPS32 * (2 * zmax + 4 * float(L.max()) ** 0.5 + 8)
    return (alpha, d_src, d_dst,
            alpha * EPS32 * (2 * zmax + 4 * L.sqrt().index_select(
                0, plan.rows) + 8) + 1e-30,
            k * alpha.new_zeros(plan.m).index_add_(0, plan.rows, terms)
            + 1e-30,
            k * alpha.new_zeros(plan.n).index_add_(0, plan.cols.long(),
                                                   terms) + 1e-30)


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_edge_softmax_kernels_match_float64(cuda, slope):
    """The scores and softmax on the card: one forward launch and one
    backward call (its two kernels), no plain call; alpha and both
    gradients within their f32 bounds of float64 (as the plain version
    is), on rows and columns a block takes (longer than 256 edges, read
    at once up to 2048 and in chunks above), rows of one edge (alpha
    exactly 1) and empty rows, z of both signs; two launches give the
    same bits."""
    from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell
    from flex_tpu_torch.ops.edge_softmax import (
        edge_attention_bwd_plain, edge_attention_plain, edge_attention_rows,
        edge_attention_rows_bwd,
    )

    g = _attention_graph()
    plan = prepare_dyn_ell(g, device=cuda)
    assert plan.long_rows.tolist() == [0, 1, 2]
    assert plan.long_cols.shape[0] >= 2
    s_src, s_dst, w = _attention_case(cuda, g, 7)
    z = s_src.index_select(0, plan.rows) + s_dst.index_select(
        0, plan.cols.long())
    assert bool((z > 0).any()) and bool((z < 0).any())
    counters = (edge_attention_rows.launches, edge_attention_rows.plain_calls,
                edge_attention_rows_bwd.launches,
                edge_attention_rows_bwd.plain_calls)
    a = s_src.clone().requires_grad_()
    b = s_dst.clone().requires_grad_()
    alpha = plan.edge_attention(a, b, slope)
    (alpha * w).sum().backward()
    assert (edge_attention_rows.launches, edge_attention_rows.plain_calls,
            edge_attention_rows_bwd.launches,
            edge_attention_rows_bwd.plain_calls) == (
        counters[0] + 1, counters[1], counters[2] + 1, counters[3])
    ref, r_src, r_dst, tol, tol_src, tol_dst = _attention_float64(
        plan, s_src, s_dst, w, slope)
    plain = edge_attention_plain(plan, s_src, s_dst, slope)
    p_src, p_dst = edge_attention_bwd_plain(plan, plain, w, s_src, s_dst,
                                            slope)
    for label, got, want, bound in (
            ("alpha", alpha.detach(), ref, tol),
            ("d_src", a.grad, r_src, tol_src),
            ("d_dst", b.grad, r_dst, tol_dst),
            ("plain alpha", plain, ref, tol),
            ("plain d_src", p_src, r_src, tol_src),
            ("plain d_dst", p_dst, r_dst, tol_dst)):
        gap = (got.double() - want).abs() / bound
        assert float(gap.max()) <= 1.0, (label, float(gap.max()))
    single = torch.from_numpy(g.row_ptr[:-1][g.degrees == 1]).to(cuda)
    assert bool((alpha.detach()[single] == 1).all())
    again = edge_attention_rows(plan, s_src, s_dst, slope)
    assert torch.equal(again, alpha.detach())
    d2 = edge_attention_rows_bwd(plan, again, w, s_src, s_dst, slope)
    assert torch.equal(d2[0], a.grad) and torch.equal(d2[1], b.grad)


def test_gat_forward_and_backward_read_nothing_on_the_host(cuda):
    """A GAT forward and backward on the card (after one warm-up step,
    which builds the kernels) under ``set_sync_debug_mode("error")``: no
    device-to-host copy or synchronise anywhere on the path."""
    from flex_tpu_torch.models import GAT, gat_loss, prepare_attention

    g = _with_self_loops(community_graph(1000, 20_000, n_comm=4, seed=4))
    ag = prepare_attention(g, device=cuda)
    model = GAT(16, layers=[(2, 32, True), (2, 8, False)],
                generator=torch.Generator().manual_seed(0)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    X = torch.randn((g.m, 16), generator=gen, device=cuda)
    y = torch.randint(0, 8, (g.m,), generator=gen, device=cuda)
    mask = torch.ones(g.m, device=cuda)
    gat_loss(model, ag, X, y, mask).backward()
    model.zero_grad(set_to_none=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gat_loss(model, ag, X, y, mask).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(p.grad.isfinite().all()) for p in model.parameters())


def test_edge_softmax_kernels_refuse_what_they_cannot_take(cuda):
    from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell
    from flex_tpu_torch.ops.edge_softmax import edge_attention_rows_bwd

    g = _attention_graph(m=400)
    plan = prepare_dyn_ell(g, device=cuda)
    s = torch.zeros(g.m, device=cuda)
    with pytest.raises(ValueError, match="lies on cpu"):
        plan.edge_attention(s.cpu(), s)
    with pytest.raises(ValueError, match="float32"):
        plan.edge_attention(s, s.double())
    with pytest.raises(ValueError, match="shape"):
        plan.edge_attention(s[1:], s)
    with pytest.raises(ValueError, match="contiguous"):
        plan.edge_attention(torch.zeros(2 * g.m, device=cuda)[::2], s)
    alpha = torch.zeros(g.nnz, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        edge_attention_rows_bwd(plan, alpha,
                                torch.zeros(2 * g.nnz, device=cuda)[::2],
                                s, s, 0.2)


@pytest.mark.parametrize("k", [32, 128])
def test_panel_hub_rows_match_plain_and_scipy(cuda, k):
    """The panel plan with hub rows: the hub tables through the row-unit
    kernel against its plain version, the whole plan against SciPy; tail
    panels only without hubs."""
    from flex_tpu_torch.io.synth import hub_graph
    from flex_tpu_torch.ops.panel_spmm import prepare_panel

    g = reorder(hub_graph(20_000, 400_000, n_hub_cols=128, seed=1), "deg")
    B = make_features(g, k)
    B_dev = torch.from_numpy(B).to(cuda)
    for kw in (dict(), dict(hub_threshold=int(np.percentile(g.degrees, 99)),
                            hub_width=8)):
        plan = prepare_panel(g, device=cuda, **kw)
        before = gespmm_rows.launches
        out = plan(B_dev)
        assert gespmm_rows.launches == before + (plan.n_hub_rows > 0)
        assert res_check(spmm_scipy(g, B), out.cpu().numpy(),
                         g.degrees).err_frac == 0
        assert torch.equal(out, plan(B_dev))
        if plan.n_hub_rows:
            t = plan.hub_rows
            _assert_rows_close(out[:plan.n_hub_rows],
                               gespmm_rows_plain(t, B_dev),
                               _rows_tol(t, B_dev))


# -- kernel 7's bf16 instance and the sharded plans on one card ---------------

@pytest.mark.parametrize("k", [8, 16, 32, 41, 64, 96, 128, 200])
@pytest.mark.parametrize("w", [7, 32])
def test_gespmm_bf16_kernel_matches_plain(cuda, w, k):
    """B in bf16: the bf16 instance (counted apart from the f32 one) gives
    the f32 instance's bits on B widened (the same fmaf order), its plain
    version within the rounding bound of two f32 sums, the same bits when
    launched again, and the same bits on each layout of B: contiguous, the
    plans' padded cast (16-byte loads at every k) and misaligned (2-byte
    loads), one launch each, with and without an accumulator; f32 out."""
    from flex_tpu_torch.ops.gespmm import gespmm_rows_bf16, to_bf16_padded

    g = _hub_and_empty()
    plan = prepare_gespmm(g, w=w, device=cuda)
    Bb = (torch.rand((g.n, k), device=cuda) * 2 - 1).bfloat16()
    before = (gespmm_rows.launches, gespmm_rows_bf16.launches)
    out = gespmm_rows(plan.rows, Bb)
    assert out.dtype == torch.float32
    assert (gespmm_rows.launches, gespmm_rows_bf16.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(out, gespmm_rows(plan.rows, Bb))
    assert torch.equal(out, gespmm_rows(plan.rows, Bb.float()))
    _assert_rows_close(out, gespmm_rows_plain(plan.rows, Bb),
                       _rows_tol(plan.rows, Bb.float()))
    mis = torch.empty(g.n * k + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(g.n, k)
    mis.copy_(Bb)
    padded = to_bf16_padded(Bb)
    base = torch.rand((g.m, k), device=cuda)
    want_into = gespmm_rows(plan.rows, Bb.float(), into=base.clone())
    for layout in (Bb, padded, mis):
        n0 = gespmm_rows_bf16.launches
        assert torch.equal(out, gespmm_rows(plan.rows, layout))
        assert torch.equal(gespmm_rows(plan.rows, layout, into=base.clone()),
                           want_into)
        assert gespmm_rows_bf16.launches == n0 + 2


def test_gespmm_bf16_refuses_a_short_last_row(cuda):
    """A row-strided bf16 B whose storage ends before its last row's pad is
    refused: 16-byte loads would read past it."""
    from flex_tpu_torch.ops.gespmm import gespmm_rows_bf16

    g = _hub_and_empty()
    plan = prepare_gespmm(g, w=32, device=cuda)
    flat = torch.zeros((g.n - 1) * 48 + 41, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="pad"):
        gespmm_rows_bf16(plan.rows, flat.as_strided((g.n, 41), (48, 1)))


def test_bf16_ell_plan_on_the_card(cuda):
    """``prepare_ell(b_dtype="bfloat16")`` launches the bf16 instance and
    passes res_check at the bf16 scale; its transposed backward plan
    gathers the cotangent in bf16 on the same instance."""
    from flex_tpu_torch.bench.harness import check_eps_scale
    from flex_tpu_torch.ops.gespmm import gespmm_rows_bf16

    g = CASES["community"][0]()
    plan = with_bwd_plan(prepare_ell(g, b_dtype="bfloat16", device=cuda),
                         g.n)
    B = make_features(g, 41)
    Bt = torch.from_numpy(B).to(cuda).requires_grad_()
    before = (gespmm_rows.launches, gespmm_rows_bf16.launches)
    C = plan(Bt)
    co = torch.rand_like(C)
    (C * co).sum().backward()
    assert (gespmm_rows.launches, gespmm_rows_bf16.launches) == (
        before[0], before[1] + 2)
    assert res_check(spmm_scipy(g, B), C.detach().cpu().numpy(), g.degrees,
                     eps_scale=check_eps_scale(plan)).err_frac == 0
    col_deg = np.bincount(g.col, minlength=g.n)
    assert res_check(g.to_scipy().T @ co.cpu().numpy(),
                     Bt.grad.cpu().numpy(), col_deg,
                     eps_scale=check_eps_scale(plan)).err_frac == 0


@pytest.mark.parametrize("layout", ["replicated", "gathered"])
def test_sharded_ell_on_one_card(cuda, layout):
    """``make_mesh(4)`` on a machine with fewer cards repeats them (on one
    card, 4 × cuda:0): the sharded ELL plan runs kernel 7 once a shard and
    matches SciPy; g_B through its transposed plans runs it again."""
    from flex_tpu_torch.parallel import make_mesh, prepare_ell_sharded

    mesh = make_mesh(4)
    assert mesh.size == 4 and all(d.type == "cuda" for d in mesh.devices)
    g = rmat_graph(2048, 32768, seed=3)
    plan = prepare_ell_sharded(g, mesh, b_layout=layout).for_training()
    B = make_features(g, 32)
    Bt = torch.from_numpy(B).to(cuda).requires_grad_()
    before = gespmm_rows.launches
    C = plan(Bt)
    assert gespmm_rows.launches == before + 4
    assert res_check(spmm_scipy(g, B), C.detach().cpu().numpy(),
                     g.degrees).err_frac == 0
    co = torch.rand_like(C)
    (C * co).sum().backward()
    assert gespmm_rows.launches == before + 8
    col_deg = np.bincount(g.col, minlength=g.n)
    assert res_check(g.to_scipy().T @ co.cpu().numpy(),
                     Bt.grad.cpu().numpy(), col_deg).err_frac == 0


# -- the probes' kernels 8-11 (flex_tpu_torch/experiments/micro.py) ----------

@pytest.mark.parametrize("steps, rows, k, depth", [
    (3, 0, 128, 8), (4, 7, 128, 16), (64, 1024, 128, 16), (5, 1001, 64, 8),
    (2, 300, 36, 16)])
def test_row_gather_sum_kernel_gives_plain_bits(cuda, steps, rows, k, depth):
    from flex_tpu_torch.experiments import micro

    gen = torch.Generator(device=cuda).manual_seed(rows)
    B = torch.rand((4000, k), generator=gen, device=cuda) * 2 - 1
    idx = torch.randint(0, 4000, (steps, rows), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = micro.row_gather_sum.launches
    out = micro.row_gather_sum(B, idx, depth)
    assert micro.row_gather_sum.launches == before + 1
    assert torch.equal(out, micro.row_gather_sum_plain(B, idx))


def test_smem_probe_kernel_finds_the_limit(cuda):
    from flex_tpu_torch.experiments import micro, micro_tpu

    limit = micro.smem_optin(cuda)
    x = torch.rand((8, 128), device=cuda)
    assert torch.equal(micro.smem_probe(x, limit), x)
    before = micro.smem_probe.launches
    with pytest.raises(RuntimeError):
        micro.smem_probe(x, limit + 1024)
    assert micro.smem_probe.launches == before   # refused: not launched
    assert torch.equal(micro.smem_probe(x, 48 * 1024), x)
    r = micro_tpu.m6_vmem_probe(device=cuda)
    assert r["limit_bytes"] == limit and r["ok_kb"] * 1024 <= limit


@pytest.mark.parametrize("placement", ["l2", "cluster"])
@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("U, k, n", [(4096, 128, 131072), (1000, 36, 777)])
def test_slab_gather_kernel_gives_plain_bits(cuda, placement, round_bf16,
                                             U, k, n):
    from flex_tpu_torch.experiments import micro

    gen = torch.Generator(device=cuda).manual_seed(U)
    slab = torch.rand((U, k), generator=gen, device=cuda) * 2 - 1
    idx = torch.randint(0, U, (n,), generator=gen, device=cuda,
                        dtype=torch.int32)
    assert torch.equal(micro.slab_gather(slab, idx, placement, round_bf16),
                       micro.slab_gather_plain(slab, idx, round_bf16))


@pytest.mark.parametrize("N, w, k", [(100, 40, 200), (7, 1, 4), (2048, 32, 128)])
def test_ell_reduce_kernel_within_the_order_bound(cuda, N, w, k):
    from flex_tpu_torch.experiments import micro

    gen = torch.Generator(device=cuda).manual_seed(N)
    v = torch.rand((N, w), generator=gen, device=cuda) * 2 - 1
    Bg = torch.rand((N, w, k), generator=gen, device=cuda) * 2 - 1
    out = micro.ell_reduce(v, Bg)
    ref = micro.ell_reduce_plain(v, Bg)
    bound = 2 * w * EPS32 * (v.abs()[:, :, None] * Bg.abs()).sum(1)
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.parametrize("G, W, TM, k", [(4, 128, 256, 128), (8, 128, 256, 41),
                                         (4, 48, 200, 200), (3, 32, 64, 16)])
def test_winstep_bf16_kernel_within_the_order_bound(cuda, G, W, TM, k):
    """Kernel 12 against its plain version (kernel 1's on bf16-rounded
    operands) to 2·L·eps·Σ|a||b|, panels of 1, 8, 9 and 17 steps with
    sentinels and rows >= n; a second launch gives the same bits."""
    from flex_tpu_torch.experiments import micro

    rng = np.random.default_rng(G * W + k)
    steps = [1, 8, 9, 17]
    S, n = sum(steps), 3000 + 7
    nblk = -(-n // W)
    win = rng.integers(0, nblk + 1, S * G).astype(np.int32)
    win[:G] = nblk                                      # an all-sentinel step
    win[G] = nblk - 1                                   # the partial block
    out_panel = np.repeat(np.arange(len(steps)), steps).astype(np.int32)
    first = np.zeros(S, np.int32)
    first[np.cumsum([0] + steps[:-1])] = 1
    ptr = np.r_[0, np.cumsum(steps)].astype(np.int32)
    tabs = [torch.from_numpy(a).to(cuda) for a in (first, out_panel, win)]
    gen = torch.Generator(device=cuda).manual_seed(k)
    A = torch.rand((S, TM, G * W), generator=gen, device=cuda) * 2 - 1
    B = torch.rand((n, k), generator=gen, device=cuda) * 2 - 1
    kw = dict(n_panels=len(steps), W=W)
    p = torch.from_numpy(ptr).to(cuda)
    out = micro.window_step_bf16(*tabs, A, B, panel_step_ptr=p, **kw)
    assert torch.equal(out, micro.window_step_bf16(*tabs, A, B,
                                                   panel_step_ptr=p, **kw))
    ref = micro.window_step_bf16_plain(*tabs, A, B, **kw)
    absprod = window_spmm_fwd_plain(*tabs, A.bfloat16().float().abs(),
                                    B.bfloat16().float().abs(), **kw)
    L = torch.from_numpy(np.repeat(np.diff(ptr) * G * W, TM)).to(cuda)
    assert bool(((out - ref).abs() <= 2 * L[:, None] * EPS32 * absprod).all())


@pytest.mark.parametrize("G, W, TM, k, misaligned", [
    (4, 48, 200, 41, False), (4, 48, 200, 200, True), (4, 128, 200, 41, True),
    (8, 128, 256, 128, True), (2, 64, 384, 200, False)])
def test_winstep_bf16_kernel_on_its_tile_edges(cuda, G, W, TM, k, misaligned):
    """Kernel 12's TMA ring and wgmma tiles at their edges: TM = 200 (the
    second warpgroup's rows past TM, read as zero from the 3-D map), 384
    (two row tiles), W = 48 (stages of 16), k = 41 and 200 (a column tile
    with one B box), a B view 4 bytes past a 16-byte boundary, an
    all-sentinel unit; held to the plain version's order bound and
    launched twice for the same bits."""
    from flex_tpu_torch.experiments import micro

    rng = np.random.default_rng(G * W + k + TM)
    steps = [1, 8, 9, 17]
    S, n = sum(steps), 3000 + 7
    nblk = -(-n // W)
    win = rng.integers(0, nblk + 1, S * G).astype(np.int32)
    win[:G] = nblk                                      # an all-sentinel unit
    win[G] = nblk - 1                                   # the partial block
    out_panel = np.repeat(np.arange(len(steps)), steps).astype(np.int32)
    first = np.zeros(S, np.int32)
    first[np.cumsum([0] + steps[:-1])] = 1
    ptr = np.r_[0, np.cumsum(steps)].astype(np.int32)
    tabs = [torch.from_numpy(a).to(cuda) for a in (first, out_panel, win)]
    gen = torch.Generator(device=cuda).manual_seed(k + TM)
    A = torch.rand((S, TM, G * W), generator=gen, device=cuda) * 2 - 1
    buf = torch.rand((n * k + 1,), generator=gen, device=cuda) * 2 - 1
    B = buf[1:].view(n, k) if misaligned else buf[:-1].view(n, k)
    kw = dict(n_panels=len(steps), W=W)
    p = torch.from_numpy(ptr).to(cuda)
    out = micro.window_step_bf16(*tabs, A, B, panel_step_ptr=p, **kw)
    assert torch.equal(out, micro.window_step_bf16(*tabs, A, B,
                                                   panel_step_ptr=p, **kw))
    assert not bool(out[:TM].any())                     # the sentinel unit
    ref = micro.window_step_bf16_plain(*tabs, A, B, **kw)
    absprod = window_spmm_fwd_plain(*tabs, A.bfloat16().float().abs(),
                                    B.bfloat16().float().abs(), **kw)
    L = torch.from_numpy(np.repeat(np.diff(ptr) * G * W, TM)).to(cuda)
    assert bool(((out - ref).abs() <= 2 * L[:, None] * EPS32 * absprod).all())


def test_smem_probe_refuses_above_the_limit_after_a_launch_at_it(cuda):
    """The shared-memory attribute is set once, to the opt-in limit: a
    launch at 227 KB does not open 228 KB."""
    from flex_tpu_torch.experiments import micro

    limit = micro.smem_optin(cuda)
    x = torch.rand((8, 128), device=cuda)
    assert torch.equal(micro.smem_probe(x, limit), x)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="CUDA error"):
            micro.smem_probe(x, limit + 1024)
        assert torch.equal(micro.smem_probe(x, limit), x)
    micro.empty_probe(limit)
    with pytest.raises(RuntimeError, match="CUDA error"):
        micro.empty_probe(limit + 1024)
    torch.cuda.synchronize()


def test_kernels_9_and_12_count_one_launch_a_call(cuda):
    from flex_tpu_torch.experiments import micro

    x = torch.rand((8, 128), device=cuda)
    before = micro.smem_probe.launches
    for i in range(3):
        micro.smem_probe(x, 48 * 1024)
        assert micro.smem_probe.launches == before + i + 1
    micro.empty_probe(48 * 1024)                        # a yardstick: uncounted
    assert micro.smem_probe.launches == before + 3
    S, TM, G, W, n = 4, 256, 2, 64, 500
    first = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=cuda)
    out_panel = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=cuda)
    win = torch.arange(S * G, dtype=torch.int32, device=cuda) % 8
    ptr = torch.tensor([0, 2, 4], dtype=torch.int32, device=cuda)
    A = torch.rand((S, TM, G * W), device=cuda)
    B = torch.rand((n, 32), device=cuda)
    before = micro.window_step_bf16.launches
    for i in range(2):
        micro.window_step_bf16(first, out_panel, win, A, B, n_panels=2, W=W,
                               panel_step_ptr=ptr)
        assert micro.window_step_bf16.launches == before + i + 1


def test_device_time_captures_the_probes(cuda):
    """The harness's device timer runs kernel 9, its empty launch and the
    clone in one CUDA graph each; kernel 9 moves 8 KB, so its time a call
    stays within the launch's scale (under 50 us)."""
    from flex_tpu_torch.bench.harness import time_device_ms
    from flex_tpu_torch.experiments import micro

    x = torch.rand((8, 128), device=cuda)
    limit = micro.smem_optin(cuda)
    for fn, args in ((micro.smem_probe, (x, limit)),
                     (micro.empty_probe, (limit,)),
                     (lambda a: a.clone(), (x,))):
        ms = time_device_ms(fn, *args, n=50, reps=3)
        assert 0 < ms < 0.05


def test_winstep_and_band_v2_mains_on_the_card(cuda, capsys):
    from flex_tpu_torch.experiments import micro, micro_winstep, pallas_band_v2

    before = micro.window_step_bf16.launches
    micro_winstep.main(windows=96, iters=2, m=3000)
    assert micro.window_step_bf16.launches - before == 2 * (1 + 3 + 2)
    r = pallas_band_v2.main(m=8192, bandwidth=128, avg_degree=24.0, iters=2)
    assert r["err_frac"] == 0.0
    assert "pallas v2: " in capsys.readouterr().out


def test_precision_ladder_falls_back_to_kernel_12(cuda, monkeypatch):
    """Without ``torch.bmm(out_dtype=)`` the ladder's bf16 products run on
    kernel 12 (G = JW / 128, one step a panel), with the same function."""
    from flex_tpu_torch.experiments import micro_precision

    A, B = (torch.from_numpy(x).to(cuda) for x in micro_precision.make_inputs(
        P=3, TM=64, JW=512, K=32))
    ref, how = micro_precision.bf16_product(A, B)
    assert "out_dtype" in how
    a, b = A.bfloat16().float(), B.bfloat16().float()
    want = ref(a, b)
    bmm = torch.bmm

    def bmm_without_out_dtype(*args, **kw):
        if "out_dtype" in kw:
            raise TypeError("no out_dtype")
        return bmm(*args, **kw)

    monkeypatch.setattr(torch, "bmm", bmm_without_out_dtype)
    k12, how = micro_precision.bf16_product(A, B)
    assert "kernel 12" in how
    bound = 2 * 512 * EPS32 * (a.abs().reshape(-1, 512) @ b.abs()).view(
        3, 64, 32)
    assert bool(((k12(a, b) - want).abs() <= bound).all())
