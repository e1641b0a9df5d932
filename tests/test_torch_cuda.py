"""Card-only tests of the PyTorch port: the hand CUDA window kernels
(forward, g_A, g_B) against their plain twins, whole plans on the card
against SciPy, gradients against SciPy's Aᵀ·co, and a few GCN train steps.  Every test is
marked ``cuda`` and skips without a card.  The file imports no JAX, so on
a machine with PyTorch alone it runs as
``python -m pytest --noconftest tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from flex_tpu_torch import prepare_ell, prepare_windowed
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
    window_bwd_gA, window_bwd_gA_plain, window_bwd_gB, window_bwd_gB_plain,
    window_spmm_fwd, window_spmm_fwd_plain, with_training_bwd,
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


@pytest.mark.parametrize("k", [41, 128])
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
    # the residue's scatter-add sums in an order of its own on each run
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
