"""Card-only tests of the PyTorch port: the hand CUDA kernels (windowed
forward, g_A, g_B, transposed forward, the two band kernels, GE-SpMM)
against their plain twins, whole plans on the card against SciPy,
gradients against SciPy's Aᵀ·co, and a few GCN train steps.  Every test is
marked ``cuda`` and skips without a card.  The file imports no JAX, so on
a machine with PyTorch alone it runs as
``python -m pytest --noconftest tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from flex_tpu_torch import (
    prepare_band, prepare_ell, prepare_gespmm, prepare_windowed, spmm,
)
from flex_tpu_torch.io import (
    banded_graph, community_graph, make_features, rmat_graph,
)
from flex_tpu_torch.ops.gespmm import gespmm_partials, gespmm_partials_plain
from flex_tpu_torch.ops.pallas_band import (
    band_spmm_v1, band_spmm_v1_plain, band_spmm_v2, band_spmm_v2_plain,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
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


@pytest.mark.parametrize("k", [8, 41, 128, 200])
@pytest.mark.parametrize("w", [7, 32, 40])
def test_gespmm_kernel_matches_plain_and_scipy(cuda, w, k):
    """k a multiple of 4 or not, within one 128-column slice or beyond; w
    below, at and above a warp's 32 entries; pad chunks, empty rows and a
    row of 40 chunks."""
    g = _hub_and_empty()
    plan = prepare_gespmm(g, w=w, device=cuda)
    B = make_features(g, k)
    B_dev = torch.from_numpy(B).to(cuda)
    before = gespmm_partials.launches
    out = gespmm_partials(plan.cols, plan.vals, B_dev)
    assert gespmm_partials.launches == before + 1
    torch.testing.assert_close(
        out, gespmm_partials_plain(plan.cols, plan.vals, B_dev),
        rtol=1e-5, atol=1e-5)
    C = plan(B_dev).cpu().numpy()
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0
    assert np.all(C[g.degrees == 0] == 0.0)


def test_gespmm_kernel_refuses_what_it_cannot_take(cuda):
    plan = prepare_gespmm(_hub_and_empty(), device=cuda)
    B = torch.ones((plan.m, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gespmm_partials(plan.cols, plan.vals,
                        torch.ones((8, plan.m), device=cuda).t())
    with pytest.raises(ValueError, match="several devices"):
        gespmm_partials(plan.cols, plan.vals, B.cpu())
    with pytest.raises(ValueError, match="int32"):
        gespmm_partials(plan.cols.long(), plan.vals, B)


@pytest.mark.parametrize("method", ["xla", "bcoo", "ell", "gespmm"])
def test_spmm_methods_run_on_the_card_by_default(cuda, method):
    g = rmat_graph(2048, 32768, seed=3)
    B = make_features(g, 32)
    C = spmm(g, B, method=method)
    assert C.device.type == "cuda"
    assert res_check(spmm_scipy(g, B), C.cpu().numpy(), g.degrees).err_frac == 0
