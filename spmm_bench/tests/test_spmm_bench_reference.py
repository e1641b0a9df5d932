"""The plain reference against SciPy and against a dense float64 GCN
whose gradients come from autograd, at small sizes."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmm_bench.reference import common as ref
from spmm_bench.reference import gcn2


def _graph(m=60, nnz=500, seed=0):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, m * m, nnz))
    A = sp.csr_matrix(((2 * rng.random(len(key)) - 1).astype(np.float32),
                       (key // m, key % m)), shape=(m, m))
    A.sort_indices()
    perm = rng.permutation(m)
    return A, perm


def _ordered(A, perm):
    """P·A·Pᵀ with perm[new] = old, by SciPy."""
    return A[perm][:, perm]


def test_spmm_matches_scipy():
    A, perm = _graph()
    adj = ref.Adjacency(A.indptr, A.indices, A.data, perm, "cpu")
    Ap = _ordered(A.astype(np.float64), perm)
    B = torch.randn(60, 7, dtype=torch.float32)
    Bn = B.double().numpy()
    np.testing.assert_allclose(adj.mm(B).numpy(), Ap @ Bn, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(adj.mm_t(B).numpy(), Ap.T @ Bn, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(adj.abs_mm(B).numpy(),
                               abs(Ap) @ np.abs(Bn), rtol=1e-12)


def test_blocks_give_the_same_sums(monkeypatch):
    A, perm = _graph(nnz=900)
    adj = ref.Adjacency(A.indptr, A.indices, A.data, perm, "cpu")
    B = torch.randn(60, 5)
    whole = adj.mm(B)
    monkeypatch.setattr(ref, "BLOCK_ELEMS", 5 * 7)  # 7 nonzeros a block
    np.testing.assert_allclose(adj.mm(B).numpy(), whole.numpy(), rtol=1e-13)


@pytest.mark.parametrize("perm", [np.array([0, 1, 1]), np.array([0, 1, 3]),
                                  np.array([0, 1]), np.array([0., 1., 2.])])
def test_ordering_is_checked(perm):
    with pytest.raises(ValueError):
        ref.check_permutation(perm, 3)


def test_round_tf32():
    x = torch.tensor([1.0, -2.5, 0.0, 3.0 * 2**-20, 1 + 2**-10],
                     dtype=torch.float32)
    assert torch.equal(ref.round_tf32(x), x)  # exact in TF32
    y = torch.randn(10000)
    r = ref.round_tf32(y)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - y).abs() <= y.abs() * 2**-11).all()
    # ties go to even: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    assert ref.round_tf32(torch.tensor([1 + 2**-11]))[0] == 1.0
    assert ref.round_tf32(torch.tensor([1 + 3 * 2**-11]))[0] == 1 + 2**-9


def _dense_model(A, perm, m, d, h, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ad = torch.from_numpy(_ordered(A.astype(np.float64), perm).toarray())
    X = torch.randn(m, d, generator=g, dtype=torch.float64)
    y = torch.randint(0, c, (m,), generator=g)
    mask = (torch.rand(m, generator=g) < 0.6).double()
    params = [torch.randn(d, h, generator=g, dtype=torch.float64) * 0.3,
              torch.randn(h, generator=g, dtype=torch.float64) * 0.1,
              torch.randn(h, c, generator=g, dtype=torch.float64) * 0.3,
              torch.randn(c, generator=g, dtype=torch.float64) * 0.1]
    return Ad, X, y, mask, params


def _dense_loss(Ad, X, y, mask, p):
    h = torch.relu(Ad @ X @ p[0] + p[1])
    z = Ad @ h @ p[2] + p[3]
    nll = -torch.log_softmax(z, -1).gather(1, y[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum(), z


def test_gcn_forward_backward_against_dense_float64():
    A, perm = _graph(m=60, nnz=700, seed=1)
    adj = ref.Adjacency(A.indptr, A.indices, A.data, perm, "cpu")
    Ad, X, y, mask, params = _dense_model(A, perm, 60, 9, 6, 4)
    leaves = [p.clone().requires_grad_(True) for p in params]
    loss, z = _dense_loss(Ad, X, y, mask, leaves)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(gcn2.forward(adj, X, params).numpy(),
                               z.detach().numpy(), rtol=1e-11, atol=1e-11)
    losses, first, _ = ref.train(adj, gcn2.forward, X, y, mask, params,
                                 0.01, 1)
    assert losses[0] == pytest.approx(float(loss), rel=1e-12)
    for g_ref, g in zip(first, grads):
        np.testing.assert_allclose(g_ref.numpy(), g.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_adam_steps_match_torch_adam():
    A, perm = _graph(m=50, nnz=400, seed=2)
    adj = ref.Adjacency(A.indptr, A.indices, A.data, perm, "cpu")
    Ad, X, y, mask, params = _dense_model(A, perm, 50, 8, 5, 3, seed=2)
    leaves = [p.clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(leaves, lr=0.01)
    torch_losses = []
    for _ in range(3):
        opt.zero_grad()
        loss, _ = _dense_loss(Ad, X, y, mask, leaves)
        loss.backward()
        opt.step()
        torch_losses.append(float(loss))
    losses, _, theta = ref.train(adj, gcn2.forward, X, y, mask, params,
                                 0.01, 3)
    np.testing.assert_allclose(losses, torch_losses, rtol=1e-11)
    for p, q in zip(theta, leaves):
        np.testing.assert_allclose(p.numpy(), q.detach().numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_tf32_mode_is_the_lower_precision():
    A, perm = _graph(m=80, nnz=1500, seed=3)
    adj = ref.Adjacency(A.indptr, A.indices, A.data, perm, "cpu")
    B = torch.randn(80, 16)
    exact = adj.mm(B)
    scale = adj.abs_mm(B)
    gap = ((adj.mm(B, "tf32").double() - exact).abs() / scale).max()
    assert 1e-5 < float(gap) < 2 * 2**-10
    # the same product rounded to float32 stays near float32's epsilon
    gap32 = ((adj.mm(B.double()).float().double() - exact).abs()
             / scale).max()
    assert float(gap32) < 1e-6
