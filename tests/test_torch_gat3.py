"""The port's GAT with per-layer heads (the benchmark's ``gat3`` model:
4, 4 and 6 heads of 8, 8 and 5 columns, from 12 inputs, the identity
skip across layer 2, the last layer averaged) against the benchmark's
plain reference, ``spmm_bench/reference/gat3.py``, in float64, on the
CPU: the logits, the loss, every leaf's first gradient and three Adam
steps against ``reference.common.train``.  The graph is a seeded
2,000-node graph with self-loops, a tenth of its rows holding only
their self-loop.  Besides: the reference's blocked aggregation against
plain autograd of the unblocked formula, and the layer options of
``GAT``.

The port computes in float32 and the reference in float64, so each
tolerance is float32's rounding carried through the model: a product or
sum of n terms is off by about n·2⁻²⁴ of its scale, the terms here are
at most a few dozen (12 to 32 inputs a product, rows of at most 41
edges), and three layers and a softmax compound it."""
import numpy as np
import pytest
import torch

from flex_tpu_torch.models.common import masked_xent
from flex_tpu_torch.models.gat import (
    GAT, GATLayer, gat_loss, make_gat_train_step, prepare_attention,
)
from flex_tpu_torch.sparse.csr import CSRGraph
from spmm_bench.reference import common, gat3

M, D_IN = 2000, 12
LAYERS = (GATLayer(4, 8, True), GATLayer(4, 8, True), GATLayer(6, 5, False))
N_CLS = 5
LR, STEPS = 0.01, 3


def _graph(seed=0):
    """Each row: its self-loop, and for nine rows in ten 1 to 40 random
    neighbours (repeats kept, as the pattern gives them)."""
    rng = np.random.default_rng(seed)
    deg = np.where(rng.random(M) < 0.1, 0, rng.integers(1, 41, M))
    cols = []
    for i, d in enumerate(deg):
        cols.append(np.sort(np.append(rng.integers(0, M, d), i)))
    row_ptr = np.concatenate([[0], np.cumsum(deg + 1)])
    col = np.concatenate(cols)
    return CSRGraph.from_arrays(row_ptr, col, np.ones(len(col)))


@pytest.fixture(scope="module")
def case():
    g = _graph()
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal((M, D_IN)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, N_CLS, M))
    mask = torch.from_numpy((rng.random(M) < 0.66).astype(np.float32))
    A = common.Adjacency(g.row_ptr, g.col, g.vals, np.arange(M), "cpu")
    return g, A, X, y, mask


def _model(seed=0):
    return GAT(D_IN, layers=LAYERS, skip=2,
               generator=torch.Generator().manual_seed(seed))


def _leaves(model):
    return [p.detach().double().requires_grad_(True)
            for p in model.parameters()]


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def test_the_graph_has_self_loop_only_rows(case):
    g = case[0]
    assert (g.degrees == 1).mean() > 0.05
    rows = np.repeat(np.arange(M), g.degrees)
    assert np.all(np.bincount(rows[g.col == rows], minlength=M) >= 1)


def test_logits_and_loss_match_the_reference(case):
    g, A, X, y, mask = case
    model = _model()
    ag = prepare_attention(g, device="cpu")
    out = model(ag, X)
    ref = gat3.forward(A, X.double(), _leaves(model)).detach()
    assert out.shape == (M, N_CLS)
    # float32 rounding through three layers: ~1e-7 of each logit's scale
    # a layer; 2e-6 of the largest logit leaves room above it
    scale = float(ref.abs().max())
    torch.testing.assert_close(out.double(), ref, rtol=0,
                               atol=2e-6 * scale)
    loss = float(gat_loss(model, ag, X, y, mask).detach())
    r_loss = float(common.masked_xent(ref, y, mask.double()))
    # a mean of ~1,300 log-softmax terms of float32 logits
    assert loss == pytest.approx(r_loss, rel=2e-6)


def test_first_gradients_match_the_reference(case):
    g, A, X, y, mask = case
    model = _model()
    ag = prepare_attention(g, device="cpu")
    gat_loss(model, ag, X, y, mask).backward()
    leaves = _leaves(model)
    loss = common.masked_xent(gat3.forward(A, X.double(), leaves), y,
                              mask.double())
    grads = torch.autograd.grad(loss, leaves)
    names = [n for n, _ in model.named_parameters()]
    for name, p, r in zip(names, model.parameters(), grads):
        # the backward adds one more float32 pass over the same sums: the
        # gap over the leaf's gradient norm stays near 1e-6
        assert _rel(p.grad, r) < 1e-5, name


def test_three_adam_steps_match_the_reference(case):
    g, A, X, y, mask = case
    model = _model()
    init = [p.detach().clone() for p in model.parameters()]
    step = make_gat_train_step(model, prepare_attention(g, device="cpu"),
                               torch.optim.Adam(model.parameters(), lr=LR))
    losses = [float(step(X, y, mask)) for _ in range(STEPS)]
    r_losses, _, theta = common.train(A, gat3.forward, X, y, mask, init,
                                      LR, STEPS)
    # each step's loss: the forward's rounding, and after the first the
    # parameters' (each moved by about lr a step)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    for (name, p), r, w in zip(model.named_parameters(), theta, init):
        # Adam's steps are lr·m/√v: float32's rounding of the gradients
        # moves m/√v by ~1e-5 of lr where |g| is well above its rounding,
        # so the change over three steps matches within 1e-4 of its norm
        change, r_change = p.detach().double() - w.double(), r - w.double()
        assert _rel(change, r_change) < 1e-4, name


def test_tf32_reference_is_further_off_than_the_port(case):
    """The control: the reference with TF32 operands lands further from
    float64 than the port's float32 logits, by more than ten times."""
    g, A, X, y, mask = case
    model = _model()
    ref = gat3.forward(A, X.double(), _leaves(model)).detach()
    out = model(prepare_attention(g, device="cpu"), X).detach()
    tf32 = gat3.forward(A, X, [p.detach() for p in model.parameters()],
                        "tf32")
    assert _rel(tf32, ref) > 10 * _rel(out, ref)


@pytest.mark.parametrize("k", [1, 7])
def test_blocked_aggregation_is_the_unblocked_formula(case, k):
    """Values and both gradients in float64, with blocks of 3 edges' worth
    of products (several hundred blocks) against one autograd graph."""
    _, A, _, _, _ = case
    rng = np.random.default_rng(k)
    nnz = len(A.rows)
    alpha = torch.from_numpy(rng.random(nnz)).requires_grad_(True)
    B = torch.from_numpy(rng.standard_normal((M, k))).requires_grad_(True)
    co = torch.from_numpy(rng.standard_normal((M, k)))
    out = gat3.aggregate(A, alpha, B, block=3 * k)
    ga, gb = torch.autograd.grad((out * co).sum(), (alpha, B))
    plain = torch.zeros((M, k), dtype=torch.float64).index_add(
        0, A.rows, alpha[:, None] * B.index_select(0, A.cols))
    pa, pb = torch.autograd.grad((plain * co).sum(), (alpha, B))
    for got, want in ((out, plain), (ga, pa), (gb, pb)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_default_gat_is_the_two_layer_model():
    """The default constructor and the same two layers given as layers
    draw the same parameters under the same names, and give the same
    logits."""
    g = _graph(seed=3)
    a = GAT(D_IN, 8, N_CLS, n_heads=3,
            generator=torch.Generator().manual_seed(4))
    b = GAT(D_IN, layers=[(3, 8, True), (3, N_CLS, False)],
            generator=torch.Generator().manual_seed(4))
    assert a.layers == b.layers == (GATLayer(3, 8, True),
                                    GATLayer(3, N_CLS, False))
    assert a.skip is None
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    ag = prepare_attention(g, device="cpu")
    X = torch.randn((M, D_IN), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a(ag, X), b(ag, X), rtol=0, atol=0)


def test_skip_adds_the_layers_input():
    """With every W of layer 2 zero, each of its heads gives zero, so
    layer 2's output is ELU(0) = 0 plus its input: the two-layer model
    with the skip equals layer 1 alone (drawn first from the same
    generator, so with the same weights)."""
    g = _graph(seed=4)
    ag = prepare_attention(g, device="cpu")
    X = torch.randn((M, D_IN), generator=torch.Generator().manual_seed(6))
    two = GAT(D_IN, layers=LAYERS[:2], skip=2,
              generator=torch.Generator().manual_seed(0))
    one = GAT(D_IN, layers=LAYERS[:1],
              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        two.W2.zero_()
        torch.testing.assert_close(two(ag, X), one(ag, X), rtol=0, atol=0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(layers=LAYERS, skip=1), "skip around layer 1"),
    (dict(layers=LAYERS, skip=4), "skip must name a layer"),
    (dict(layers=LAYERS, d_hidden=8), "not both"),
    (dict(), "needs d_hidden"),
])
def test_gat_refuses_what_it_cannot_build(kwargs, match):
    with pytest.raises(ValueError, match=match):
        GAT(D_IN, generator=torch.Generator().manual_seed(0), **kwargs)


def test_masked_xent_is_the_references(case):
    """The loss the port and the reference take is one formula."""
    _, _, _, y, mask = case
    logits = torch.randn((M, N_CLS), generator=torch.Generator()
                         .manual_seed(7), dtype=torch.float64)
    torch.testing.assert_close(masked_xent(logits, y, mask.double()),
                               common.masked_xent(logits, y, mask.double()),
                               rtol=0, atol=0)
