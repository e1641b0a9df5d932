"""GCN training of the PyTorch port against the JAX package, on the CPU:
the association choice, both layer orders, the masked cross-entropy, the
model's forward, and the slice as a whole (the same initial parameters,
carried across by ``convert.gcn_params_from_numpy``, the same X, y and
mask, five Adam steps each).

Tolerances: 1e-5 for single dense/sparse products, 1e-4 relative on each
step's loss, rtol 1e-3 on the parameters after five steps (Adam divides
by the root of the second moment, which amplifies f32 round-off between
the two packages' summation orders).  ``torch.autograd.gradcheck`` needs
float64 and the format is f32 by contract, so it is not used; the JAX
gradients stand in for it (tests/test_torch_bwd.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flex_tpu.models import GCN as JGCN
from flex_tpu.models import make_train_step as j_make_train_step
from flex_tpu.models.common import masked_xent as j_masked_xent
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.ops.gcn import gcn_layer as j_gcn_layer
from flex_tpu.ops.gcn import pick_association as j_pick_association
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed

from flex_tpu_torch.convert import (
    ell_plan_from_numpy, gcn_params_from_numpy, windowed_plan_from_numpy,
)
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.models import GCN, gcn_loss, make_train_step
from flex_tpu_torch.models.common import make_step, masked_xent
from flex_tpu_torch.ops import gcn_layer, pick_association
from flex_tpu_torch.ops.ell_spmm import prepare_ell
from flex_tpu_torch.ops.window_spmm import prepare_windowed
from test_torch_ell import jax_ell_dict, jax_graph
from test_torch_windowed import jax_windowed_dict

WIN_KW = dict(tm=256, W=128, J=8, min_count=8)
# widths that take both association orders: layer 1 (8 -> 16) is (A·X)·W,
# layer 2 (16 -> 5) is A·(X·W)
D_IN, D_HID, N_CLS = 8, 16, 5


def _graph():
    return community_graph(2000, 150_000, n_comm=4, seed=9, shuffle=False)


def _data(g, seed=0):
    rng = np.random.default_rng(seed)
    X = make_features(g, D_IN)
    y = rng.integers(0, N_CLS, g.m).astype(np.int32)
    mask = (rng.random(g.m) < 0.6).astype(np.float32)
    return X, y, mask


@pytest.mark.parametrize("m,nnz,d,c", [
    (1000, 50_000, 128, 41), (1000, 50_000, 41, 128), (1000, 50_000, 64, 64),
    (232_965, 23_446_803, 128, 128), (10, 5, 3, 4),
])
def test_pick_association_matches_jax(m, nnz, d, c):
    assert pick_association(m, nnz, d, c) == j_pick_association(m, nnz, d, c)
    assert pick_association(m, nnz, d, c) == ("axw" if c <= d else "ax_w")


@pytest.mark.parametrize("bias,act", [(True, True), (False, False)])
@pytest.mark.parametrize("association", ["axw", "ax_w", "auto"])
def test_gcn_layer_matches_jax(association, bias, act):
    g = _graph()
    rng = np.random.default_rng(1)
    X = make_features(g, D_IN)
    W = rng.standard_normal((D_IN, D_HID)).astype(np.float32)
    b = rng.standard_normal(D_HID).astype(np.float32) if bias else None
    jplan = j_prepare_ell(jax_graph(g))
    plan = ell_plan_from_numpy(jax_ell_dict(jplan), "cpu")
    ref = j_gcn_layer(jplan, jnp.asarray(X), jnp.asarray(W),
                      None if b is None else jnp.asarray(b),
                      activation=jax.nn.relu if act else None,
                      association=association, nnz=g.nnz,
                      precision=jax.lax.Precision.HIGHEST)
    out = gcn_layer(plan, torch.from_numpy(X), torch.from_numpy(W),
                    None if b is None else torch.from_numpy(b),
                    activation=torch.relu if act else None,
                    association=association, nnz=g.nnz)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_gcn_layer_rejects_bad_association():
    plan = lambda B: B  # noqa: E731
    X, W = torch.ones((4, 3)), torch.ones((3, 2))
    with pytest.raises(ValueError):
        gcn_layer(plan, X, W, association="wxa")
    with pytest.raises(ValueError, match="nnz"):
        gcn_layer(plan, X, W, association="auto")


@pytest.mark.parametrize("mask_kind", ["ones", "partial", "zeros"])
def test_masked_xent_matches_jax(mask_kind):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((500, N_CLS))).astype(np.float32)
    y = rng.integers(0, N_CLS, 500).astype(np.int32)
    mask = {"ones": np.ones(500, np.float32),
            "partial": (rng.random(500) < 0.3).astype(np.float32),
            "zeros": np.zeros(500, np.float32)}[mask_kind]
    ref = float(j_masked_xent(jnp.asarray(logits), jnp.asarray(y),
                              jnp.asarray(mask)))
    out = float(masked_xent(torch.from_numpy(logits), torch.from_numpy(y),
                            torch.from_numpy(mask)))
    assert out == pytest.approx(ref, rel=1e-5, abs=1e-6)


def test_gcn_init_is_glorot_from_the_generator():
    make = lambda seed: GCN(64, 32, 7, nnz=10,  # noqa: E731
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == {
        "W1": (64, 32), "b1": (32,), "W2": (32, 7), "b2": (7,)}
    for name, fan in (("W1", 96), ("W2", 39)):
        w = getattr(a, name).detach()
        limit = (6.0 / fan) ** 0.5
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.9 * limit and abs(float(w.mean())) < 0.05
        torch.testing.assert_close(w, getattr(b, name).detach(), rtol=0, atol=0)
        assert not torch.equal(w, getattr(c, name).detach())
    assert not a.b1.any() and not a.b2.any()


def _jax_model_and_port(g):
    jmodel = JGCN(d_in=D_IN, d_hidden=D_HID, n_classes=N_CLS, nnz=g.nnz)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = GCN(D_IN, D_HID, N_CLS, nnz=g.nnz,
                generator=torch.Generator().manual_seed(0))
    gcn_params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                          model)
    return jmodel, params, model


def test_gcn_params_from_numpy_copies_and_checks_shapes():
    g = _graph()
    _, params, model = _jax_model_and_port(g)
    for name in ("W1", "b1", "W2", "b2"):
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      np.asarray(params[name]))
        assert getattr(model, name).requires_grad
    bad = {k: np.asarray(v) for k, v in params.items()}
    bad["W2"] = bad["W2"].T
    with pytest.raises(ValueError, match="W2"):
        gcn_params_from_numpy(bad, model)


def _plans(kind, g):
    if kind == "windowed":
        jplan = j_prepare_windowed(jax_graph(g), **WIN_KW)
        assert jplan.ell.nnz > 0 and jplan.bwd_tabs is not None
        return jplan, windowed_plan_from_numpy(jax_windowed_dict(jplan),
                                               "cpu")
    jplan = j_prepare_ell(jax_graph(g))
    return jplan, ell_plan_from_numpy(jax_ell_dict(jplan), "cpu")


@pytest.mark.parametrize("kind", ["windowed", "ell"])
def test_gcn_forward_and_loss_match_jax(kind):
    g = _graph()
    X, y, mask = _data(g)
    jmodel, params, model = _jax_model_and_port(g)
    jplan, plan = _plans(kind, g)
    ref = np.asarray(jmodel.apply(params, jplan, jnp.asarray(X)))
    Xt = torch.from_numpy(X)
    out = model(plan, Xt)
    assert tuple(out.shape) == (g.m, N_CLS)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    from flex_tpu.models import gcn_loss as j_gcn_loss

    loss_ref = float(j_gcn_loss(jmodel, params, jplan, jnp.asarray(X),
                                jnp.asarray(y), jnp.asarray(mask)))
    loss = float(gcn_loss(model, plan, Xt, torch.from_numpy(y),
                          torch.from_numpy(mask)).detach())
    assert loss == pytest.approx(loss_ref, rel=1e-5)


@pytest.mark.parametrize("kind", ["windowed", "ell"])
def test_five_train_steps_match_jax(kind):
    """The slice as a whole: make_train_step on the same plan arrays,
    parameters, X, y and mask; optax.adam(1e-2) against
    torch.optim.Adam(lr=1e-2)."""
    g = _graph()
    X, y, mask = _data(g)
    jmodel, params, model = _jax_model_and_port(g)
    jplan, plan = _plans(kind, g)

    opt = optax.adam(1e-2)
    state = opt.init(params)
    jstep = j_make_train_step(jmodel, jplan, opt)
    Xj, yj, mj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask)
    ref_losses = []
    for _ in range(5):
        params, state, loss = jstep(params, state, Xj, yj, mj)
        ref_losses.append(float(loss))

    step = make_train_step(model, plan,
                           torch.optim.Adam(model.parameters(), lr=1e-2))
    Xt, yt, mt = (torch.from_numpy(a) for a in (X, y, mask))
    losses = [float(step(Xt, yt, mt)) for _ in range(5)]

    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for name in ("W1", "b1", "W2", "b2"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_make_train_step_attaches_the_training_backward(monkeypatch):
    """A windowed plan gets the transposed residue backward; the caller's
    plan is left as it was; a bare EllPlan is not wrapped."""
    g = _graph()
    X, y, mask = (torch.from_numpy(a) for a in _data(g))
    model = GCN(D_IN, D_HID, N_CLS, nnz=g.nnz,
                generator=torch.Generator().manual_seed(3))
    seen = []
    monkeypatch.setattr(
        "flex_tpu_torch.models.common.make_step",
        lambda fn, plan, opt: seen.append(plan) or make_step(fn, plan, opt))
    plan = prepare_windowed(g, device="cpu", **WIN_KW)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, plan, opt)
    assert plan.ell.bwd_plan is None and seen[0].ell.bwd_plan is not None
    assert seen[0].A is plan.A
    before = model.W1.detach().clone()
    loss = step(X, y, mask)
    assert loss.dim() == 0 and not loss.requires_grad and bool(loss.isfinite())
    assert not torch.equal(model.W1.detach(), before)
    assert plan.A.grad is None            # the adjacency is a constant
    ell = prepare_ell(g, device="cpu")
    make_train_step(model, ell, opt)
    assert seen[1] is ell and ell.bwd_plan is None
