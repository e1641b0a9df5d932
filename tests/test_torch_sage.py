"""GraphSAGE and the checkpoint module of the PyTorch port against the JAX
package, on the CPU: the same plan arrays (carried across by ``convert``),
the same weights (``convert.sage_params_from_numpy``), the same X, y and
mask; the forward within 1e-4, the loss within 1e-5 relative, and five
Adam steps against optax (losses and parameters within 1e-4 relative,
parameters with an absolute floor of 1e-5).
A checkpoint written after step 3 and restored into a fresh model and
optimizer gives the uninterrupted run's next step bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flex_tpu.models import GraphSAGE as JSAGE
from flex_tpu.models import make_sage_train_step as j_make_sage_train_step
from flex_tpu.models import sage_loss as j_sage_loss
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed

from flex_tpu_torch.convert import (
    ell_plan_from_numpy, sage_params_from_numpy, windowed_plan_from_numpy,
)
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.models import GraphSAGE, make_sage_train_step, sage_loss
from flex_tpu_torch.models.checkpoint import (
    restore_checkpoint, save_checkpoint,
)
from flex_tpu_torch.models.common import make_step
from flex_tpu_torch.ops.window_spmm import prepare_windowed
from test_torch_ell import jax_ell_dict, jax_graph
from test_torch_windowed import jax_windowed_dict

WIN_KW = dict(tm=256, W=128, J=8, min_count=8)
# layer 1 (8 -> 16) is (A·X)·W, layer 2 (16 -> 5) A·(X·W)
D_IN, D_HID, N_CLS = 8, 16, 5
NAMES = ("Ws1", "Wn1", "b1", "Ws2", "Wn2", "b2")


def _graph():
    return community_graph(2000, 150_000, n_comm=4, seed=9, shuffle=False)


def _data(g, seed=0):
    rng = np.random.default_rng(seed)
    X = make_features(g, D_IN)
    y = rng.integers(0, N_CLS, g.m).astype(np.int32)
    mask = (rng.random(g.m) < 0.6).astype(np.float32)
    return X, y, mask


def _models(g, seed=0):
    jmodel = JSAGE(d_in=D_IN, d_hidden=D_HID, n_classes=N_CLS, nnz=g.nnz)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = GraphSAGE(D_IN, D_HID, N_CLS, nnz=g.nnz,
                      generator=torch.Generator().manual_seed(seed))
    sage_params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                           model)
    return jmodel, params, model


def _plans(kind, g):
    if kind == "windowed":
        jplan = j_prepare_windowed(jax_graph(g), **WIN_KW)
        assert jplan.ell.nnz > 0 and jplan.bwd_tabs is not None
        return jplan, windowed_plan_from_numpy(jax_windowed_dict(jplan),
                                               "cpu")
    jplan = j_prepare_ell(jax_graph(g))
    return jplan, ell_plan_from_numpy(jax_ell_dict(jplan), "cpu")


def test_sage_init_is_glorot_from_the_generator():
    make = lambda seed: GraphSAGE(  # noqa: E731
        64, 32, 7, nnz=10, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == {
        "Ws1": (64, 32), "Wn1": (64, 32), "b1": (32,), "Ws2": (32, 7),
        "Wn2": (32, 7), "b2": (7,)}
    for name, fan in (("Ws1", 96), ("Wn1", 96), ("Ws2", 39), ("Wn2", 39)):
        w = getattr(a, name).detach()
        limit = (6.0 / fan) ** 0.5
        assert 0.9 * limit < float(w.abs().max()) <= limit
        torch.testing.assert_close(w, getattr(b, name).detach(), rtol=0,
                                   atol=0)
        assert not torch.equal(w, getattr(c, name).detach())
    assert not torch.equal(a.Ws1, a.Wn1)
    assert not a.b1.any() and not a.b2.any()


def test_sage_params_from_numpy_copies_and_checks_shapes():
    _, params, model = _models(_graph())
    for name in NAMES:
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      np.asarray(params[name]))
        assert getattr(model, name).requires_grad
    bad = {k: np.asarray(v) for k, v in params.items()}
    bad["Wn1"] = bad["Wn1"].T
    with pytest.raises(ValueError, match="Wn1"):
        sage_params_from_numpy(bad, model)


@pytest.mark.parametrize("kind", ["windowed", "ell"])
def test_sage_forward_and_loss_match_jax(kind):
    g = _graph()
    X, y, mask = _data(g)
    jmodel, params, model = _models(g)
    jplan, plan = _plans(kind, g)
    ref = np.asarray(jmodel.apply(params, jplan, jnp.asarray(X)))
    Xt = torch.from_numpy(X)
    out = model(plan, Xt)
    assert tuple(out.shape) == (g.m, N_CLS)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    loss_ref = float(j_sage_loss(jmodel, params, jplan, jnp.asarray(X),
                                 jnp.asarray(y), jnp.asarray(mask)))
    loss = float(sage_loss(model, plan, Xt, torch.from_numpy(y),
                           torch.from_numpy(mask)).detach())
    assert loss == pytest.approx(loss_ref, rel=1e-5)


@pytest.mark.parametrize("kind", ["windowed", "ell"])
def test_five_sage_train_steps_match_jax(kind):
    g = _graph()
    X, y, mask = _data(g)
    jmodel, params, model = _models(g)
    jplan, plan = _plans(kind, g)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    jstep = j_make_sage_train_step(jmodel, jplan, opt)
    Xj, yj, mj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask)
    ref_losses = []
    for _ in range(5):
        params, state, loss = jstep(params, state, Xj, yj, mj)
        ref_losses.append(float(loss))

    step = make_sage_train_step(model, plan,
                                torch.optim.Adam(model.parameters(), lr=1e-2))
    Xt, yt, mt = (torch.from_numpy(a) for a in (X, y, mask))
    losses = [float(step(Xt, yt, mt)) for _ in range(5)]

    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for name in NAMES:
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_make_sage_train_step_attaches_the_training_backward(monkeypatch):
    g = _graph()
    X, y, mask = (torch.from_numpy(a) for a in _data(g))
    _, _, model = _models(g, seed=3)
    seen = []
    monkeypatch.setattr(
        "flex_tpu_torch.models.common.make_step",
        lambda fn, plan, opt: seen.append(plan) or make_step(fn, plan, opt))
    plan = prepare_windowed(g, device="cpu", **WIN_KW)
    step = make_sage_train_step(
        model, plan, torch.optim.Adam(model.parameters(), lr=1e-2))
    assert plan.ell.bwd_plan is None and seen[0].ell.bwd_plan is not None
    before = model.Wn1.detach().clone()
    loss = step(X, y, mask)
    assert loss.dim() == 0 and not loss.requires_grad and bool(loss.isfinite())
    assert not torch.equal(model.Wn1.detach(), before)
    assert plan.A.grad is None            # the adjacency is a constant


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _run(model, plan, opt, data, n):
    step = make_sage_train_step(model, plan, opt)
    return [step(*data) for _ in range(n)]


def test_checkpoint_resume_gives_the_next_step_bit_for_bit(tmp_path):
    """Save after step 3, restore into a fresh model and optimizer: steps 4
    and 5 equal the uninterrupted run's, losses and parameters, bit for
    bit."""
    g = _graph()
    data = tuple(torch.from_numpy(a) for a in _data(g))
    plan = prepare_windowed(g, device="cpu", **WIN_KW)
    _, _, model = _models(g)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_sage_train_step(model, plan, opt)
    first = [step(*data) for _ in range(3)]
    path = tmp_path / "ckpt" / "sage.pt"
    save_checkpoint(str(path), model, opt, step=3)
    rest = [step(*data) for _ in range(2)]

    _, _, fresh = _models(g, seed=7)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
    assert restore_checkpoint(str(path), fresh, fresh_opt) == 3
    resumed = _run(fresh, plan, fresh_opt, data, 2)
    for a, b in zip(rest, resumed):
        assert torch.equal(a, b)
    for name in NAMES:
        assert torch.equal(getattr(model, name), getattr(fresh, name)), name
    assert all(torch.isfinite(x) for x in first)
    assert not list(path.parent.glob("*.tmp"))


def test_checkpoint_without_optimizer(tmp_path):
    g = _graph()
    _, _, model = _models(g)
    save_checkpoint(str(tmp_path / "m.pt"), model)
    _, _, other = _models(g, seed=5)
    assert restore_checkpoint(str(tmp_path / "m.pt"), other) == 0
    for name in NAMES:
        assert torch.equal(getattr(model, name), getattr(other, name))
    opt = torch.optim.Adam(other.parameters(), lr=1e-2)
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_checkpoint(str(tmp_path / "m.pt"), other, opt)


def test_checkpoint_refuses_another_model(tmp_path):
    g = _graph()
    _, _, model = _models(g)
    save_checkpoint(str(tmp_path / "m.pt"), model)
    wider = GraphSAGE(D_IN, D_HID + 1, N_CLS, nnz=g.nnz,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_checkpoint(str(tmp_path / "m.pt"), wider)
