"""The dynamic-value SpMM and the GAT of the PyTorch port against the JAX
package, on the CPU.

- ``DynEllPlan``: the output, d/dvals and d/dB against ``jax.grad`` of the
  same loss within 1e-4 (f32 sums in another order; rows of thousands of
  nonzeros, which the JAX plan splits across chunks, are held to the f32
  order bound of ``assert_sums_close``); its kernel tables cover the CSR
  and its transposed pattern exactly, and a NumPy emulation of the
  row-unit kernel on them gives the same products.
- GAT: ``edge_softmax`` rows sum to 1 and equal the JAX package's; one
  head, the model's forward and loss within 1e-4, and five Adam steps
  against optax (losses and parameters within 1e-4 relative, parameters
  with an absolute floor of 1e-5), on weights carried by
  ``convert.gat_params_from_numpy``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flex_tpu.models import GAT as JGAT
from flex_tpu.models import make_gat_train_step as j_make_gat_train_step
from flex_tpu.models import prepare_attention as j_prepare_attention
from flex_tpu.models.gat import edge_softmax as j_edge_softmax
from flex_tpu.models.gat import gat_head as j_gat_head
from flex_tpu.models.gat import gat_loss as j_gat_loss
from flex_tpu.ops.dyn_ell import prepare_dyn_ell as j_prepare_dyn_ell

from flex_tpu_torch.convert import gat_params_from_numpy
from flex_tpu_torch.io import community_graph, make_features, rmat_graph
from flex_tpu_torch.models import (
    GAT, gat_loss, make_gat_train_step, prepare_attention,
)
from flex_tpu_torch.models.gat import edge_softmax, gat_head
from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell, spmm_dyn
from flex_tpu_torch.ops.gespmm import RowTables, gespmm_rows
from test_torch_ell import (
    assert_sums_close, check_row_tables, dup_graph, emulate_row_units,
    hub_graph_with_empty_rows, jax_graph,
)

GRAPHS = {
    "rmat": lambda: rmat_graph(2048, 32768, seed=3),
    # rows of 3000 and 4500 nonzeros (split across the JAX plan's chunks),
    # many empty rows
    "long_rows": hub_graph_with_empty_rows,
    "dups": dup_graph,
    "community": lambda: community_graph(800, 20_000, n_comm=4, seed=2),
}
D_IN, D_HID, N_CLS, N_HEADS = 12, 8, 5, 3


def _abs_a(g, vals):
    """|A(vals)| as a SciPy CSR matrix (duplicate entries kept)."""
    import scipy.sparse as sp

    return sp.csr_matrix((np.abs(vals), g.col, g.row_ptr), shape=g.shape)


def _dyn_case(g, k, seed=0):
    rng = np.random.default_rng(seed)
    vals = (2 * rng.random(g.nnz) - 1).astype(np.float32)
    B = rng.standard_normal((g.n, k)).astype(np.float32)
    co = rng.standard_normal((g.m, k)).astype(np.float32)
    return vals, B, co


def _jax_dyn(g, vals, B, co):
    plan = j_prepare_dyn_ell(jax_graph(g))
    loss = lambda v, b: (plan(v, b) * co).sum()  # noqa: E731
    out = np.asarray(plan(jnp.asarray(vals), jnp.asarray(B)))
    gv, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vals),
                                            jnp.asarray(B))
    return out, np.asarray(gv), np.asarray(gb)


def _port_dyn(g, vals, B, co):
    plan = prepare_dyn_ell(g, device="cpu")
    v = torch.from_numpy(vals).requires_grad_()
    b = torch.from_numpy(B).requires_grad_()
    out = plan(v, b)
    (out * torch.from_numpy(co)).sum().backward()
    return out.detach().numpy(), v.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dyn_spmm_and_gradients_match_jax(name, k):
    g = GRAPHS[name]()
    vals, B, co = _dyn_case(g, k)
    out, gv, gb = _port_dyn(g, vals, B, co)
    r_out, r_gv, r_gb = _jax_dyn(g, vals, B, co)
    A = _abs_a(g, vals)
    assert_sums_close(out, r_out, g.degrees, A @ np.abs(B))
    # g_vals[e] = <co[row_e], B[col_e]>: k terms each
    np.testing.assert_allclose(gv, r_gv, rtol=1e-4, atol=1e-4)
    col_deg = np.bincount(g.col, minlength=g.n)
    assert_sums_close(gb, r_gb, col_deg, A.T @ np.abs(co))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dyn_tables_cover_the_csr_and_its_transpose(name, monkeypatch):
    """Forward tables: the CSR itself, row r at row_ptr[r].  Backward
    tables: the transposed pattern, a stable sort by column, its values
    vals[perm] (passed at each call: the plan keeps no value store for
    them, and a kernel call on them that gives no values is refused); the
    emulated kernel on both gives A(vals)·B and A(vals)ᵀ·co.  A call and
    its backward make no tables."""
    g = GRAPHS[name]()
    plan = prepare_dyn_ell(g, device="cpu")
    with pytest.raises(ValueError, match="the tables hold none"):
        gespmm_rows(plan.bwd, torch.ones((g.m, 4)))
    with monkeypatch.context() as mp:
        mp.setattr(RowTables, "__post_init__", lambda self: 1 / 0)
        v = torch.rand(g.nnz, requires_grad=True)
        b = torch.rand((g.n, 4), requires_grad=True)
        plan(v, b).sum().backward()
        assert v.grad is not None and b.grad is not None
    check_row_tables(plan.fwd, g.row_ptr, g.col, g.vals)
    perm = plan.perm.numpy()
    np.testing.assert_array_equal(perm, np.argsort(g.col, kind="stable"))
    assert plan.bwd.vals.numel() == 0
    At = g.to_scipy().T.tocsr()
    t_rows = np.repeat(np.arange(g.m), g.degrees)[perm]
    check_row_tables(dataclasses.replace(
        plan.bwd, vals=plan.fwd.vals.index_select(0, plan.perm)),
        At.indptr, t_rows, g.vals[perm])
    vals, B, co = _dyn_case(g, 8, seed=1)
    fwd = dataclasses.replace(plan.fwd, vals=torch.from_numpy(vals))
    bwd = dataclasses.replace(plan.bwd, vals=torch.from_numpy(vals[perm]))
    r_out, _, r_gb = _jax_dyn(g, vals, B, co)
    A = _abs_a(g, vals)
    assert_sums_close(emulate_row_units(fwd, B), r_out, g.degrees,
                      A @ np.abs(B))
    assert_sums_close(emulate_row_units(bwd, co), r_gb,
                      np.bincount(g.col, minlength=g.n), A.T @ np.abs(co))


@pytest.mark.parametrize("k", [8, 41])
def test_dyn_sub_batches_and_one_shot(k):
    """g_vals in sub-batches equals one batch; with the zero column that
    k % 4 == 0 adds and without (k = 41), it equals the dot products."""
    g = GRAPHS["rmat"]()
    vals, B, co = _dyn_case(g, k, seed=3)
    plan = prepare_dyn_ell(g, device="cpu")
    gt, Bt = torch.from_numpy(co), torch.from_numpy(B)
    whole = plan.edge_dots(gt, Bt)
    small = dataclasses.replace(plan, max_gather_rows=1000)
    torch.testing.assert_close(small.edge_dots(gt, Bt), whole, rtol=0,
                               atol=0)
    rows = np.repeat(np.arange(g.m), g.degrees)
    np.testing.assert_allclose(whole.numpy(),
                               (co[rows] * B[g.col]).sum(1, dtype=np.float64),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        spmm_dyn(g, vals, B, device="cpu"),
        plan(torch.from_numpy(vals), Bt), rtol=0, atol=0)


def test_dyn_refuses_bad_shapes():
    g = GRAPHS["rmat"]()
    plan = prepare_dyn_ell(g, device="cpu")
    with pytest.raises(ValueError, match="vals"):
        plan(torch.zeros(g.nnz + 1), torch.zeros((g.n, 4)))
    with pytest.raises(ValueError, match="B must be"):
        plan(torch.zeros(g.nnz), torch.zeros((g.n + 1, 4)))


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------

def _gat_graph():
    # unit self-loops: attention covers N(i) ∪ {i}
    return community_graph(800, 20_000, n_comm=4, seed=2)


def _data(g, seed=0):
    rng = np.random.default_rng(seed)
    X = make_features(g, D_IN)
    y = rng.integers(0, N_CLS, g.m).astype(np.int32)
    mask = (rng.random(g.m) < 0.6).astype(np.float32)
    return X, y, mask


def _models(g):
    jmodel = JGAT(d_in=D_IN, d_hidden=D_HID, n_classes=N_CLS,
                  n_heads=N_HEADS)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = GAT(D_IN, D_HID, N_CLS, n_heads=N_HEADS,
                generator=torch.Generator().manual_seed(0))
    gat_params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                          model)
    return jmodel, params, model


def test_prepare_attention_matches_jax():
    g = _gat_graph()
    ag, jag = prepare_attention(g, device="cpu"), j_prepare_attention(
        jax_graph(g))
    np.testing.assert_array_equal(ag.rows.numpy(), np.asarray(jag.rows))
    np.testing.assert_array_equal(ag.cols.numpy(), np.asarray(jag.cols))
    np.testing.assert_array_equal(ag.deg.numpy(), g.degrees)
    assert (ag.m, ag.nnz) == (jag.m, jag.nnz)


@pytest.mark.parametrize("name", ["community", "long_rows"])
def test_edge_softmax_rows_sum_to_one_and_match_jax(name):
    g = GRAPHS[name]()
    e = (np.random.default_rng(4).standard_normal(g.nnz) * 5).astype(
        np.float32)
    ag = prepare_attention(g, device="cpu")
    alpha = edge_softmax(ag, torch.from_numpy(e)).numpy()
    ref = np.asarray(j_edge_softmax(j_prepare_attention(jax_graph(g)),
                                    jnp.asarray(e)))
    np.testing.assert_allclose(alpha, ref, rtol=1e-5, atol=1e-7)
    sums = np.add.reduceat(alpha, g.row_ptr[:-1][g.degrees > 0])
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)
    assert np.all(alpha >= 0)


def test_edge_softmax_gradient_is_the_softmax_jacobian():
    g = _gat_graph()
    ag = prepare_attention(g, device="cpu")
    e = torch.from_numpy(np.random.default_rng(5).standard_normal(
        g.nnz).astype(np.float32)).requires_grad_()
    w = np.random.default_rng(6).standard_normal(g.nnz).astype(np.float32)
    (edge_softmax(ag, e) * torch.from_numpy(w)).sum().backward()
    jag = j_prepare_attention(jax_graph(g))
    ref = jax.grad(lambda x: (j_edge_softmax(jag, x) * w).sum())(
        jnp.asarray(e.detach().numpy()))
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)


def test_gat_head_matches_jax():
    g = _gat_graph()
    rng = np.random.default_rng(7)
    H = rng.standard_normal((g.m, D_IN)).astype(np.float32)
    W = rng.standard_normal((D_IN, D_HID)).astype(np.float32) * 0.3
    a_s, a_d = (rng.standard_normal(D_HID).astype(np.float32)
                for _ in range(2))
    ref = np.asarray(j_gat_head(j_prepare_attention(jax_graph(g)),
                                *(jnp.asarray(a) for a in (H, W, a_s, a_d))))
    out = gat_head(prepare_attention(g, device="cpu"),
                   *(torch.from_numpy(a) for a in (H, W, a_s, a_d)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_gat_init_is_glorot_from_the_generator():
    make = lambda seed: GAT(  # noqa: E731
        16, 8, 5, n_heads=4, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == {
        "W1": (4, 16, 8), "a1s": (4, 8), "a1d": (4, 8), "W2": (4, 32, 5),
        "a2s": (4, 5), "a2d": (4, 5)}
    jparams = JGAT(16, 8, 5, n_heads=4).init(jax.random.PRNGKey(0))
    for name, p in a.named_parameters():
        # JAX's fans: the leading (head) axis multiplies both; the a
        # vectors are drawn as (heads, d, 1)
        shape = tuple(p.shape) if p.dim() == 3 else (*p.shape, 1)
        limit = (6.0 / ((shape[1] + shape[2]) * shape[0])) ** 0.5
        w = p.detach()
        assert float(w.abs().max()) <= limit, name
        assert float(w.abs().max()) > 0.8 * limit, name
        assert float(np.abs(np.asarray(jparams[name])).max()) <= limit, name
        torch.testing.assert_close(w, getattr(b, name).detach(), rtol=0,
                                   atol=0)
        assert not torch.equal(w, getattr(c, name).detach())


def test_gat_params_from_numpy_copies_and_checks_shapes():
    g = _gat_graph()
    _, params, model = _models(g)
    for name in ("W1", "a1s", "a1d", "W2", "a2s", "a2d"):
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      np.asarray(params[name]))
    bad = {k: np.asarray(v) for k, v in params.items()}
    bad["a2d"] = bad["a2d"][:, :-1]
    with pytest.raises(ValueError, match="a2d"):
        gat_params_from_numpy(bad, model)


def test_gat_forward_and_loss_match_jax():
    g = _gat_graph()
    X, y, mask = _data(g)
    jmodel, params, model = _models(g)
    jag, ag = j_prepare_attention(jax_graph(g)), prepare_attention(
        g, device="cpu")
    ref = np.asarray(jmodel.apply(params, jag, jnp.asarray(X)))
    out = model(ag, torch.from_numpy(X))
    assert tuple(out.shape) == (g.m, N_CLS)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    loss_ref = float(j_gat_loss(jmodel, params, jag, jnp.asarray(X),
                                jnp.asarray(y), jnp.asarray(mask)))
    loss = float(gat_loss(model, ag, torch.from_numpy(X), torch.from_numpy(y),
                          torch.from_numpy(mask)).detach())
    assert loss == pytest.approx(loss_ref, rel=1e-4)


def test_five_gat_train_steps_match_jax():
    """The slice as a whole: the same attention graph, parameters, X, y and
    mask; optax.adam(1e-2) against torch.optim.Adam(lr=1e-2)."""
    g = _gat_graph()
    X, y, mask = _data(g)
    jmodel, params, model = _models(g)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    jstep = j_make_gat_train_step(jmodel, j_prepare_attention(jax_graph(g)),
                                  opt)
    Xj, yj, mj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask)
    ref_losses = []
    for _ in range(5):
        params, state, loss = jstep(params, state, Xj, yj, mj)
        ref_losses.append(float(loss))

    step = make_gat_train_step(model, prepare_attention(g, device="cpu"),
                               torch.optim.Adam(model.parameters(), lr=1e-2))
    Xt, yt, mt = (torch.from_numpy(a) for a in (X, y, mask))
    losses = [float(step(Xt, yt, mt)) for _ in range(5)]

    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for name in ("W1", "a1s", "a1d", "W2", "a2s", "a2d"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
