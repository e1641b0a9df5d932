"""The transposed (narrow-k) windowed plan of the PyTorch port against the
JAX package: the Aᵀ step array equal element for element, the kernel's
plain version against the Pallas kernel in interpret mode, whole plans
against the JAX plan and the row-major plan (rtol=atol=1e-5: f32 sums in
another order) and SciPy, and g_B against ``jax.grad`` (rtol=atol=1e-4:
two products and a scatter-add, each summed in another order).  The CUDA
kernel itself runs only on a card: tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.window_spmm import _window_pallas_t_raw
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed

from flex_tpu_torch.convert import windowed_plan_from_numpy
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
    prepare_windowed, window_spmm_t_fwd, window_spmm_t_fwd_plain,
)
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import assert_same_ell, hub_graph_with_empty_rows, jax_graph
from test_torch_windowed import jax_windowed_dict


def _community(m, nnz, n_comm, seed):
    return reorder(community_graph(m, nnz, n_comm=n_comm, seed=seed), "rbdeg")


# the graphs of the JAX package's own transposed tests, and a split residue
CASES = {
    "c3000": (lambda: _community(3000, 300_000, 8, 5),
              dict(tm=256, W=128, J=4, min_count=32)),
    "c2000": (lambda: _community(2000, 150_000, 6, 3),
              dict(tm=128, W=128, J=4, min_count=16)),
    "c1500": (lambda: _community(1500, 120_000, 5, 7),
              dict(tm=128, W=128, J=4, min_count=16)),
    "split_residue": (hub_graph_with_empty_rows,
                      dict(tm=256, W=128, J=8, min_count=256,
                           min_coverage=0.0)),
}


def _jax_t_dict(g, kw) -> dict:
    p = j_prepare_windowed(jax_graph(g), transposed=True, **kw)
    assert p.transposed and p.bwd_tabs is None
    return dict(jax_windowed_dict(p), transposed=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_transposed_build_matches_jax_plan(name):
    make, kw = CASES[name]
    g = make()
    plan = prepare_windowed(g, device="cpu", transposed=True, **kw)
    ref = _jax_t_dict(g, kw)
    S, GW, TM = plan.A.shape
    assert (GW, TM) == (4 * kw["W"], kw["tm"])
    np.testing.assert_array_equal(plan.A.numpy(), ref["A"])
    for key in ("first", "out_panel", "win_step", "row_gather"):
        np.testing.assert_array_equal(getattr(plan, key).numpy(), ref[key],
                                      err_msg=key)
    assert_same_ell(plan.ell, ref["ell"])
    assert plan.transposed and plan.stats["transposed"]
    assert plan.bwd_tabs is None and plan.slot_ptr is None
    assert plan.n_blk_used == 0
    # the row-major build holds the same tiles, transposed
    row = prepare_windowed(g, device="cpu", **kw)
    torch.testing.assert_close(plan.A, row.A.transpose(1, 2), rtol=0, atol=0)
    assert not row.stats["transposed"]


@pytest.mark.parametrize("k", [16, 32, 41])
@pytest.mark.parametrize("name", ["c2000", "c3000"])
def test_plain_t_matches_pallas_interpret(name, k):
    """window_spmm_t_fwd_plain on JAX's own format arrays against
    _window_pallas_t_raw in interpret mode.  The Pallas kernel wants k a
    multiple of 8 and a Bᵀ padded with the sentinel block; the port's
    takes k and Bᵀ as they are."""
    make, kw = CASES[name]
    g = make()
    d = _jax_t_dict(g, kw)
    B = make_features(g, k)
    W, n_panels = d["W"], d["n_used_panels"]
    nblk = -(-g.n // W)
    kt = -(-k // 8) * 8
    B_T = jnp.zeros((kt, (nblk + 1) * W), jnp.float32).at[:k, :g.n].set(B.T)
    ref = np.asarray(_window_pallas_t_raw(
        jnp.asarray(d["first"]), jnp.asarray(d["out_panel"]),
        jnp.asarray(d["win_step"]), jnp.asarray(d["A"]), B_T,
        n_panels=n_panels, W=W, k=kt, precision=jax.lax.Precision.HIGHEST,
        interpret=True))[:k]
    t = windowed_plan_from_numpy(d, "cpu")
    args = (t.first, t.out_panel, t.win_step, t.A,
            torch.from_numpy(np.ascontiguousarray(B.T)))
    out = window_spmm_t_fwd_plain(*args, n_panels=n_panels, W=W)
    assert out.shape == (k, n_panels * d["tm"])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    before = window_spmm_t_fwd.launches
    via = window_spmm_t_fwd(*args, n_panels=n_panels, W=W,
                            panel_step_ptr=t.panel_step_ptr)
    torch.testing.assert_close(via, out, rtol=0, atol=0)
    assert window_spmm_t_fwd.launches == before


@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_transposed_matches_jax_row_major_and_scipy(name, k):
    make, kw = CASES[name]
    g = make()
    B = make_features(g, k)
    Bt = torch.from_numpy(B)
    C = prepare_windowed(g, device="cpu", transposed=True, **kw)(Bt).numpy()
    C_jax = np.asarray(j_prepare_windowed(
        jax_graph(g), transposed=True, **kw)(jnp.asarray(B)))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    C_row = prepare_windowed(g, device="cpu", **kw)(Bt).numpy()
    np.testing.assert_allclose(C, C_row, rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


@pytest.mark.parametrize("name", ["c1500", "split_residue"])
def test_transposed_convert_computes_like_jax(name):
    make, kw = CASES[name]
    g = make()
    B = make_features(g, 32)
    jplan = j_prepare_windowed(jax_graph(g), transposed=True, **kw)
    plan = windowed_plan_from_numpy(
        dict(jax_windowed_dict(jplan), transposed=True), "cpu")
    assert plan.transposed and plan.bwd_tabs is None
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [16, 41])
def test_transposed_grad_matches_jax(k):
    """g_B of (plan(B)**2).sum() against jax.grad on the JAX transposed
    plan, and g_A against the row-major plan's, transposed."""
    g = _community(800, 40_000, 4, 2)
    kw = dict(tm=128, W=128, J=4, min_count=8)
    B = make_features(g, k)
    jplan = j_prepare_windowed(jax_graph(g), transposed=True, **kw)
    gB_jax = jax.grad(lambda p, b: (p(b) ** 2).sum(), argnums=1)(
        jplan, jnp.asarray(B))

    plan = prepare_windowed(g, device="cpu", transposed=True, **kw)
    A = plan.A.clone().requires_grad_()
    Bt = torch.from_numpy(B).requires_grad_()
    (dataclasses.replace(plan, A=A)(Bt) ** 2).sum().backward()
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gB_jax),
                               rtol=1e-4, atol=1e-4)

    row = prepare_windowed(g, device="cpu", **kw)
    A_r = row.A.clone().requires_grad_()
    Br = torch.from_numpy(B).requires_grad_()
    (dataclasses.replace(row, A=A_r)(Br) ** 2).sum().backward()
    torch.testing.assert_close(Bt.grad, Br.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(A.grad, A_r.grad.transpose(1, 2),
                               rtol=1e-4, atol=1e-4)


def test_transposed_refusals():
    make, kw = CASES["c1500"]
    g = make()
    with pytest.raises(ValueError, match="W % 128"):
        prepare_windowed(g, device="cpu", transposed=True, tm=128, W=64, J=4,
                         min_count=8)
    with pytest.raises(ValueError, match="W % 128"):
        j_prepare_windowed(jax_graph(g), transposed=True, tm=128, W=64, J=4,
                           min_count=8)
    plan = prepare_windowed(g, device="cpu", transposed=True, **kw)
    B_T = torch.ones((4, plan.n))
    good = dict(first=plan.first, out_panel=plan.out_panel,
                win_step=plan.win_step, A_T=plan.A, B_T=B_T)
    kws = dict(n_panels=plan.n_used_panels, W=plan.W,
               panel_step_ptr=plan.panel_step_ptr)
    window_spmm_t_fwd(*good.values(), **kws)
    for key, bad in (("first", plan.first.long()), ("B_T", B_T.double()),
                     ("B_T", B_T[0]), ("win_step", plan.win_step[:-1]),
                     ("A_T", plan.A[0])):
        with pytest.raises(ValueError):
            window_spmm_t_fwd(*dict(good, **{key: bad}).values(), **kws)
    with pytest.raises(ValueError):
        window_spmm_t_fwd(*good.values(), **dict(kws, W=96))
    with pytest.raises(ValueError, match="no window kernel"):
        window_spmm_t_fwd(*(t.to("meta") for t in good.values()),
                          n_panels=plan.n_used_panels, W=plan.W,
                          panel_step_ptr=plan.panel_step_ptr.to("meta"))
    with pytest.raises(ValueError, match=r"B must be"):
        plan(torch.ones((plan.n + 1, 4)))
