"""GAT's edge scores and softmax on the dynamic plan
(``DynEllPlan.edge_attention``, ``ops/edge_softmax.py``) on the CPU,
where the wrappers take their plain versions: the forward and both
gradients against the JAX package's ``gat_head`` scores and
``edge_softmax`` (``jax.grad``), on graphs with rows longer than the
kernel's 256-edge chunk, rows of one edge, empty rows and both signs of
the scores; the backward's formulas against autograd of the plain
composition in float64; the plan's row and column runs that the kernels
read; and what the wrappers refuse.  The kernels themselves are held to
the plain versions in ``tests/test_torch_cuda.py`` (marker ``cuda``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.models import prepare_attention as j_prepare_attention
from flex_tpu.models.gat import edge_softmax as j_edge_softmax

from flex_tpu_torch.io import community_graph
from flex_tpu_torch.ops import edge_softmax as es
from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell
from flex_tpu_torch.sparse.csr import CSRGraph
from test_torch_ell import jax_graph

SLOPE = 0.2


def long_and_single_rows(seed=0, m=700):
    """Rows of 1000, 257, 256 and 255 edges, rows of one edge, empty rows
    and rows of up to 40 edges; column 0 of 400 edges."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, m)
    deg[:4] = (1000, 257, 256, 255)
    deg[4:40] = 1
    deg[40:60] = 0
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(1, m, len(rows))
    cols[rng.choice(len(rows), 400, replace=False)] = 0  # a long column
    return CSRGraph.from_coo(rows, cols, np.ones(len(rows), np.float32), m,
                             name="long_and_single")


GRAPHS = {"long_and_single": long_and_single_rows,
          "community": lambda: community_graph(500, 8000, n_comm=4, seed=1)}


def _scores(g, seed):
    """s_src, s_dst and a cotangent; s_dst shifted so that z takes both
    signs."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((2, g.m)) * 3).astype(np.float32)
    w = rng.standard_normal(g.nnz).astype(np.float32)
    return s[0], s[1] - 0.5, w


def _jax(g, s_src, s_dst, w):
    jag = j_prepare_attention(jax_graph(g))

    def alpha(a, b):
        e = jax.nn.leaky_relu(a[jag.rows] + b[jag.cols], SLOPE)
        return j_edge_softmax(jag, e)

    al = alpha(jnp.asarray(s_src), jnp.asarray(s_dst))
    grads = jax.grad(lambda a, b: (alpha(a, b) * w).sum(), argnums=(0, 1))(
        jnp.asarray(s_src), jnp.asarray(s_dst))
    return np.asarray(al), *(np.asarray(x) for x in grads)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_attention_on_cpu_is_plain_and_matches_jax(name):
    g = GRAPHS[name]()
    plan = prepare_dyn_ell(g, device="cpu")
    s_src, s_dst, w = _scores(g, 1)
    z = s_src[np.repeat(np.arange(g.m), g.degrees)] + s_dst[g.col]
    assert (z > 0).any() and (z < 0).any()
    a = torch.from_numpy(s_src).requires_grad_()
    b = torch.from_numpy(s_dst).requires_grad_()
    fwd, bwd = es.edge_attention_rows, es.edge_attention_rows_bwd
    before = (fwd.launches, fwd.plain_calls, bwd.launches, bwd.plain_calls)
    alpha = plan.edge_attention(a, b, SLOPE)
    (alpha * torch.from_numpy(w)).sum().backward()
    assert (fwd.launches, fwd.plain_calls, bwd.launches,
            bwd.plain_calls) == (before[0], before[1] + 1, before[2],
                                 before[3] + 1)
    r_alpha, r_a, r_b = _jax(g, s_src, s_dst, w)
    np.testing.assert_allclose(alpha.detach().numpy(), r_alpha, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(a.grad.numpy(), r_a, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), r_b, rtol=1e-4, atol=1e-5)
    # a row of one edge weighs it 1, exactly
    single = g.row_ptr[:-1][g.degrees == 1]
    assert np.all(alpha.detach().numpy()[single] == 1.0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_backward_formulas_are_autograd_of_the_plain_forward(name):
    """In float64 the plain backward's formulas (the kernel's) and
    autograd through the plain composition agree to rounding."""
    g = GRAPHS[name]()
    plan = prepare_dyn_ell(g, device="cpu")
    s_src, s_dst, w = (torch.from_numpy(x).double() for x in _scores(g, 2))
    a = s_src.clone().requires_grad_()
    b = s_dst.clone().requires_grad_()
    alpha = es.edge_attention_plain(plan, a, b, SLOPE)
    (alpha * w).sum().backward()
    d_src, d_dst = es.edge_attention_bwd_plain(plan, alpha.detach(), w,
                                               s_src, s_dst, SLOPE)
    np.testing.assert_allclose(d_src.numpy(), a.grad.numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(d_dst.numpy(), b.grad.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_plan_keeps_the_row_and_column_runs():
    """row_ptr is the CSR's; col_ptr cuts the transposed order (perm)
    into the columns' runs, each column's edges in CSR order; long_rows
    and long_cols list the runs longer than a warp's 256 edges."""
    g = long_and_single_rows()
    plan = prepare_dyn_ell(g, device="cpu")
    assert plan.row_ptr.dtype == plan.col_ptr.dtype == torch.int32
    np.testing.assert_array_equal(plan.row_ptr.numpy(), g.row_ptr)
    col_ptr, perm = plan.col_ptr.numpy(), plan.perm.numpy()
    col_deg = np.bincount(g.col, minlength=g.n)
    np.testing.assert_array_equal(np.diff(col_ptr), col_deg)
    for j in (0, 1, g.n // 2, g.n - 1):
        run = perm[col_ptr[j]:col_ptr[j + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(g.col == j))
    assert es.WARP_EDGES == 256
    assert plan.long_rows.dtype == plan.long_cols.dtype == torch.int32
    assert plan.long_rows.tolist() == [0, 1]   # 1000 and 257 edges
    np.testing.assert_array_equal(plan.long_cols.numpy(),
                                  np.flatnonzero(col_deg > 256))
    assert plan.long_cols.shape[0] == 1


def test_edge_attention_refuses_a_wrong_shape_dtype_or_device():
    g = long_and_single_rows()
    plan = prepare_dyn_ell(g, device="cpu")
    s = torch.zeros(g.m)
    with pytest.raises(ValueError, match=r"s_src must have shape"):
        plan.edge_attention(torch.zeros(g.m + 1), s)
    with pytest.raises(ValueError, match=r"s_dst must have shape"):
        plan.edge_attention(s, torch.zeros((g.m, 1)))
    with pytest.raises(ValueError, match="float32"):
        plan.edge_attention(s.double(), s)
    with pytest.raises(ValueError, match="lies on meta"):
        plan.edge_attention(s, torch.zeros(g.m, device="meta"))
    alpha = torch.zeros(g.nnz)
    with pytest.raises(ValueError, match=r"g_alpha must have shape"):
        es.edge_attention_rows_bwd(plan, alpha, alpha[1:], s, s, SLOPE)
