"""Row-sharded plans of the PyTorch port (``flex_tpu_torch.parallel``)
against the JAX package's on the CPU: the port's shards run in one process
on a mesh of ``cpu`` entries, the JAX plans on ``make_mesh(D)`` of the 8
virtual CPU devices (tests/conftest.py).  The row bounds, every shard's
buckets under the common ``bucket_alloc``, ``stats`` and
``ici_bytes_per_call`` equal the JAX plan's; outputs agree at rtol = atol
= 1e-5 and pass res_check against SciPy; gradients agree with
``jax.grad`` at 1e-4.  The sharded windowed plan keeps each shard's own
step count (the JAX package pads every shard to the most steps), so its
dense arrays equal the JAX plan's real steps and ``dense_bytes`` counts
those only."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.io.synth import uniform_graph as j_uniform_graph
from flex_tpu.parallel import make_mesh as j_make_mesh
from flex_tpu.parallel import prepare_ell_sharded as j_prepare_ell_sharded
from flex_tpu.parallel import (
    prepare_windowed_sharded as j_prepare_windowed_sharded,
)
from flex_tpu.parallel.spmm_sharded import (
    _split_rows_by_nnz as j_split_rows_by_nnz,
)

from flex_tpu_torch.io import community_graph, make_features, rmat_graph
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.parallel import (
    Mesh, ShardedEllPlan, ShardedWindowedPlan, make_mesh, prepare_ell_sharded,
    prepare_windowed_sharded,
)
from flex_tpu_torch.parallel.spmm_sharded import (
    SHARDED_WIDTHS, _split_rows_by_nnz, mesh_shard_devices,
)
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import dup_graph, hub_graph_with_empty_rows, jax_graph

needs_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIN_KW = dict(tm=256, W=128, min_count=16)


def _rmat():
    return rmat_graph(2048, 32768, seed=3, name="small_rmat")


def _community():
    return reorder(community_graph(4000, 300_000, n_comm=4, seed=8), "rbdeg",
                   check=False)


GRAPHS = {"rmat": _rmat, "hub": hub_graph_with_empty_rows, "dups": dup_graph}


def _mesh(D):
    return make_mesh(D, device="cpu")


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_split_rows_by_nnz_matches_jax(name, D):
    g = GRAPHS[name]()
    assert _split_rows_by_nnz(g, D) == j_split_rows_by_nnz(g, D)


def test_mesh_and_shard_devices():
    """A mesh of torch devices with the JAX mesh's ``shape``; the rows of a
    2-D mesh shard over "x", each shard on the devices of its row."""
    m1 = _mesh(4)
    assert m1.shape == {"x": 4} and m1.size == 4
    assert all(d == torch.device("cpu") for d in m1.devices)
    m2 = Mesh(np.asarray(m1.devices).reshape(2, 2), ("x", "y"))
    assert m2.shape == {"x": 2, "y": 2}
    of_shard, of_pos = mesh_shard_devices(m2, "x", 2)
    assert sorted(of_shard) == [0, 1] and len(of_shard[0]) == 2
    assert of_pos == {(0, 0): 0, (0, 1): 0, (1, 0): 1, (1, 1): 1}
    with pytest.raises(ValueError):
        mesh_shard_devices(m2, "x", 3)
    with pytest.raises(ValueError):
        Mesh(m1.devices, ("x", "y"))
    with pytest.raises(RuntimeError):   # no card here: CUDA raises
        make_mesh(2)


def _jax_buckets(jplan):
    return [(np.asarray(c), np.asarray(v)) for c, v in jplan.buckets]


def assert_same_shards(plan: ShardedEllPlan, jplan):
    assert plan.row_bounds == jplan.row_bounds
    assert plan.m_shard_pad == jplan.m_shard_pad
    assert plan.nnz == jplan.nnz and plan.padded_nnz == jplan.padded_nnz
    jb = _jax_buckets(jplan)
    jcr = np.asarray(jplan.chunk_row)
    for d, p in enumerate(plan.plans):
        assert len(p.buckets) == len(jb)
        for (c, v), (jc, jv) in zip(p.buckets, jb):
            np.testing.assert_array_equal(c.numpy(), jc[d])
            np.testing.assert_array_equal(v.numpy(), jv[d])
        np.testing.assert_array_equal(p.chunk_row.numpy(), jcr[d])


@needs_8dev
@pytest.mark.parametrize("layout", ["replicated", "gathered"])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_sharded_ell_matches_jax(name, D, layout):
    g = GRAPHS[name]()
    plan = prepare_ell_sharded(g, _mesh(D), b_layout=layout)
    jplan = j_prepare_ell_sharded(jax_graph(g), j_make_mesh(D),
                                  b_layout=layout)
    assert_same_shards(plan, jplan)
    st, jst = plan.stats, jplan.stats
    assert st == {**jst, "bucket_shapes": [tuple(s)
                                           for s in jst["bucket_shapes"]]}
    k = 16
    for kk in (k, 41):
        assert plan.ici_bytes_per_call(g.n, kk) == \
            jplan.ici_bytes_per_call(g.n, kk)
    B = make_features(g, k)
    C = plan(torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(C, np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).ok
    # the per-shard row blocks, without the final copy
    outs = plan.shard_outputs(torch.from_numpy(B))
    assert [o.shape[0] for o in outs] == [r1 - r0 for r0, r1 in
                                          plan.row_bounds]
    np.testing.assert_array_equal(torch.cat(outs).numpy(), C)


def test_gathered_layout_takes_column_shards():
    """Under "gathered" B may arrive as its column shards (one per shard
    device); every shard's device concatenates the copies."""
    g = _rmat()
    plan = prepare_ell_sharded(g, _mesh(4), b_layout="gathered")
    rep = prepare_ell_sharded(g, _mesh(4))
    B = torch.from_numpy(make_features(g, 12))
    np.testing.assert_array_equal(plan(list(B.tensor_split(4, dim=1))).numpy(),
                                  rep(B).numpy())
    assert rep.ici_bytes_per_call(g.n, 12) == 0
    assert plan.ici_bytes_per_call(g.n, 12) == g.n * 12 * 4 * 3 // 4
    with pytest.raises(ValueError, match="column shards"):
        plan(list(B.tensor_split(3, dim=1)))
    with pytest.raises(ValueError, match="b_layout"):
        prepare_ell_sharded(g, _mesh(2), b_layout="scattered")


@needs_8dev
@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("layout", ["replicated", "gathered"])
def test_sharded_ell_grad_matches_jax(layout, bwd):
    """d/dB sum((A·B)²) through the sharded plan against ``jax.grad`` of
    the JAX plan (and 2·Aᵀ·(A·B)); with ``with_bwd_plan`` each shard's g_B
    runs the transposed pattern's forward."""
    g = _rmat()
    plan = prepare_ell_sharded(g, _mesh(4), b_layout=layout)
    if bwd:
        plan = plan.for_training()
        assert all(p.bwd_plan is not None for p in plan.plans)
    jplan = j_prepare_ell_sharded(jax_graph(g), j_make_mesh(4),
                                  b_layout=layout)
    B = make_features(g, 8)
    Bt = torch.from_numpy(B).requires_grad_()
    (plan(Bt) ** 2).sum().backward()
    want = jax.grad(lambda b: (jplan(b) ** 2).sum())(jnp.asarray(B))
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    A = g.to_scipy()
    np.testing.assert_allclose(Bt.grad.numpy(), 2.0 * (A.T @ (A @ B)),
                               rtol=2e-4, atol=2e-3)


def _assert_same_windowed(plan: ShardedWindowedPlan, jplan):
    assert plan.row_bounds == jplan.row_bounds
    assert plan.m_shard_pad == jplan.m_shard_pad
    assert plan.shard_sel == jplan.shard_sel
    assert plan.res_shard_nnz == jplan.res_shard_nnz
    st, jst = plan.stats, jplan.stats
    for key in ("n_shards", "coverage", "S_max", "n_res", "impl",
                "res_imbalance", "min_count_eff"):
        assert st[key] == jst[key], key
    # no pad steps: the real steps' bytes, which JAX's padded array bounds
    assert st["dense_bytes"] == sum(b for b, _, _ in plan.shard_sel)
    assert st["dense_bytes"] <= jst["dense_bytes"]
    A = np.asarray(jplan.A)
    for d, p in enumerate(plan.plans):
        S = p.A.shape[0]
        np.testing.assert_array_equal(p.A.numpy(), A[d, :S])
        assert not A[d, S:].any()   # JAX's pad steps are zero
    assert_same_shards(plan.ell, jplan.ell)


@needs_8dev
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_windowed_matches_jax(D):
    g = _community()
    plan = prepare_windowed_sharded(g, _mesh(D), **WIN_KW)
    jplan = j_prepare_windowed_sharded(jax_graph(g), j_make_mesh(D),
                                       **WIN_KW)
    assert plan.stats["n_shards"] == D and "res_imbalance" in plan.stats
    _assert_same_windowed(plan, jplan)
    B = make_features(g, 16)
    C = plan(torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(C, np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).ok


@needs_8dev
def test_sharded_windowed_budgeted_per_shard():
    """``max_dense_bytes`` is a per-shard budget: each shard's selection
    coarsens to fit, as in the JAX plan (tests/test_sharded.py:182-200)."""
    g = _community()
    free = prepare_windowed_sharded(g, _mesh(4), **WIN_KW)
    budget = max(b for b, _, _ in free.shard_sel) // 2
    plan = prepare_windowed_sharded(g, _mesh(4), max_dense_bytes=budget,
                                    **WIN_KW)
    jplan = j_prepare_windowed_sharded(jax_graph(g), j_make_mesh(4),
                                       max_dense_bytes=budget, **WIN_KW)
    assert all(b <= budget for b, _, _ in plan.shard_sel)
    assert any(mc > 16 for _, mc, _ in plan.shard_sel)
    assert plan.stats["coverage"] < free.stats["coverage"]
    _assert_same_windowed(plan, jplan)
    B = make_features(g, 16)
    C = plan(torch.from_numpy(B)).numpy()
    assert res_check(spmm_scipy(g, B), C, g.degrees).ok


@needs_8dev
def test_sharded_windowed_refuses_scattered():
    """Coverage under ``min_coverage``: both packages refuse."""
    jg = j_uniform_graph(20_000, 60_000, seed=1)
    g = CSRGraph.from_arrays(np.asarray(jg.row_ptr), np.asarray(jg.col),
                             np.asarray(jg.vals))
    with pytest.raises(ValueError, match="coverage"):
        prepare_windowed_sharded(g, _mesh(2), min_count=64)
    with pytest.raises(ValueError, match="coverage"):
        j_prepare_windowed_sharded(jg, j_make_mesh(2), min_count=64)


@needs_8dev
@pytest.mark.parametrize("bwd", [False, True])
def test_sharded_windowed_grad_matches_jax(bwd):
    """g_B of (plan(X·Wt)²).sum() through the sharded windowed plan against
    ``jax.grad`` of the JAX plan (as ``__graft_entry__.py`` differentiates
    it); with ``with_training_bwd`` every shard's residue g_B runs its
    transposed plan."""
    g = _community()
    plan = prepare_windowed_sharded(g, _mesh(4), **WIN_KW)
    if bwd:
        plan = plan.for_training()
        assert all(p.ell.bwd_plan is not None for p in plan.plans)
    jplan = j_prepare_windowed_sharded(jax_graph(g), j_make_mesh(4),
                                       **WIN_KW)
    X = make_features(g, 16)
    Wt = np.random.default_rng(2).standard_normal((16, 16)).astype(
        np.float32) / 4
    Wg = torch.from_numpy(Wt).requires_grad_()
    (plan(torch.from_numpy(X) @ Wg) ** 2).sum().backward()
    want = jax.grad(lambda w: (jplan(jnp.asarray(X) @ w) ** 2).sum())(
        jnp.asarray(Wt))
    np.testing.assert_allclose(Wg.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    # g_B itself against SciPy's Aᵀ·co
    co = np.random.default_rng(3).standard_normal((g.m, 16)).astype(
        np.float32)
    Bt = torch.from_numpy(X).requires_grad_()
    (plan(Bt) * torch.from_numpy(co)).sum().backward()
    A = g.to_scipy()
    col_deg = np.bincount(g.col, minlength=g.n)
    assert res_check(A.T @ co, Bt.grad.numpy(), col_deg).ok


def test_sharded_plans_of_every_width_ladder():
    """The sharded ELL plan with its own width ladder; every shard's plan
    on its home device."""
    g = _rmat()
    plan = prepare_ell_sharded(g, _mesh(3), widths=(4, 32, 256))
    assert [c.shape[1] for c, _ in plan.plans[0].buckets] == [4, 32, 256]
    assert plan.devices == (torch.device("cpu"),) * 3
    assert SHARDED_WIDTHS[-1] == 2048
    B = make_features(g, 8)
    assert res_check(spmm_scipy(g, B), plan(torch.from_numpy(B)).numpy(),
                     g.degrees).ok
