"""ELL forward of the PyTorch port against the JAX package: identical
bucket tables on the same graph, outputs within f32 round-off of the JAX
plan and passing res_check against SciPy."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.sparse.csr import CSRGraph as JCSRGraph

from flex_tpu_torch import spmm
from flex_tpu_torch.convert import ell_plan_from_numpy
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.ops.ell_spmm import prepare_ell
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check


def jax_graph(g):
    return JCSRGraph.from_arrays(g.row_ptr, g.col, g.vals, name=g.name)


def jax_ell_dict(p) -> dict:
    """A JAX EllPlan's fields as NumPy arrays (``convert``'s input)."""
    return {
        "m": p.m, "nnz": p.nnz, "padded_nnz": p.padded_nnz,
        "buckets": [(np.asarray(c), np.asarray(v)) for c, v in p.buckets],
        "chunk_row": np.asarray(p.chunk_row),
        "chunk1": None if p.chunk1 is None else np.asarray(p.chunk1),
        "extras": None if p.extras is None
        else tuple(np.asarray(e) for e in p.extras),
    }


def assert_same_ell(port, ref: dict):
    assert port.m == ref["m"] and port.nnz == ref["nnz"]
    assert port.padded_nnz == ref["padded_nnz"]
    assert len(port.buckets) == len(ref["buckets"])
    for (c, v), (rc, rv) in zip(port.buckets, ref["buckets"]):
        assert c.dtype == torch.int32 and v.dtype == torch.float32
        np.testing.assert_array_equal(c.numpy(), rc)
        np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(port.chunk_row.numpy(), ref["chunk_row"])
    if ref["chunk1"] is None:
        assert port.chunk1 is None
    else:
        np.testing.assert_array_equal(port.chunk1.numpy(), ref["chunk1"])
    if ref["extras"] is None:
        assert port.extras is None
    else:
        for e, re_ in zip(port.extras, ref["extras"]):
            np.testing.assert_array_equal(e.numpy(), re_)


def hub_graph_with_empty_rows(seed=3, m=6000):
    """Rows longer than the widest bucket (2048: split chunks, non-empty
    extras), many empty rows, and a dense block; duplicate-free."""
    rng = np.random.default_rng(seed)
    blk_cols = np.argsort(rng.random((256, 128)), axis=1)[:, :80]
    rows = np.concatenate([
        np.repeat(np.arange(256), 80),
        np.full(3000, 300), np.full(4500, 301),
        np.repeat(np.arange(1000, m), 2),
    ])
    cols = np.concatenate([
        blk_cols.ravel(),
        np.sort(rng.choice(m, 3000, replace=False)),
        np.sort(rng.choice(m, 4500, replace=False)),
        rng.integers(0, m, (m - 1000) * 2),
    ])
    key = np.unique(rows.astype(np.int64) * m + cols)
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    return CSRGraph.from_coo(key // m, key % m, vals, m, name="hub")


def dup_graph():
    """Duplicate (row, col) entries, which must sum (as in
    tests/test_duplicates.py)."""
    rng = np.random.default_rng(0)
    m = 700
    rows = rng.integers(0, m, 8_000)
    cols = rng.integers(0, m, 8_000)
    rows = np.concatenate([rows, rows[:3000]])
    cols = np.concatenate([cols, cols[:3000]])
    vals = (2 * rng.random(len(rows)) - 1).astype(np.float32)
    order = np.lexsort((cols, rows))
    row_ptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    return CSRGraph.from_arrays(row_ptr, cols[order], vals[order], name="dups")


GRAPHS = {
    "hub": hub_graph_with_empty_rows,
    "community_rbdeg": lambda: reorder(
        community_graph(3000, 200_000, n_comm=6, seed=5), "rbdeg"),
    "dups": dup_graph,
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_tables_match_jax(name):
    g = GRAPHS[name]()
    port = prepare_ell(g, device="cpu")
    assert_same_ell(port, jax_ell_dict(j_prepare_ell(jax_graph(g))))
    if name == "hub":
        assert g.degrees.max() > 2048 and (g.degrees == 0).any()
        assert port.extras is not None and len(port.extras[0]) >= 2


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_matches_jax_and_scipy(name, k):
    g = GRAPHS[name]()
    B = make_features(g, k)
    C = prepare_ell(g, device="cpu")(torch.from_numpy(B)).numpy()
    C_jax = np.asarray(j_prepare_ell(jax_graph(g))(jnp.asarray(B)))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def test_ell_convert_computes_like_jax():
    g = hub_graph_with_empty_rows()
    B = make_features(g, 32)
    jplan = j_prepare_ell(jax_graph(g))
    plan = ell_plan_from_numpy(jax_ell_dict(jplan), "cpu")
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


def test_ell_into_and_sub_batches():
    """``into=`` adds in place; a small ``max_gather_rows`` (many sub-batches
    per bucket) gives the same result; the chunk scatter-add assembly
    (no chunk1) agrees with the gather assembly."""
    g = hub_graph_with_empty_rows()
    B = torch.from_numpy(make_features(g, 8))
    plan = prepare_ell(g, device="cpu")
    C = plan(B)
    base = torch.ones((g.m, 8))
    out = plan(B, into=base)
    assert out.data_ptr() == base.data_ptr()
    torch.testing.assert_close(out, C + 1, rtol=1e-6, atol=1e-6)
    plan.max_gather_rows = 1000
    torch.testing.assert_close(plan(B), C, rtol=1e-6, atol=1e-6)
    plan.chunk1 = plan.extras = None
    torch.testing.assert_close(plan(B), C, rtol=1e-5, atol=1e-5)


def test_spmm_dispatch_on_cpu():
    g = dup_graph()
    B = make_features(g, 8)
    gold = spmm(g, B, method="ref")
    C = spmm(g, B, method="ell", device="cpu")
    assert C.device.type == "cpu"
    assert res_check(gold, C.numpy(), g.degrees).ok
    with pytest.raises(ValueError):
        spmm(g, B, method="band", device="cpu")


def test_ell_empty_graph():
    g = CSRGraph.from_arrays(np.zeros(5, np.int64), [], [])
    plan = prepare_ell(g, device="cpu")
    assert plan.buckets == () and plan.chunk1 is None
    assert torch.count_nonzero(plan(torch.ones((4, 3)))) == 0
