"""GE-SpMM of the PyTorch port against the JAX package: identical chunk
tables from the device build, the partials' plain version and whole plans
against the JAX plan with its Pallas kernel in interpret mode
(rtol=atol=1e-5: f32 sums in another order), and the port's own plans
against SciPy under res_check.  The CUDA kernel itself runs only on a
card: tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.ops.gespmm import prepare_gespmm as j_prepare_gespmm

from flex_tpu_torch.convert import gespmm_plan_from_numpy
from flex_tpu_torch.io import make_features, rmat_graph
from flex_tpu_torch.ops.gespmm import (
    CH, gespmm_partials, gespmm_partials_plain, prepare_gespmm,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import dup_graph, jax_graph


def _long_rows_and_empties():
    """A zero-degree head and tail, a row of exactly w, one of w + 1 and one
    of several chunks."""
    rng = np.random.default_rng(5)
    deg = rng.integers(0, 20, 300)
    deg[[0, 1, 2, 3, 299]] = (0, 8, 9, 100, 0)
    rows = np.repeat(np.arange(300), deg)
    key = np.unique(rows * 300 + rng.integers(0, 300, len(rows)))
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    return CSRGraph.from_coo(key // 300, key % 300, vals, 300, name="long")


GRAPHS = {
    "rmat2048": lambda: rmat_graph(2048, 32768, seed=3),
    "rmat500": lambda: rmat_graph(500, 6000, seed=3),
    "long_rows": _long_rows_and_empties,
    "dups": dup_graph,
}


def jax_gespmm_dict(p) -> dict:
    """A JAX GeSpmmPlan's fields as NumPy arrays (``convert``'s input)."""
    return {"m": p.m, "w": p.w, "cols": np.asarray(p.cols),
            "vals": np.asarray(p.vals), "chunk_row": np.asarray(p.chunk_row),
            "nnz": p.nnz, "padded_nnz": p.padded_nnz}


@pytest.mark.parametrize("w", [8, 32])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gespmm_tables_match_jax(name, w):
    g = GRAPHS[name]()
    plan = prepare_gespmm(g, w=w, device="cpu")
    ref = jax_gespmm_dict(j_prepare_gespmm(jax_graph(g), w=w))
    assert (plan.cols.dtype, plan.vals.dtype, plan.chunk_row.dtype) == (
        torch.int32, torch.float32, torch.int32)
    np.testing.assert_array_equal(plan.cols.numpy(), ref["cols"])
    np.testing.assert_array_equal(plan.vals.numpy(), ref["vals"])
    np.testing.assert_array_equal(plan.chunk_row.numpy(), ref["chunk_row"])
    assert (plan.m, plan.w, plan.nnz, plan.padded_nnz) == (
        ref["m"], ref["w"], ref["nnz"], ref["padded_nnz"])
    assert plan.cols.shape[0] % CH == 0
    assert plan.stats["pad_ratio"] >= 1.0


@pytest.mark.parametrize("k", [8, 41])
@pytest.mark.parametrize("name,w", [("rmat500", 8), ("long_rows", 8),
                                    ("rmat500", 32)])
def test_gespmm_convert_computes_like_jax(name, w, k):
    """The JAX plan (Pallas kernel in interpret mode, as its own tests run
    it) and the port's plan on the JAX plan's arrays."""
    g = GRAPHS[name]()
    B = make_features(g, k)
    jplan = j_prepare_gespmm(jax_graph(g), w=w)
    assert jplan.interpret
    plan = gespmm_plan_from_numpy(jax_gespmm_dict(jplan), "cpu")
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gespmm_matches_scipy(name, k):
    g = GRAPHS[name]()
    B = make_features(g, k)
    C = prepare_gespmm(g, w=16, device="cpu")(torch.from_numpy(B)).numpy()
    assert C.shape == (g.m, k)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0
    assert np.all(C[g.degrees == 0] == 0.0)


def test_gespmm_partials_sub_batches_and_wrapper():
    """The plain version in sub-batches equals one batch, and the wrapper
    takes it for CPU tensors."""
    plan = prepare_gespmm(GRAPHS["rmat2048"](), w=16, device="cpu")
    B = torch.from_numpy(make_features(GRAPHS["rmat2048"](), 8))
    whole = gespmm_partials_plain(plan.cols, plan.vals, B)
    parts = gespmm_partials_plain(plan.cols, plan.vals, B,
                                  max_gather_rows=16 * 37)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)
    before = gespmm_partials.launches
    torch.testing.assert_close(gespmm_partials(plan.cols, plan.vals, B),
                               whole, rtol=0, atol=0)
    assert gespmm_partials.launches == before  # no kernel on the CPU
    pads = plan.chunk_row == plan.m
    assert not bool(whole[pads].any())


def test_gespmm_zero_nnz_graph():
    g = CSRGraph.from_arrays(np.zeros(5, np.int64), np.zeros(0), np.zeros(0))
    plan = prepare_gespmm(g, device="cpu")
    assert plan.cols.shape == (CH, 32) and plan.padded_nnz == CH * 32
    C = plan(torch.ones((4, 8)))
    assert C.shape == (4, 8) and not bool(C.any())


def test_gespmm_rejects_bad_arguments():
    plan = prepare_gespmm(GRAPHS["rmat500"](), w=8, device="cpu")
    B = torch.ones((plan.m, 4))
    gespmm_partials(plan.cols, plan.vals, B)
    for cols, vals, b in ((plan.cols.long(), plan.vals, B),
                          (plan.cols, plan.vals.double(), B),
                          (plan.cols, plan.vals, B.double()),
                          (plan.cols, plan.vals[:-1], B),
                          (plan.cols.view(-1), plan.vals.view(-1), B),
                          (plan.cols, plan.vals, B[0])):
        with pytest.raises(ValueError):
            gespmm_partials(cols, vals, b)
    with pytest.raises(ValueError, match="no gespmm kernel"):
        gespmm_partials(plan.cols.to("meta"), plan.vals.to("meta"),
                        B.to("meta"))
    with pytest.raises(ValueError, match="width"):
        prepare_gespmm(GRAPHS["rmat500"](), w=0, device="cpu")
