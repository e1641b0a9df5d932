"""Host layers of the PyTorch port against the JAX package: the same seed
must give the same arrays (synthetic graphs, orderings, features), and the
port must import neither JAX nor ``flex_tpu``."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import flex_tpu.io.synth as jsynth
import flex_tpu.reorder as jreorder
from flex_tpu.io import make_features as j_make_features
from flex_tpu.ops.ref import spmm_scipy as j_spmm_scipy
from flex_tpu.utils.check import res_check as j_res_check

import flex_tpu_torch.io.synth as tsynth
import flex_tpu_torch.reorder as treorder
from flex_tpu_torch.io import make_features
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.reorder.rabbit import order_rabbit
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, rows_from_row_ptr
from flex_tpu_torch.sparse.perm import invert_permutation
from flex_tpu_torch.utils.check import res_check

PORT = pathlib.Path(__file__).resolve().parents[1] / "flex_tpu_torch"

GRAPHS = [
    ("community_graph", dict(m=3000, nnz_target=200_000, n_comm=6, seed=5)),
    ("community_graph", dict(m=1024, nnz_target=30_000, n_comm=3, seed=1,
                             shuffle=False)),
    ("bipartite_projection_graph", dict(m=4000, nnz_target=200_000,
                                        n_comm=6, seed=2)),
]
# the plain generators: power-law, uniform and banded sparsity
PLAIN_GRAPHS = [
    ("rmat_graph", dict(m=2048, nnz_target=32768, seed=3)),
    ("rmat_graph", dict(m=500, nnz_target=6000, seed=3, name="ge")),
    ("rmat_graph", dict(m=1000, nnz_target=9000, a=0.57, b=0.19, c=0.19,
                        seed=1)),
    ("uniform_graph", dict(m=2048, nnz_target=16384, seed=1)),
    ("banded_graph", dict(m=1024, bandwidth=96, avg_degree=12.0, seed=4)),
    ("banded_graph", dict(m=600, bandwidth=64, avg_degree=8.0, seed=7)),
]


def _assert_same_graph(a, b):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.vals, b.vals)
    assert a.row_ptr.dtype == b.row_ptr.dtype and a.col.dtype == b.col.dtype
    assert a.vals.dtype == b.vals.dtype


@pytest.mark.parametrize("fn,kw", GRAPHS + PLAIN_GRAPHS)
def test_synth_matches_jax(fn, kw):
    mine, ref = getattr(tsynth, fn)(**kw), getattr(jsynth, fn)(**kw)
    _assert_same_graph(mine, ref)
    assert mine.name == ref.name


@pytest.mark.parametrize("method", ["ovo", "rabbit", "rbdeg"])
@pytest.mark.parametrize("fn,kw", GRAPHS[::2])
def test_order_matches_jax(fn, kw, method):
    g_t = getattr(tsynth, fn)(**kw)
    g_j = getattr(jsynth, fn)(**kw)
    perm = treorder.compute_order(g_t, method)
    np.testing.assert_array_equal(perm, jreorder.compute_order(g_j, method))
    invert_permutation(perm)  # a bijection
    _assert_same_graph(treorder.reorder(g_t, method),
                       jreorder.reorder(g_j, method))


def test_rabbit_python_matches_native():
    g = tsynth.community_graph(600, 8_000, n_comm=4, seed=3)
    p_nat, l_nat = order_rabbit(g, use_native=True, want_labels=True)
    p_py, l_py = order_rabbit(g, use_native=False, want_labels=True)
    np.testing.assert_array_equal(p_nat, p_py)
    np.testing.assert_array_equal(l_nat, l_py)


@pytest.mark.parametrize("k", [8, 128])
def test_make_features_matches_jax(k):
    g = tsynth.community_graph(1000, 20_000, n_comm=3, seed=2)
    np.testing.assert_array_equal(make_features(g, k),
                                  j_make_features(g, k))


def test_ref_and_check_match_jax():
    g = tsynth.bipartite_projection_graph(2000, 60_000, n_comm=4, seed=1)
    B = make_features(g, 16)
    gold = spmm_scipy(g, B)
    np.testing.assert_array_equal(gold, j_spmm_scipy(g, B))
    bad = gold.copy()
    bad[::7, 3] += 1.0
    mine, ref = res_check(gold, bad, g.degrees), j_res_check(gold, bad,
                                                             g.degrees)
    assert (mine.n_bad, mine.n_total, mine.max_err, mine.err_frac) == (
        ref.n_bad, ref.n_total, ref.max_err, ref.err_frac)
    assert mine.n_bad > 0
    assert res_check(gold, gold, g.degrees).err_frac == 0


def test_device_csr_roundtrip():
    g = tsynth.community_graph(777, 9_000, n_comm=3, seed=4)
    d = DeviceCSR.from_graph(g, "cpu")
    assert d.row_ptr.dtype == torch.int32 and d.col.dtype == torch.int32
    assert d.vals.dtype == torch.float32 and d.device.type == "cpu"
    np.testing.assert_array_equal(d.row_ptr.numpy(), g.row_ptr)
    np.testing.assert_array_equal(d.col.numpy(), g.col)
    np.testing.assert_array_equal(d.vals.numpy(), g.vals)
    rows = rows_from_row_ptr(d.row_ptr, g.nnz, g.m)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.repeat(np.arange(g.m), g.degrees))


def test_device_csr_needs_a_device(monkeypatch):
    g = CSRGraph.from_arrays([0, 1], [0], [1.0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCSR.from_graph(g)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "flex_tpu"), \
                f"{f.relative_to(PORT.parent)} imports {mod}"


@pytest.mark.parametrize("opt_out", [False, True])
def test_tune_host_malloc_matches_jax(monkeypatch, opt_out):
    """``utils.hostmem.tune_host_malloc`` returns the JAX function's value,
    is idempotent, and does nothing when ``FLEX_TPU_NO_MALLOC_TUNE`` is
    set (the package calls it at import, as the JAX package does)."""
    import flex_tpu.utils.hostmem as jhostmem

    import flex_tpu_torch.utils.hostmem as hostmem

    if opt_out:
        monkeypatch.setenv("FLEX_TPU_NO_MALLOC_TUNE", "1")
    else:
        monkeypatch.delenv("FLEX_TPU_NO_MALLOC_TUNE", raising=False)
    monkeypatch.setattr(hostmem, "_done", False)
    monkeypatch.setattr(jhostmem, "_done", False)
    got = hostmem.tune_host_malloc()
    assert got == jhostmem.tune_host_malloc()
    assert got is (not opt_out)
    assert hostmem._done is got
    assert hostmem.tune_host_malloc() is got   # idempotent
