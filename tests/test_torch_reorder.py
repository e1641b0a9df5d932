"""The orderings the earlier slices left out (deg, rcm, dfs, gorder) and
the ordering file I/O, against the JAX package on the same graphs: every
``compute_order`` perm equals the JAX package's, and the C++ dfs and
gorder of the port equal its Python loops.

The JAX side runs its Python loops (``use_native=False``): its C++ build
writes the library straight to its final path, so a test process that
loads it while another builds it would see a partial file.  The port's
own build is atomic, and its default dispatch takes the C++ version."""
import numpy as np
import pytest

import flex_tpu.io.synth as jsynth
import flex_tpu.reorder as jreorder
from flex_tpu.reorder.deg import order_deg as j_order_deg
from flex_tpu.reorder.dfs import order_dfs as j_order_dfs
from flex_tpu.reorder.gorder import order_gorder as j_order_gorder
from flex_tpu.reorder.inout import load_order as j_load_order

import flex_tpu_torch.io.synth as tsynth
import flex_tpu_torch.reorder as treorder
from flex_tpu_torch.reorder import native
from flex_tpu_torch.reorder.deg import order_deg
from flex_tpu_torch.reorder.dfs import order_dfs
from flex_tpu_torch.reorder.gorder import order_gorder
from flex_tpu_torch.reorder.inout import load_order, save_order
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.perm import invert_permutation

GRAPHS = {
    # the small_rmat fixture of the JAX package's tests
    "small_rmat": ("rmat_graph", dict(m=2048, nnz_target=32768, seed=3)),
    "community": ("community_graph", dict(m=1024, nnz_target=30_000,
                                          n_comm=3, seed=1, shuffle=False)),
    "hub": ("hub_graph", dict(m=3000, nnz_target=40_000, n_hub_cols=64,
                              seed=1)),
    "tiny": ("rmat_graph", dict(m=48, nnz_target=300, seed=1)),
}
# the Python gorder loop takes seconds on the larger graphs
GORDER_GRAPHS = ("community", "tiny")
JAX_KW = {"dfs": dict(use_native=False), "gorder": dict(use_native=False)}


def _graphs(name):
    fn, kw = GRAPHS[name]
    return getattr(tsynth, fn)(**kw), getattr(jsynth, fn)(**kw)


def _assert_same_graph(a, b):
    for f in ("row_ptr", "col", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.order == b.order


def test_order_abbr_matches_jax():
    assert treorder.ORDER_ABBR == jreorder.ORDER_ABBR


@pytest.mark.parametrize("name,method", [
    (name, method) for method in ("deg", "rcm", "dfs") for name in GRAPHS
] + [(name, "gorder") for name in GORDER_GRAPHS])
def test_order_matches_jax(name, method):
    g_t, g_j = _graphs(name)
    perm = treorder.compute_order(g_t, method)
    np.testing.assert_array_equal(
        perm, jreorder.compute_order(g_j, method, **JAX_KW.get(method, {})))
    invert_permutation(perm)  # a bijection
    _assert_same_graph(
        treorder.reorder(g_t, method),
        jreorder.reorder(g_j, method, **JAX_KW.get(method, {})))


@pytest.mark.parametrize("desc", [True, False])
def test_deg_order_matches_jax_both_ways(desc):
    g_t, g_j = _graphs("hub")
    perm = order_deg(g_t, desc=desc)
    np.testing.assert_array_equal(perm, j_order_deg(g_j, desc=desc))
    d = g_t.degrees[perm]
    assert np.all(np.diff(d) <= 0) if desc else np.all(np.diff(d) >= 0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dfs_native_matches_python(name):
    g_t, g_j = _graphs(name)
    assert native.available()
    nat = order_dfs(g_t, use_native=True)
    np.testing.assert_array_equal(nat, order_dfs(g_t, use_native=False))
    np.testing.assert_array_equal(nat, j_order_dfs(g_j, use_native=False))


@pytest.mark.parametrize("name", GORDER_GRAPHS)
@pytest.mark.parametrize("window", [3, 5])
def test_gorder_native_matches_python(name, window):
    g_t, g_j = _graphs(name)
    nat = order_gorder(g_t, window=window, use_native=True)
    np.testing.assert_array_equal(
        nat, order_gorder(g_t, window=window, use_native=False))
    np.testing.assert_array_equal(
        nat, j_order_gorder(g_j, window=window, use_native=False))


def test_gorder_native_is_a_bijection_on_small_rmat():
    g_t, _ = _graphs("small_rmat")
    invert_permutation(order_gorder(g_t, use_native=True))


def test_orderings_of_a_graph_with_empty_rows_and_components():
    """Isolated vertices and several components: DFS restarts at the
    lowest unvisited vertex, gorder appends the isolates."""
    rows = np.array([0, 1, 1, 5, 6, 6, 9])
    cols = np.array([1, 0, 2, 6, 5, 9, 6])
    g = CSRGraph.from_coo(rows, cols, np.ones(7, np.float32), 12)
    from flex_tpu.sparse.csr import CSRGraph as JCSRGraph

    gj = JCSRGraph.from_coo(rows, cols, np.ones(7, np.float32), 12)
    for method in ("deg", "rcm", "dfs", "gorder"):
        perm = treorder.compute_order(g, method)
        np.testing.assert_array_equal(perm, jreorder.compute_order(
            gj, method, **JAX_KW.get(method, {})), err_msg=method)
        invert_permutation(perm)
    for use_native in (True, False):
        assert order_gorder(CSRGraph.from_coo(
            [], [], np.zeros(0, np.float32), 0), use_native=use_native
        ).shape == (0,)


def test_unknown_ordering_names_itself():
    g_t, _ = _graphs("tiny")
    with pytest.raises(ValueError, match="nope"):
        treorder.compute_order(g_t, "nope")


def test_order_file_roundtrip(tmp_path):
    g_t, _ = _graphs("community")
    perm = treorder.compute_order(g_t, "rcm")
    save_order(perm, str(tmp_path / "rcm"))
    got = load_order(str(tmp_path / "rcm.npy"))
    np.testing.assert_array_equal(got, perm)
    assert got.dtype == np.int64
    # the JAX package reads the same file
    np.testing.assert_array_equal(j_load_order(str(tmp_path / "rcm")), perm)


def test_load_order_rejects_a_non_permutation(tmp_path):
    np.save(tmp_path / "bad.npy", np.array([0, 0, 2], np.int64))
    with pytest.raises(ValueError):
        load_order(str(tmp_path / "bad"))
