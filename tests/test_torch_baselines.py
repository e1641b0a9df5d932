"""The two baselines without a hand kernel (``"xla"``: gather +
scatter-add; ``"bcoo"``: the stock sparse product) and the dispatcher as a
whole, against the JAX package: the same edge arrays, outputs within f32
round-off of the JAX plan (rtol=atol=1e-5: the sums run in another order)
and passing res_check against SciPy; every method of ``spmm`` on one graph
against ``flex_tpu.ops.spmm``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.ops import spmm as j_spmm
from flex_tpu.ops.bcoo_spmm import prepare_bcoo as j_prepare_bcoo
from flex_tpu.ops.xla_spmm import prepare_xla as j_prepare_xla

from flex_tpu_torch import spmm
from flex_tpu_torch.io import banded_graph, make_features, rmat_graph
from flex_tpu_torch.ops import prepare_fn
from flex_tpu_torch.ops.bcoo_spmm import prepare_bcoo
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.xla_spmm import prepare_xla
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import dup_graph, hub_graph_with_empty_rows, jax_graph

# the CSR tensor constructor warns that sparse CSR support is in beta
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

GRAPHS = {
    "rmat2048": lambda: rmat_graph(2048, 32768, seed=3),
    "rmat500": lambda: rmat_graph(500, 6000, seed=3),
    "hub": hub_graph_with_empty_rows,
    "dups": dup_graph,
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_xla_edges_match_jax(name):
    """The device-built edge list equals the JAX plan's, up to its
    padding (rows m, column 0, value 0)."""
    g = GRAPHS[name]()
    plan = prepare_xla(g, device="cpu")
    ref = j_prepare_xla(jax_graph(g))
    assert plan.m == ref.m and plan.flops == 2 * g.nnz
    for mine, theirs, pad in ((plan.rows, ref.rows, g.m),
                              (plan.cols, ref.cols, 0),
                              (plan.vals, ref.vals, 0)):
        theirs = np.asarray(theirs)
        np.testing.assert_array_equal(mine.numpy(), theirs[:g.nnz])
        assert (theirs[g.nnz:] == pad).all()


@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("method", ["xla", "bcoo"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_baseline_matches_jax_and_scipy(name, method, k):
    g = GRAPHS[name]()
    B = make_features(g, k)
    prepare, j_prepare = {"xla": (prepare_xla, j_prepare_xla),
                          "bcoo": (prepare_bcoo, j_prepare_bcoo)}[method]
    C = prepare(g, device="cpu")(torch.from_numpy(B)).numpy()
    C_jax = np.asarray(j_prepare(jax_graph(g))(jnp.asarray(B)))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def test_bcoo_plan_fields():
    g = GRAPHS["rmat500"]()
    plan = prepare_bcoo(g, device="cpu")
    assert (plan.m, plan.n, plan.nnz) == (g.m, g.n, g.nnz)
    assert plan.mat.layout == torch.sparse_csr
    assert plan.stats == {"format": "csr", "nnz": g.nnz}
    assert plan.traffic_model(8)["gathered_rows"] == g.nnz


# one graph every strategy accepts: a band is also a run of dense windows
METHOD_KW = {
    "xla": {}, "bcoo": {}, "ell": {}, "gespmm": dict(w=16),
    "band": dict(tm=128),
    "band:xla": dict(tm=128, impl="xla"),
    "band:pallas": dict(tm=128, impl="pallas"),
    "windowed": dict(tm=128, W=128, J=4, min_count=8, min_coverage=0.0),
    "windowed:transposed": dict(tm=128, W=128, J=4, min_count=8,
                                min_coverage=0.0, transposed=True),
}


@pytest.mark.parametrize("case", sorted(METHOD_KW))
def test_spmm_dispatcher_matches_jax(case):
    g = banded_graph(1024, 96, 12.0, seed=4)
    B = make_features(g, 32)
    method, kw = case.split(":")[0], METHOD_KW[case]
    C = spmm(g, B, method=method, device="cpu", **kw).numpy()
    C_jax = np.asarray(j_spmm(jax_graph(g), jnp.asarray(B), method=method,
                              **kw))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0
    np.testing.assert_array_equal(spmm(g, B, method="ref"), spmm_scipy(g, B))


@pytest.mark.parametrize("method", ["xla", "bcoo", "gespmm", "band"])
def test_new_methods_need_a_device(monkeypatch, method):
    g = banded_graph(600, 64, 8.0, seed=7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmm(g, make_features(g, 4), method=method)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_fn(method)(g)


@pytest.mark.parametrize("method,word", [("panel", "not ported"),
                                         ("nope", "unknown")])
def test_spmm_names_what_it_refuses(method, word):
    g = banded_graph(600, 64, 8.0, seed=7)
    with pytest.raises(ValueError, match=f"{method}.*{word}|{word}.*{method}"):
        spmm(g, make_features(g, 4), method=method, device="cpu")
    with pytest.raises(ValueError, match=method):
        prepare_fn(method)


def test_prepare_refuses_a_device_that_differs_from_the_csr():
    from flex_tpu_torch.sparse.device import DeviceCSR

    g = GRAPHS["rmat500"]()
    dev = DeviceCSR.from_graph(g, "cpu")
    for method in ("xla", "bcoo", "gespmm", "band"):
        with pytest.raises(ValueError, match="dev lies on"):
            prepare_fn(method)(g, dev=dev, device="cuda")
