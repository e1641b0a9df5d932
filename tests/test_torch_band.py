"""Band SpMM of the PyTorch port against the JAX package: the host window
model, band arrays equal to the JAX plan's, the two kernels' plain
versions and whole plans against the JAX plan with its Pallas kernels in
interpret mode (rtol=atol=1e-5: f32 sums in another order), the port's own
plans against SciPy under res_check, and the refusals.  The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.ops.pallas_band import panel_window_stats as j_window_stats
from flex_tpu.ops.pallas_band import prepare_band as j_prepare_band

from flex_tpu_torch.convert import band_plan_from_numpy
from flex_tpu_torch.io import banded_graph, make_features, uniform_graph
from flex_tpu_torch.ops.pallas_band import (
    IMPLS, band_spmm_v1, band_spmm_v1_plain, band_spmm_v2, band_spmm_v2_plain,
    panel_window_stats, prepare_band,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import jax_graph


def _trailing_empty():
    """Rows 512.. empty; the last nonzero, (511, 400), lies outside the
    window a reduceat clamped to nnz-1 would compute."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(512), 4)
    cols = rng.integers(0, 64, rows.shape)
    rows, cols = np.append(rows, 511), np.append(cols, 400)
    return CSRGraph.from_coo(rows, cols, np.ones(len(rows), np.float32), 768,
                             name="trailing_empty")


def _tiny_dups():
    """Duplicate (row, col) entries, which must sum; TM = 8."""
    return CSRGraph.from_arrays(np.array([0, 2, 3, 4, 4]),
                                np.array([1, 1, 0, 2]),
                                np.array([1.0, 2.0, 5.0, 7.0], np.float32))


# name -> (graph, prepare_band keywords)
CASES = {
    "band1024": (lambda: banded_graph(1024, 96, 12.0, seed=4), dict(tm=128)),
    "band600": (lambda: banded_graph(600, 64, 8.0, seed=7),
                dict(tm=256, min_density=0.005)),   # m % tm != 0
    "trailing_empty": (_trailing_empty, dict(tm=256, min_density=0.001)),
    "tiny_dups": (_tiny_dups, dict(tm=8, min_density=0.0)),
}


def jax_band_dict(p) -> dict:
    """A JAX BandPlan's fields as NumPy arrays (``convert``'s input)."""
    band = tuple(np.asarray(b) for b in p.band) \
        if isinstance(p.band, tuple) else np.asarray(p.band)
    return {"m": p.m, "n": p.n, "tm": p.tm, "w_pad": p.w_pad, "band": band,
            "ws": np.asarray(p.ws), "impl": p.impl}


@pytest.mark.parametrize("tm", [8, 128, 256])
@pytest.mark.parametrize("name", sorted(CASES))
def test_panel_window_stats_match_jax(name, tm):
    g = CASES[name][0]()
    mine, ref = panel_window_stats(g, tm), j_window_stats(jax_graph(g), tm)
    np.testing.assert_array_equal(mine[0], ref[0])
    assert mine[0].dtype == ref[0].dtype
    assert mine[1:] == ref[1:]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_band_arrays_match_jax(name, impl):
    """Integer tables exactly; the scattered values to round-off (the
    duplicate case sums two values in either order)."""
    make, kw = CASES[name]
    g = make()
    plan = prepare_band(g, device="cpu", impl=impl, **kw)
    ref = jax_band_dict(j_prepare_band(jax_graph(g), impl=impl, **kw))
    assert plan.ws.dtype == torch.int32
    np.testing.assert_array_equal(plan.ws.numpy(), ref["ws"])
    assert (plan.m, plan.n, plan.tm, plan.w_pad, plan.impl) == (
        ref["m"], ref["n"], ref["tm"], ref["w_pad"], impl)
    mine = plan.band if impl == "pallas2" else (plan.band,)
    theirs = ref["band"] if impl == "pallas2" else (ref["band"],)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)
    assert plan.stats["band_bytes"] == sum(b.nbytes for b in theirs)
    assert plan.stats["n_panels"] == -(-g.m // kw["tm"])


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_band_convert_computes_like_jax(name, impl, k):
    """The JAX plan (Pallas kernels in interpret mode, as its own tests run
    them) and the port's plan on the JAX plan's arrays."""
    make, kw = CASES[name]
    g = make()
    B = make_features(g, k)
    jplan = j_prepare_band(jax_graph(g), impl=impl, **kw)
    assert jplan.interpret
    plan = band_plan_from_numpy(jax_band_dict(jplan), "cpu")
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_band_matches_scipy(name, impl, k):
    make, kw = CASES[name]
    g = make()
    B = make_features(g, k)
    C = prepare_band(g, device="cpu", impl=impl, **kw)(
        torch.from_numpy(B)).numpy()
    assert C.shape == (g.m, k)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0
    assert np.all(C[g.degrees == 0] == 0.0)


def test_band_wrappers_take_the_plain_versions_on_the_cpu():
    make, kw = CASES["band600"]
    g = make()
    B = torch.from_numpy(make_features(g, 8))
    p2 = prepare_band(g, device="cpu", **kw)
    p1 = prepare_band(g, device="cpu", impl="pallas", **kw)
    before = (band_spmm_v2.launches, band_spmm_v1.launches)
    out2 = band_spmm_v2(*p2.band, p2.ws, B)
    out1 = band_spmm_v1(p1.band, p1.ws, B)
    assert (band_spmm_v2.launches, band_spmm_v1.launches) == before
    torch.testing.assert_close(out2, band_spmm_v2_plain(*p2.band, p2.ws, B),
                               rtol=0, atol=0)
    torch.testing.assert_close(out1, band_spmm_v1_plain(p1.band, p1.ws, B),
                               rtol=0, atol=0)
    assert out2.shape == out1.shape == (3 * 256, 8)   # P·TM rows, m = 600
    torch.testing.assert_close(out2, out1, rtol=1e-5, atol=1e-5)
    assert p2.traffic_model(8)["bytes"] > p1.traffic_model(8)["bytes"]


def test_band_refuses_what_jax_refuses():
    g = uniform_graph(2048, 16384, seed=1)
    with pytest.raises(ValueError, match="not band-friendly"):
        prepare_band(g, device="cpu")
    with pytest.raises(ValueError):
        j_prepare_band(jax_graph(g))
    gb = banded_graph(1024, 96, 12.0, seed=4)
    with pytest.raises(ValueError, match="not band-friendly"):
        prepare_band(gb, device="cpu", tm=128, max_band_bytes=1000)
    with pytest.raises(ValueError, match="unknown band impl"):
        prepare_band(gb, device="cpu", impl="pallas3")
    with pytest.raises(ValueError, match=r"B must be \(1024, k\)"):
        prepare_band(gb, device="cpu", tm=128)(torch.ones((1000, 4)))


def test_band_wrappers_reject_bad_arguments():
    make, kw = CASES["band1024"]
    p2 = prepare_band(make(), device="cpu", **kw)
    left, right = p2.band
    B = torch.ones((p2.n, 4))
    for args in ((left, right[:-1], p2.ws, B), (left, right, p2.ws.long(), B),
                 (left, right, p2.ws[:-1], B), (left.double(), right, p2.ws, B),
                 (left, right, p2.ws, B.double()), (left, right, p2.ws, B[0]),
                 (left[0], right[0], p2.ws, B)):
        with pytest.raises(ValueError):
            band_spmm_v2(*args)
    for args in ((left, p2.ws.long(), B), (left, p2.ws, B.double()),
                 (left[0], p2.ws, B)):
        with pytest.raises(ValueError):
            band_spmm_v1(*args)
    with pytest.raises(ValueError, match="no band kernel"):
        band_spmm_v1(left.to("meta"), p2.ws.to("meta"), B.to("meta"))
