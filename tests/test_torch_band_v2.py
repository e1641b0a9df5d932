"""E8 (``experiments/pallas_band_v2.py``) on the port: the script's own
``build_split_band`` and ``make_pallas_v2`` (its Pallas body with
``pallas_call`` in interpret mode) against the port's on the same tables.

The script's ``__main__`` stops before its kernel against the current
JAX package (``plan.band`` is a tuple under the default ``"pallas2"``, and
a ``BandPlan`` has no ``ws128``), so both sides take the tables it means:
``P, TM, W`` and ``ws`` from ``prepare_band(..., impl="pallas")``.  The
split halves are equal exactly (the graph's (row, col) are unique), the
products at rtol = atol = 1e-5, and the halves equal the port's own
``"pallas2"`` tables.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.pallas_band import prepare_band as j_prepare_band
from flex_tpu.sparse.device import DeviceCSR as JDeviceCSR

from flex_tpu_torch import kernels
from flex_tpu_torch.experiments import pallas_band_v2
from flex_tpu_torch.io import banded_graph, make_features
from flex_tpu_torch.ops.pallas_band import prepare_band
from flex_tpu_torch.sparse.device import DeviceCSR
from test_torch_ell import jax_graph
from test_torch_micro import script_code, t

TOL = dict(rtol=1e-5, atol=1e-5)
SCRIPT = script_code("pallas_band_v2", ("build_split_band",
                                        "make_pallas_v2"))


def jax_tables(g, tm):
    """The script's tables through its own ``build_split_band``."""
    ns = SCRIPT(functools=functools)
    jg = jax_graph(g)
    dev = JDeviceCSR.from_graph(jg)
    plan = j_prepare_band(jg, dev=dev, tm=tm, impl="pallas", interpret=True)
    P, TM, W = plan.band.shape
    ws_el = np.asarray(plan.ws, dtype=np.int64) * 128
    iW = (ws_el // W).astype(np.int32)
    iW_rows = jnp.asarray(
        iW[np.minimum(np.arange(g.m) // TM, P - 1)].astype(np.int32))
    a_left, a_right = ns["build_split_band"](
        dev.row_ptr, dev.col, dev.vals, iW_rows, layout=(g.nnz, P, TM, W))
    return ns, (P, TM, W), iW, np.asarray(a_left), np.asarray(a_right)


CASES = [(2048, 64, 8.0, 128, 16), (3000, 100, 12.0, 256, 41),
         (1500, 200, 20.0, 128, 128)]


@pytest.mark.parametrize("m, bw, deg, tm, k", CASES)
def test_split_band_and_product_match_the_script(m, bw, deg, tm, k):
    g = banded_graph(m, bw, deg, seed=2)
    ns, (P, TM, W), iW, jl, jr = jax_tables(g, tm)
    plan, piW, al, ar = pallas_band_v2.split_tables(
        g, DeviceCSR.from_graph(g, "cpu"), tm)
    assert tuple(plan.band.shape) == (P, TM, W)
    np.testing.assert_array_equal(piW.numpy(), iW)
    np.testing.assert_array_equal(al.numpy(), jl)
    np.testing.assert_array_equal(ar.numpy(), jr)
    assert np.count_nonzero(jr) > 0       # both halves carry nonzeros
    # the port's own split build: the same halves
    own = prepare_band(g, tm=tm, device="cpu")
    np.testing.assert_array_equal(own.band[0].numpy(), jl)
    np.testing.assert_array_equal(own.band[1].numpy(), jr)
    np.testing.assert_array_equal(own.ws.numpy(), iW)

    B = make_features(g, k)
    f_jax = ns["make_pallas_v2"](P, TM, W, k, g.m, g.n,
                                 jax.lax.Precision.HIGHEST)
    ref = np.asarray(f_jax(jnp.asarray(iW), jnp.asarray(jl),
                           jnp.asarray(jr), jnp.asarray(B)))
    f = pallas_band_v2.make_pallas_v2(P, TM, W, k, g.m, g.n, "highest")
    out = f(piW, al, ar, t(B))
    assert out.shape == (g.m, k)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the JAX precision member is the same request
    out2 = pallas_band_v2.make_pallas_v2(
        P, TM, W, k, g.m, g.n, jax.lax.Precision.HIGHEST)(piW, al, ar, t(B))
    assert torch.equal(out, out2)


def test_build_split_band_sums_duplicates():
    """The script's scatter-add: two entries at one (row, col) add."""
    row_ptr = torch.tensor([0, 3, 4], dtype=torch.int32)
    col = torch.tensor([1, 1, 5, 2], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0])
    iW_rows = torch.tensor([0, 0], dtype=torch.int32)
    left, right = pallas_band_v2.build_split_band(
        row_ptr, col, vals, iW_rows, layout=(4, 1, 2, 4))
    np.testing.assert_array_equal(left.numpy()[0], [[0, 3, 0, 0],
                                                    [0, 0, 8, 0]])
    np.testing.assert_array_equal(right.numpy()[0], [[0, 4, 0, 0],
                                                     [0, 0, 0, 0]])


def test_make_pallas_v2_takes_highest_only():
    for prec in ("default", jax.lax.Precision.HIGH):
        with pytest.raises(ValueError, match="HIGHEST"):
            pallas_band_v2.make_pallas_v2(1, 8, 128, 4, 8, 8, prec)


def test_main_prints_both_lines(capsys):
    before = kernels.launch_counts()
    r = pallas_band_v2.main(device="cpu", m=4096, bandwidth=96,
                            avg_degree=16.0, k=32, iters=1)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert out[1] == f"P={r['P']} TM={r['TM']} W={r['W']}"
    assert out[2].startswith("pallas v2: ") and "err=0.00e+00" in out[2]
    assert out[3].startswith("xla ref: ")
    assert r["err_frac"] == 0.0 and 0 < r["depth_read"] <= 1
    assert kernels.launch_counts() == before
