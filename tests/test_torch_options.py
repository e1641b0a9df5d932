"""The options of the windowed and ELL builds, in the PyTorch port against
the JAX package on the CPU: ``window_select(step_order="lex")`` and
``g_step`` give the JAX selection's tables; ``prepare_windowed`` runs one
build for every ``fused`` name (True, False, "scatter", "scatter2"), and
it gives the JAX build of that name's dense A, ELL buckets, ``chunk_row``
and gather tables (but for the gather tables of an empty residue, which
only the JAX unfused build leaves off), and the same output bits as the
default build; ``impl="xla"`` is
the plain product of the dense half (the same bits as the default plan's
plain path on the CPU, rtol = atol = 1e-5 against the JAX plan);
``ell_scatter_layout`` and ``prepare_ell_device(bucket_alloc=...)`` equal
the JAX package's; the scatter2 build refuses a combined buffer past int32
as the JAX one does."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.ops.ell_spmm import ell_scatter_layout as j_ell_scatter_layout
from flex_tpu.ops.ell_spmm import prepare_ell_device as j_prepare_ell_device
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed
from flex_tpu.ops.window_spmm import window_select as j_window_select
from flex_tpu.sparse.device import DeviceCSR as JDeviceCSR

from flex_tpu_torch.io import make_features
from flex_tpu_torch.ops.ell_spmm import (
    DEFAULT_WIDTHS, ell_scatter_layout, prepare_ell_device,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import prepare_windowed, window_select
from flex_tpu_torch.parallel.spmm_sharded import SHARDED_WIDTHS
from flex_tpu_torch.sparse.device import DeviceCSR
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import (
    GRAPHS, assert_same_ell, check_row_tables, jax_ell_dict, jax_graph,
)
from test_torch_windowed import (
    CASES, SCALAR_KEYS, SELECT_KEYS, _sel_kw, jax_windowed_dict,
)

FUSED = [True, False, "scatter", "scatter2"]
OPTION_CASES = ["community", "split_residue", "trailing_empty"]


@pytest.mark.parametrize("g_step", [2, 4])
@pytest.mark.parametrize("step_order", ["row", "lex"])
@pytest.mark.parametrize("name", ["community", "variable_steps", "clique"])
def test_window_select_order_and_g_step_match_jax(name, step_order, g_step):
    make, kw = CASES[name]
    g = make()
    kw = dict(_sel_kw(kw), step_order=step_order, g_step=g_step)
    mine = window_select(g, **kw)
    ref = j_window_select(jax_graph(g), **kw)
    for key in SELECT_KEYS:
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    for key in SCALAR_KEYS:
        assert mine[key] == ref[key], key
    if step_order == "lex" and name != "variable_steps":
        # the lexsort moved panels: the assembly permutation absorbs it
        row = window_select(g, **dict(kw, step_order="row"))
        assert not np.array_equal(mine["used"], row["used"])


def test_window_select_refuses_unknown_order():
    make, kw = CASES["community"]
    with pytest.raises(ValueError, match="step_order"):
        window_select(make(), **_sel_kw(kw), step_order="dfs")


def _assert_same_plan(plan, ref: dict, fused=True, fused_ref=None):
    """``plan`` against the JAX plan ``ref`` built with ``fused``.  The JAX
    unfused build attaches no gather assembly (``chunk1``, ``extras``) to
    an empty residue, which no call reads; its other builds, and the
    port's one build, do: there the assembly is held against
    ``fused_ref``, the JAX fused build's."""
    np.testing.assert_array_equal(plan.A.numpy(), ref["A"])
    for key in ("first", "out_panel", "win_step", "row_gather"):
        np.testing.assert_array_equal(getattr(plan, key).numpy(), ref[key],
                                      err_msg=key)
    assert plan.n_used_panels == ref["n_used_panels"]
    ell = ref["ell"]
    if fused is False and ell["nnz"] == 0:
        assert ell["chunk1"] is None and ell["extras"] is None
        ell = dict(ell, chunk1=fused_ref["ell"]["chunk1"],
                   extras=fused_ref["ell"]["extras"])
    assert_same_ell(plan.ell, ell)


@pytest.mark.parametrize("fused", FUSED)
@pytest.mark.parametrize("name", OPTION_CASES)
def test_fused_builds_match_jax(name, fused):
    """The plan of each name has the tables of the JAX build of that name,
    its row-unit tables cover the residue's nonzeros, and its output has
    the default build's bits."""
    make, kw = CASES[name]
    g = make()
    plan = prepare_windowed(g, device="cpu", fused=fused, **kw)
    jg = jax_graph(g)
    ref = jax_windowed_dict(j_prepare_windowed(jg, fused=fused, **kw))
    _assert_same_plan(plan, ref, fused,
                      jax_windowed_dict(j_prepare_windowed(jg, **kw)))
    base = prepare_windowed(g, device="cpu", **kw)
    res = plan.ell
    if res.buckets:
        want = base.ell.row_tables()
        got = res.row_tables()
        for f in ("row_start", "units", "splits"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(want, f).numpy(), err_msg=f)
    B = torch.from_numpy(make_features(g, 16))
    np.testing.assert_array_equal(plan(B).numpy(), base(B).numpy())


@pytest.mark.parametrize("fused", FUSED)
def test_fused_builds_transposed_and_lex_match_jax(fused):
    """The builds on the transposed step layout with the lex step order and
    G = 2, against JAX's tables and output."""
    make, kw = CASES["variable_steps"]
    g = make()
    kw = dict(kw, step_order="lex", g_step=2)
    plan = prepare_windowed(g, device="cpu", fused=fused, transposed=True,
                            **kw)
    jplan = j_prepare_windowed(jax_graph(g), fused=fused, transposed=True,
                               **kw)
    _assert_same_plan(plan, jax_windowed_dict(jplan), fused,
                      jax_windowed_dict(j_prepare_windowed(
                          jax_graph(g), transposed=True, **kw)))
    B = make_features(g, 24)
    C = plan(torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(C, np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def test_scatter2_refuses_past_int32():
    """The combined value buffer of scatter2 is int32-indexed in the JAX
    package: both refuse a selection whose A and padded residue together
    reach 2^31 elements (a caller-supplied selection stands in for one of
    that size); the other builds accept it."""
    make, kw = CASES["community"]
    g = make()
    for prep, gg in ((prepare_windowed, g), (j_prepare_windowed,
                                             jax_graph(g))):
        sel = (window_select if prep is prepare_windowed
               else j_window_select)(gg, **_sel_kw(kw))
        sel["a_elems"] = 2**31 - 1
        extra = {"device": "cpu"} if prep is prepare_windowed else {}
        with pytest.raises(ValueError, match="int32"):
            prep(gg, sel=sel, fused="scatter2", **extra, **kw)
    sel = window_select(g, **_sel_kw(kw))
    sel["a_elems"] = 2**31 - 1
    assert prepare_windowed(g, sel=sel, fused="scatter", device="cpu",
                            **kw).ell.nnz == sel["n_res"]


def test_prepare_windowed_refuses_unknown_options():
    make, kw = CASES["community"]
    g = make()
    with pytest.raises(ValueError, match="impl"):
        prepare_windowed(g, device="cpu", impl="triton", **kw)
    with pytest.raises(ValueError, match="fused"):
        prepare_windowed(g, device="cpu", fused="gather", **kw)
    with pytest.raises(ValueError, match="interpret"):
        prepare_windowed(g, device="cpu", interpret="yes", **kw)


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name", ["community", "trailing_empty"])
def test_impl_xla_is_the_plain_product(name, k):
    """``impl="xla"`` runs the dense half as ``window_spmm_fwd_plain`` on
    any device; on the CPU the default plan takes that same plain version,
    so the bits agree; ``interpret`` is accepted and changes nothing."""
    make, kw = CASES[name]
    g = make()
    B = make_features(g, k)
    xla = prepare_windowed(g, device="cpu", impl="xla", interpret=True, **kw)
    pallas = prepare_windowed(g, device="cpu", interpret=False, **kw)
    assert xla.stats["impl"] == "xla" and pallas.stats["impl"] == "pallas"
    Bt = torch.from_numpy(B)
    np.testing.assert_array_equal(xla(Bt).numpy(), pallas(Bt).numpy())
    jplan = j_prepare_windowed(jax_graph(g), impl="xla", **kw)
    assert jplan.stats["impl"] == "xla"
    np.testing.assert_allclose(xla(Bt).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)
    # differentiable through autograd of the plain ops
    Bg = Bt.clone().requires_grad_()
    xla(Bg).sum().backward()
    Bp = Bt.clone().requires_grad_()
    pallas(Bp).sum().backward()
    np.testing.assert_allclose(Bg.grad.numpy(), Bp.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_scatter_layout_matches_jax(name):
    g = GRAPHS[name]()
    for widths in (DEFAULT_WIDTHS, SHARDED_WIDTHS, (2, 8, 64)):
        mine = ell_scatter_layout(g.degrees, widths)
        ref = j_ell_scatter_layout(g.degrees, widths)
        assert mine[0] == ref[0] and mine[3] == ref[3]
        for a, b in zip(mine[1:3], ref[1:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_prepare_ell_device_bucket_alloc_matches_jax(name):
    """Buckets padded to a common allocation (the sharded plans' shapes):
    pad chunks point at row 0 and hold nothing, and there is no gather
    assembly; the output is the unpadded plan's."""
    g = GRAPHS[name]()
    widths = SHARDED_WIDTHS
    deg = g.degrees
    from flex_tpu_torch.ops.ell_spmm import host_bucket_sizes

    by_w, _, _ = host_bucket_sizes(deg, widths)
    alloc = {w: nc + 3 for w, nc in by_w.items()}
    alloc[widths[0]] = alloc.get(widths[0], 0) + 5   # a width with pads only
    dev = DeviceCSR.from_graph(g, "cpu")
    plan = prepare_ell_device(dev.row_ptr, dev.col, dev.vals, m=g.m,
                              nnz=g.nnz, res_row_ptr_host=g.row_ptr,
                              widths=widths, bucket_alloc=alloc)
    jdev = JDeviceCSR.from_graph(jax_graph(g))
    ref = j_prepare_ell_device(jdev.row_ptr, jdev.col, jdev.vals, m=g.m,
                               nnz=g.nnz, res_row_ptr_host=g.row_ptr,
                               widths=widths, bucket_alloc=alloc)
    assert_same_ell(plan, jax_ell_dict(ref))
    assert plan.chunk1 is None
    # the scatter layout under the same allocation (the sharded windowed
    # residue's) has the same buckets, chunk rows and padded size
    meta, _, chunk_row, padded = ell_scatter_layout(deg, widths, alloc)
    assert [(w, n) for w, n, _ in meta] == [tuple(c.shape[::-1])
                                           for c, _ in plan.buckets]
    np.testing.assert_array_equal(chunk_row, plan.chunk_row.numpy())
    assert padded == plan.padded_nnz
    with pytest.raises(ValueError, match="bucket_alloc"):
        ell_scatter_layout(deg, widths, {w: 0 for w in alloc})
    check_row_tables(plan.row_tables(), g.row_ptr, g.col, g.vals)
    B = torch.from_numpy(make_features(g, 16))
    plain = prepare_ell_device(dev.row_ptr, dev.col, dev.vals, m=g.m,
                               nnz=g.nnz, res_row_ptr_host=g.row_ptr,
                               widths=widths)
    np.testing.assert_allclose(plan(B).numpy(), plain(B).numpy(), rtol=1e-6,
                               atol=1e-6)
