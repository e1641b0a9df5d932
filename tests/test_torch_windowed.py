"""Windowed hybrid of the PyTorch port against the JAX package: the same
window selection, a dense A equal element for element and identical
residue tables from the device build, the dense half's plain version
against the Pallas kernel in interpret mode, and whole plans against the
JAX plan (rtol=atol=1e-5) and SciPy (res_check err_frac == 0).  The CUDA
kernel itself runs only on a card: tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.window_spmm import _window_pallas_raw
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed
from flex_tpu.ops.window_spmm import window_select as j_window_select

from flex_tpu_torch import spmm
from flex_tpu_torch.convert import windowed_plan_from_numpy
from flex_tpu_torch.io import (
    bipartite_projection_graph, community_graph, make_features,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
    panel_step_ptr, prepare_windowed, window_select, window_spmm_fwd,
    window_spmm_fwd_plain,
)
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import (
    assert_same_ell, dup_graph, hub_graph_with_empty_rows, jax_ell_dict,
    jax_graph,
)


def _community_rbdeg():
    return reorder(community_graph(3000, 300_000, n_comm=8, seed=5), "rbdeg")


def _trailing_empty():
    """Zero-degree tail rows: the last panels hold no windows."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(256), 40)
    cols = rng.integers(0, 256, rows.shape)
    key = np.unique(rows * 700 + cols)
    return CSRGraph.from_coo(key // 700, key % 700,
                             np.ones(len(key), np.float32), 700, name="tail")


CASES = {
    "community": (_community_rbdeg, dict(tm=256, W=128, J=4, min_count=32)),
    "variable_steps": (
        lambda: reorder(community_graph(4096, 400_000, n_comm=3, seed=3,
                                        shuffle=False), "rbdeg"),
        dict(tm=128, W=128, J=256, min_count=8)),
    "clique": (
        lambda: reorder(bipartite_projection_graph(4000, 200_000, n_comm=6,
                                                   seed=2), "rabbit"),
        dict(tm=128, W=128, J=4, min_count=16)),
    "split_residue": (hub_graph_with_empty_rows,
                      dict(tm=256, W=128, J=8, min_count=256,
                           min_coverage=0.0)),
    "trailing_empty": (_trailing_empty, dict(tm=256, W=128, J=3,
                                             min_count=8)),
    "full_coverage": (
        lambda: community_graph(512, 60_000, n_comm=2, seed=1,
                                shuffle=False),
        dict(tm=256, W=128, J=4, min_count=1)),
}
SELECT_KEYS = ("win_step", "out_panel", "first", "pstep0", "slot", "used",
               "row_gather", "res_deg")
SCALAR_KEYS = ("coverage", "n_res", "a_elems", "total_steps",
               "n_used_panels", "P", "nblk", "min_count_eff", "unique_rc",
               "G", "W")


def _sel_kw(kw):
    return {k: v for k, v in kw.items() if k != "min_coverage"}


def jax_windowed_dict(p) -> dict:
    """A JAX WindowedPlan's fields as NumPy arrays (``convert``'s input)."""
    return {
        "m": p.m, "n": p.n, "tm": p.tm, "W": p.W,
        "n_used_panels": p.n_used_panels, "A": np.asarray(p.A),
        "first": np.asarray(p.first), "out_panel": np.asarray(p.out_panel),
        "win_step": np.asarray(p.win_step),
        "row_gather": np.asarray(p.row_gather), "coverage": p.coverage,
        "min_count_eff": p.min_count_eff, "ell": jax_ell_dict(p.ell),
        "n_windows": p.n_windows, "covered_nnz": p.covered_nnz,
    }


@pytest.mark.parametrize("budget", [None, "half"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_select_matches_jax(name, budget):
    make, kw = CASES[name]
    g = make()
    kw = _sel_kw(kw)
    if budget:
        kw["max_dense_bytes"] = window_select(g, **kw)["dense_bytes"] // 2
    mine = window_select(g, **kw)
    ref = j_window_select(jax_graph(g), **kw)
    for key in SELECT_KEYS:
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
        assert mine[key].dtype == ref[key].dtype, key
    for key in SCALAR_KEYS:
        assert mine[key] == ref[key], key


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_build_matches_jax_plan(name):
    """The port's device build on the CPU gives JAX's A element for element
    and the same residue ELL tables (duplicate-free graphs, so the A
    scatter is a set on both sides)."""
    make, kw = CASES[name]
    g = make()
    plan = prepare_windowed(g, device="cpu", **kw)
    ref = jax_windowed_dict(j_prepare_windowed(jax_graph(g), **kw))
    assert window_select(g, **_sel_kw(kw))["unique_rc"]
    np.testing.assert_array_equal(plan.A.numpy(), ref["A"])
    for key in ("first", "out_panel", "win_step", "row_gather"):
        np.testing.assert_array_equal(getattr(plan, key).numpy(), ref[key],
                                      err_msg=key)
    assert plan.n_used_panels == ref["n_used_panels"]
    assert plan.coverage == ref["coverage"]
    assert_same_ell(plan.ell, ref["ell"])
    if name == "split_residue":
        assert plan.ell.extras is not None and plan.A.shape[0] >= 1


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("name", ["community", "variable_steps"])
def test_plain_matches_pallas_interpret(name, k):
    """window_spmm_fwd_plain on JAX's own format arrays against
    _window_pallas_raw in interpret mode (what prepare_windowed selects on
    the CPU)."""
    make, kw = CASES[name]
    g = make()
    d = jax_windowed_dict(j_prepare_windowed(jax_graph(g), **kw))
    B = make_features(g, k)
    W, n_panels = d["W"], d["n_used_panels"]
    nblk = -(-g.n // W)
    B_pad = jnp.zeros(((nblk + 1) * W, k), jnp.float32).at[:g.n].set(B)
    ref = np.asarray(_window_pallas_raw(
        jnp.asarray(d["first"]), jnp.asarray(d["out_panel"]),
        jnp.asarray(d["win_step"]), jnp.asarray(d["A"]), B_pad,
        n_panels=n_panels, W=W, k=k, precision=jax.lax.Precision.HIGHEST,
        interpret=True))
    t = windowed_plan_from_numpy(d, "cpu")
    args = (t.first, t.out_panel, t.win_step, t.A, torch.from_numpy(B))
    out = window_spmm_fwd_plain(*args, n_panels=n_panels, W=W)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    via = window_spmm_fwd(*args, n_panels=n_panels, W=W,
                          panel_step_ptr=t.panel_step_ptr)
    torch.testing.assert_close(via, out, rtol=0, atol=0)


@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_windowed_matches_jax_and_scipy(name, k):
    make, kw = CASES[name]
    g = make()
    B = make_features(g, k)
    C = prepare_windowed(g, device="cpu", **kw)(torch.from_numpy(B)).numpy()
    C_jax = np.asarray(j_prepare_windowed(jax_graph(g), **kw)(
        jnp.asarray(B)))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def test_windowed_convert_computes_like_jax():
    make, kw = CASES["split_residue"]
    g = make()
    B = make_features(g, 32)
    jplan = j_prepare_windowed(jax_graph(g), **kw)
    plan = windowed_plan_from_numpy(jax_windowed_dict(jplan), "cpu")
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


def test_windowed_duplicate_entries_sum():
    g = dup_graph()
    kw = dict(tm=256, W=128, J=8, min_count=1, min_coverage=0.0)
    assert not window_select(g, **_sel_kw(kw))["unique_rc"]
    B = make_features(g, 8)
    C = spmm(g, B, method="windowed", device="cpu", **kw).numpy()
    assert res_check(spmm_scipy(g, B), C, g.degrees).ok
    C_jax = np.asarray(j_prepare_windowed(jax_graph(g), **kw)(
        jnp.asarray(B)))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)


def test_windowed_sel_reuse_and_stats():
    make, kw = CASES["variable_steps"]
    g = make()
    sel = window_select(g, **kw)
    p1 = prepare_windowed(g, device="cpu", sel=sel, **kw)
    assert "cpu" in sel["torch_tables"]
    p2 = prepare_windowed(g, device="cpu", **kw)
    torch.testing.assert_close(p1.A, p2.A, rtol=0, atol=0)
    steps = np.bincount(sel["out_panel"])
    np.testing.assert_array_equal(np.diff(panel_step_ptr(sel["first"])),
                                  steps)
    st = p1.stats
    assert st["max_steps_per_panel"] == steps.max() > steps.min()
    assert st["n_steps"] == sel["total_steps"] and st["n_res"] == sel["n_res"]


def test_windowed_refuses_scattered():
    from flex_tpu_torch.sparse.device import DeviceCSR

    rng = np.random.default_rng(1)
    key = np.unique(rng.integers(0, 4096**2, 40_000))
    g = CSRGraph.from_coo(key // 4096, key % 4096,
                          np.ones(len(key), np.float32), 4096)
    with pytest.raises(ValueError, match="coverage"):
        prepare_windowed(g, DeviceCSR.from_graph(g, "cpu"), tm=256, W=128,
                         J=4, min_count=64)


def test_prepare_windowed_needs_a_device(monkeypatch):
    g = _trailing_empty()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_windowed(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmm(g, make_features(g, 4), method="windowed")


def test_window_fwd_rejects_bad_arguments():
    plan = prepare_windowed(_trailing_empty(), device="cpu", tm=256, W=128,
                            J=3, min_count=8)
    B = torch.ones((plan.n, 4))
    good = dict(first=plan.first, out_panel=plan.out_panel,
                win_step=plan.win_step, A=plan.A, B=B)
    kw = dict(n_panels=plan.n_used_panels, W=plan.W,
              panel_step_ptr=plan.panel_step_ptr)
    window_spmm_fwd(*good.values(), **kw)
    for key, bad in (("first", plan.first.long()), ("B", B.double()),
                     ("win_step", plan.win_step[:-1])):
        args = dict(good, **{key: bad})
        with pytest.raises(ValueError):
            window_spmm_fwd(*args.values(), **kw)
    with pytest.raises(ValueError):
        window_spmm_fwd(*good.values(), **dict(kw, W=96))
    with pytest.raises(ValueError, match="panel_step_ptr"):
        window_spmm_fwd(*good.values(),
                        **dict(kw, n_panels=plan.n_used_panels + 1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_windowed_stats_and_traffic_model_match_jax(name):
    """The plan's counters (``pad_ratio``, ``step_fill``, ``dense_occ``,
    ``W``, ``impl`` and the rest) and byte model equal the JAX plan's, on
    the port's own build and on a plan converted from the JAX arrays; the
    port adds the longest panel's step count."""
    make, kw = CASES[name]
    g = make()
    mine = prepare_windowed(g, device="cpu", **kw)
    ref = j_prepare_windowed(jax_graph(g), **kw)
    conv = windowed_plan_from_numpy(jax_windowed_dict(ref), "cpu")
    for plan in (mine, conv):
        st = plan.stats
        assert st.pop("max_steps_per_panel") >= 1
        assert st == ref.stats
        for k in (16, 128):
            assert plan.traffic_model(k) == ref.traffic_model(k)
    assert {"step_fill", "dense_occ", "pad_ratio"} <= set(ref.stats)
