"""The panel strategy of the PyTorch port against the JAX package, on the
CPU: ``hub_graph`` and the DEG ordering give the same arrays, the panel
tables (``build_panels``) are equal array for array, and
``spmm(method="panel")`` agrees with ``flex_tpu.ops.spmm(method="panel")``
at rtol = atol = 1e-5 (the sums run in another order: the JAX package's
einsum and segment sum against the batched product and the row-unit
kernel's plain version), widened for rows of thousands of nonzeros to the
f32 order bound of ``assert_sums_close``, with and without hub rows, at
several ``tm`` and ``hub_width``; its ``stats`` and ``traffic_model`` equal the JAX plan's.
The hub rows' kernel tables cover exactly the hub rows' nonzeros, and a
NumPy emulation of the row-unit kernel on them agrees with the JAX plan."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.io.synth import hub_graph as j_hub_graph
from flex_tpu.ops import spmm as j_spmm
from flex_tpu.ops.panel_spmm import prepare_panel as j_prepare_panel
from flex_tpu.tiling.panels import build_panels as j_build_panels

from flex_tpu_torch import spmm
from flex_tpu_torch.io import hub_graph, rmat_graph
from flex_tpu_torch.ops.panel_spmm import (
    MAX_GATHER_ROWS, prepare_panel, spmm_panel,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.tiling.panels import build_panels
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import (
    assert_sums_close, check_row_tables, emulate_row_units,
    hub_graph_with_empty_rows, jax_graph,
)

PANEL_FIELDS = ("ucols", "u_len", "e_row", "e_slot", "e_val", "e_len")


def _hub(seed=0):
    """Max degree 29 after DEG: hub thresholds of 20-25 make a hub prefix."""
    return reorder(hub_graph(3000, 60_000, n_hub_cols=64, hub_frac=0.9,
                             seed=seed), "deg")


def _trailing_empty():
    """DEG-ordered, so the last rows have no nonzeros: the tail's last
    panels are partly or wholly empty."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 900, 12_000)
    cols = rng.integers(0, 1200, 12_000)
    key = np.unique(rows * 1200 + cols)
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    g = CSRGraph.from_coo(key // 1200, key % 1200, vals, 1200, name="tail")
    return reorder(g, "deg", check=False)


GRAPHS = {
    "hub": _hub,
    "rmat": lambda: reorder(rmat_graph(2048, 32768, seed=3), "deg"),
    "trailing_empty": _trailing_empty,
    "long_rows": lambda: reorder(hub_graph_with_empty_rows(), "deg"),
}

# (graph, prepare keywords): without hubs, with hubs of one and of several
# chunks, other panel heights and bucket floors
CASES = [
    ("hub", {}),
    ("hub", dict(hub_threshold=22, hub_width=8)),
    ("hub", dict(tm=64, hub_threshold=25, hub_width=32)),
    ("hub", dict(tm=32, hub_threshold=20, hub_width=4, u_bucket_min=16)),
    ("rmat", dict(tm=128, hub_threshold=64, hub_width=16)),
    ("trailing_empty", dict(tm=64)),
    ("trailing_empty", dict(tm=128, hub_threshold=15, hub_width=4)),
    ("long_rows", dict(hub_threshold=100, hub_width=2048)),
    ("long_rows", dict(tm=256, hub_threshold=80, hub_width=300)),
]


@pytest.mark.parametrize("kw", [
    dict(m=3000, nnz_target=60_000, n_hub_cols=64, hub_frac=0.9, seed=0),
    dict(m=2000, nnz_target=30_000, seed=4, name="h"),
    dict(m=500, nnz_target=20_000, n_hub_cols=16, hub_frac=0.5, seed=2),
])
def test_hub_graph_matches_jax(kw):
    mine, ref = hub_graph(**kw), j_hub_graph(**kw)
    for f in ("row_ptr", "col", "vals"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert mine.name == ref.name


@pytest.mark.parametrize("tm", [32, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_panels_matches_jax(name, tm):
    g = GRAPHS[name]()
    mine, ref = build_panels(g, tm=tm), j_build_panels(jax_graph(g), tm=tm)
    for f in PANEL_FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f),
                                      err_msg=f)
    assert (mine.n_panels, mine.u_pad, mine.e_pad, mine.gather_bytes) == (
        ref.n_panels, ref.u_pad, ref.e_pad, ref.gather_bytes)
    np.testing.assert_array_equal(mine.dense_a(), ref.dense_a())
    mine.validate(g)


def test_panel_validate_catches_a_wrong_value():
    g = GRAPHS["hub"]()
    pf = build_panels(g, tm=64)
    pf.e_val[0, 0] += 1.0
    with pytest.raises(AssertionError, match="mismatch"):
        pf.validate(g)


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name,kw", CASES)
def test_panel_spmm_matches_jax(name, kw, k):
    g = GRAPHS[name]()
    B = np.random.default_rng(k).standard_normal((g.n, k)).astype(np.float32)
    ref = np.asarray(j_spmm(jax_graph(g), jnp.asarray(B), method="panel",
                            **kw))
    out = spmm(g, B, method="panel", device="cpu", **kw)
    assert out.device.type == "cpu" and tuple(out.shape) == (g.m, k)
    absprod = abs(g.to_scipy()) @ np.abs(B)
    assert_sums_close(out.numpy(), ref, g.degrees, absprod)
    assert res_check(spmm_scipy(g, B), out.numpy(), g.degrees).err_frac == 0


@pytest.mark.parametrize("name,kw", CASES)
def test_panel_stats_and_traffic_model_match_jax(name, kw):
    g = GRAPHS[name]()
    mine = prepare_panel(g, device="cpu", **kw)
    ref = j_prepare_panel(jax_graph(g), **kw)
    assert mine.stats == ref.stats
    for k in (16, 128):
        assert mine.traffic_model(k) == ref.traffic_model(k)
    np.testing.assert_array_equal(mine.hub_cols.numpy(),
                                  np.asarray(ref.data["hub_cols"]))
    np.testing.assert_array_equal(mine.hub_vals.numpy(),
                                  np.asarray(ref.data["hub_vals"]))
    np.testing.assert_array_equal(mine.hub_chunk_row.numpy(),
                                  np.asarray(ref.data["hub_chunk_row"]))
    assert len(mine.buckets) == len(ref.data["buckets"])
    for (a, u, ids), (ja, ju, jids) in zip(mine.buckets, ref.data["buckets"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("name,kw",
                         [c for c in CASES if "hub_threshold" in c[1]])
def test_panel_hub_tables_cover_the_hub_rows(name, kw):
    """Kernel 7's tables over the hub chunks: each hub row's run is its CSR
    nonzeros in order, lengths from the degrees (no pad read), and the
    kernel's arithmetic (NumPy emulation) gives the JAX plan's hub rows."""
    g = GRAPHS[name]()
    plan = prepare_panel(g, device="cpu", **kw)
    h = plan.n_hub_rows
    assert h > 0 and plan.hub_rows is not None
    e = int(g.row_ptr[h])
    check_row_tables(plan.hub_rows, g.row_ptr[:h + 1], g.col[:e], g.vals[:e])
    B = np.random.default_rng(0).standard_normal((g.n, 24)).astype(np.float32)
    ref = np.asarray(j_spmm(jax_graph(g), jnp.asarray(B), method="panel",
                            **kw))[:h]
    absprod = (abs(g.to_scipy()) @ np.abs(B))[:h]
    assert_sums_close(emulate_row_units(plan.hub_rows, B), ref,
                      g.degrees[:h], absprod)


def test_panel_without_hubs_has_no_tables():
    plan = prepare_panel(GRAPHS["hub"](), device="cpu")
    assert plan.n_hub_rows == 0 and plan.hub_rows is None
    assert plan.stats["n_hub_chunks"] == 0


def test_panel_refuses_hubs_that_are_not_a_prefix():
    g = hub_graph(3000, 60_000, n_hub_cols=64, seed=0)   # not DEG-ordered
    with pytest.raises(NotImplementedError, match="prefix"):
        j_prepare_panel(jax_graph(g), hub_threshold=22)
    with pytest.raises(NotImplementedError, match="prefix"):
        prepare_panel(g, device="cpu", hub_threshold=22)


def test_panel_sub_batches_match_one_batch(monkeypatch):
    """Gathers split into sub-batches (a small MAX_GATHER_ROWS) write the
    same rows as one batch."""
    g = GRAPHS["hub"]()
    B = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (g.n, 8)).astype(np.float32))
    plan = prepare_panel(g, device="cpu", tm=32, hub_threshold=22,
                         hub_width=8)
    whole = plan(B)
    assert MAX_GATHER_ROWS >= max(u.numel() for _, u, _ in plan.buckets)
    monkeypatch.setattr("flex_tpu_torch.ops.panel_spmm.MAX_GATHER_ROWS", 700)
    torch.testing.assert_close(plan(B), whole, rtol=0, atol=0)


def test_spmm_panel_one_shot_and_precision_keyword():
    g = GRAPHS["hub"]()
    B = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (g.n, 4)).astype(np.float32))
    want = prepare_panel(g, device="cpu")(B)
    got = spmm_panel(g, B, device="cpu", precision="highest")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_panel_refuses_a_bad_B():
    plan = prepare_panel(GRAPHS["hub"](), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        plan(torch.zeros((plan.m, 4), dtype=torch.float64))
