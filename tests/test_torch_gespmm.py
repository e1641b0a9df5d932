"""GE-SpMM of the PyTorch port against the JAX package: identical chunk
tables from the device build, the row-unit kernel's tables (every real
nonzero in exactly one unit of at most ROW_UNIT_ENTRIES, in order; row
lengths the CSR's degrees; split rows own partial rows), a NumPy emulation
of the kernel and its reduce pass and whole plans against the JAX plan
with its Pallas kernel in interpret mode (rtol=atol=1e-5: f32 sums in
another order; for rows of thousands of nonzeros the rounding bound of two
such sums), converted plans carrying the same tables, the byte model,
and the port's own plans against SciPy under res_check.  The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import flex_tpu.ops
from flex_tpu.ops.gespmm import prepare_gespmm as j_prepare_gespmm

from flex_tpu_torch import spmm
from flex_tpu_torch.convert import gespmm_plan_from_numpy
from flex_tpu_torch.io import make_features, rmat_graph, uniform_graph
from flex_tpu_torch.ops.gespmm import (
    CH, RowTables, gespmm_rows, gespmm_rows_plain, prepare_gespmm,
    rows_layout, tables_from_buckets,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import (
    _hub, assert_sums_close, check_row_tables, dup_graph, emulate_row_units,
    jax_graph,
)


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
    "hub_synth": _hub,
    "hub_synth_T": lambda: _hub(transposed=True),
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
    """The plain version of the row-unit wrapper in sub-batches equals one
    batch, the wrapper takes it for CPU tensors (no launch), ``into`` is
    added to in place, and rows without nonzeros come out zero."""
    g = GRAPHS["rmat2048"]()
    plan = prepare_gespmm(g, w=16, device="cpu")
    B = torch.from_numpy(make_features(g, 8))
    whole = gespmm_rows_plain(plan.rows, B)
    parts = gespmm_rows_plain(plan.rows, B, max_gather_rows=37)
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)
    before = gespmm_rows.launches
    torch.testing.assert_close(gespmm_rows(plan.rows, B), whole, rtol=0,
                               atol=0)
    base = torch.ones((g.m, 8))
    out = gespmm_rows(plan.rows, B, into=base)
    assert out.data_ptr() == base.data_ptr()
    torch.testing.assert_close(out, whole + 1, rtol=1e-6, atol=1e-6)
    assert gespmm_rows.launches == before  # no kernel on the CPU
    assert not bool(whole[torch.from_numpy(g.degrees == 0)].any())


def test_gespmm_zero_nnz_graph():
    g = CSRGraph.from_arrays(np.zeros(5, np.int64), np.zeros(0), np.zeros(0))
    plan = prepare_gespmm(g, device="cpu")
    assert plan.cols.shape == (CH, 32) and plan.padded_nnz == CH * 32
    C = plan(torch.ones((4, 8)))
    assert C.shape == (4, 8) and not bool(C.any())


def test_gespmm_rejects_bad_arguments():
    plan = prepare_gespmm(GRAPHS["rmat500"](), w=8, device="cpu")
    t = plan.rows
    B = torch.ones((plan.m, 4))
    gespmm_rows(t, B)
    # malformed tables are refused when they are made
    for bad in (dict(cols=t.cols.long()), dict(vals=t.vals.double()),
                dict(vals=t.vals[:-1]),
                dict(units=t.units[:, :3].contiguous()),
                dict(splits=t.splits.long()),
                dict(row_start=t.row_start.long())):
        with pytest.raises(ValueError):
            dataclasses.replace(t, **bad)
    for b, into in [(B.double(), None), (B[0], None),
                    (B, torch.ones((plan.m + 1, 4))),
                    (B, torch.ones((plan.m, 4), dtype=torch.float64))]:
        with pytest.raises(ValueError):
            gespmm_rows(t, b, into=into)
    with pytest.raises(ValueError, match="no gespmm kernel"):
        meta = RowTables(*(x.to("meta") for x in (
            t.cols, t.vals, t.row_start, t.units, t.splits)), t.n_parts)
        gespmm_rows(meta, B.to("meta"))
    with pytest.raises(ValueError, match="width"):
        prepare_gespmm(GRAPHS["rmat500"](), w=0, device="cpu")


@pytest.mark.parametrize("w", [8, 32])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gespmm_row_tables_cover_every_nonzero(name, w):
    """Every real nonzero in exactly one unit, in order; a unit at most
    ROW_UNIT_ENTRIES nonzeros of one row; split rows own partial rows; the
    row lengths are the CSR's degrees and no pad lies inside a row's run."""
    g = GRAPHS[name]()
    plan = prepare_gespmm(g, w=w, device="cpu")
    check_row_tables(plan.rows, g.row_ptr, g.col, g.vals)
    assert plan.rows.cols.data_ptr() == plan.cols.data_ptr()  # one store
    if name == "hub_synth_T":    # hub rows of thousands of nonzeros
        assert g.degrees.max() > 4 * 256
        assert plan.rows.splits.shape[0] > 0


@pytest.mark.parametrize("k", [16, 41, 128])
@pytest.mark.parametrize("name,w", [("rmat500", 8), ("long_rows", 8),
                                    ("rmat500", 32), ("hub_synth_T", 32),
                                    ("dups", 32)])
def test_gespmm_row_unit_emulation_matches_pallas(name, w, k):
    """The NumPy emulation of the row-unit kernel and its reduce pass on
    the port's tables against the JAX plan (``_gespmm_call``: the Pallas
    chunk kernel in interpret mode, then its scatter-add); every row is
    written, empty ones as zeros."""
    g = GRAPHS[name]()
    B = make_features(g, k)
    plan = prepare_gespmm(g, w=w, device="cpu")
    emu = emulate_row_units(plan.rows, B)
    assert not np.isnan(emu).any() and not emu[g.degrees == 0].any()
    jplan = j_prepare_gespmm(jax_graph(g), w=w)
    assert jplan.interpret
    absprod = emulate_row_units(
        dataclasses.replace(plan.rows, vals=plan.rows.vals.abs()), np.abs(B))
    assert_sums_close(emu, np.asarray(jplan(jnp.asarray(B))), g.degrees,
                      absprod)
    assert_sums_close(plan(torch.from_numpy(B)).numpy(), emu, g.degrees,
                      absprod)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gespmm_convert_carries_the_same_row_tables(name):
    g = GRAPHS[name]()
    mine = prepare_gespmm(g, w=8, device="cpu")
    conv = gespmm_plan_from_numpy(
        jax_gespmm_dict(j_prepare_gespmm(jax_graph(g), w=8)), "cpu")
    for f in ("cols", "vals", "row_start", "units", "splits"):
        np.testing.assert_array_equal(getattr(conv.rows, f).numpy(),
                                      getattr(mine.rows, f).numpy(), f)
    assert conv.rows.n_parts == mine.rows.n_parts
    # the tables derived from the buckets alone compute the same
    derived = tables_from_buckets(((mine.cols, mine.vals),), mine.chunk_row,
                                  mine.m)
    np.testing.assert_array_equal(derived.units.numpy(),
                                  mine.rows.units.numpy())
    B = torch.from_numpy(make_features(g, 8))
    bare = dataclasses.replace(mine, rows=derived)
    torch.testing.assert_close(bare(B), mine(B), rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gespmm_traffic_model_matches_jax(name):
    g = GRAPHS[name]()
    mine = prepare_gespmm(g, w=16, device="cpu")
    ref = j_prepare_gespmm(jax_graph(g), w=16)
    assert mine.stats == ref.stats
    for k in (16, 128):
        assert mine.traffic_model(k) == ref.traffic_model(k)


@pytest.mark.parametrize("k", [16, 41])
def test_spmm_default_method_is_xla_as_in_jax(k):
    """``spmm(g, B)`` names no method: the port and the JAX package both
    take ``"xla"``, which any graph can run (the windowed method would
    refuse this one: a uniform graph has no dense windows)."""
    g = uniform_graph(20_000, 80_000, seed=2)
    B = make_features(g, k)
    C = spmm(g, B, device="cpu")
    np.testing.assert_allclose(C.numpy(),
                               np.asarray(flex_tpu.ops.spmm(jax_graph(g), B)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="coverage"):
        spmm(g, B, method="windowed", device="cpu")


@pytest.mark.parametrize("k,lanes", [(0, 1), (1, 1), (4, 1), (7, 2),
                                     (16, 4), (41, 16), (64, 16), (65, 32),
                                     (128, 32), (300, 32)])
def test_rows_layout(k, lanes):
    """Kernel 7's f32 lanes a unit follow k alone: G is the smallest power
    of two with 4·G ≥ k, capped at 32 (a warp a unit beyond k = 64); a
    warp runs 32 / G units."""
    assert rows_layout(k) == (lanes, 32 // lanes)
    assert lanes == 32 or 4 * lanes >= k
    assert lanes == 1 or 2 * lanes < k
