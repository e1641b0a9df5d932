"""ELL forward of the PyTorch port against the JAX package: identical
bucket tables on the same graph, outputs within f32 round-off of the JAX
plan and passing res_check against SciPy.  The row-unit kernel's tables
(every real nonzero of a residue in exactly one unit, in order, the row
lengths the CSR's) on ``prepare_ell``, the windowed plan's residue and the
transposed plan with its pad-laden row 0, and a NumPy emulation of what
``csrc/gespmm.cu`` computes (units, then the pass over split rows) against
the JAX package's ``_ell_spmm`` with ``into=`` (rtol = atol = 1e-5,
widened for rows of thousands of nonzeros to the rounding bound of two
f32 sums in different orders).  The
plan's byte model and counters against the JAX plan's; the residue's
autograd path of the card (its call route, and the transposed plan that
a backward without a ``bwd_plan`` builds and keeps) on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flex_tpu.io.synth import hub_graph as j_hub_graph
from flex_tpu.ops.ell_spmm import _ell_spmm as j_ell_spmm
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.ops.ell_spmm import with_bwd_plan as j_with_bwd_plan
from flex_tpu.ops import spmm as j_spmm
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed
from flex_tpu.sparse.csr import CSRGraph as JCSRGraph

from flex_tpu_torch import spmm
from flex_tpu_torch.convert import ell_plan_from_numpy
from flex_tpu_torch.io import community_graph, make_features
from flex_tpu_torch.ops import ell_spmm
from flex_tpu_torch.ops.ell_spmm import (
    DEFAULT_WIDTHS, _EllApply, ell_spmm_plain, prepare_ell,
    prepare_ell_transpose, with_bwd_plan,
)
from flex_tpu_torch.ops.gespmm import ROW_UNIT_ENTRIES, gespmm_rows
from flex_tpu_torch.ops.window_spmm import prepare_windowed
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.utils.check import res_check


def jax_graph(g):
    return JCSRGraph.from_arrays(g.row_ptr, g.col, g.vals, name=g.name)


def jax_ell_dict(p) -> dict:
    """A JAX EllPlan's fields as NumPy arrays (``convert``'s input)."""
    return {
        "m": p.m, "nnz": p.nnz, "padded_nnz": p.padded_nnz,
        "buckets": [(np.asarray(c), np.asarray(v)) for c, v in p.buckets],
        "chunk_row": np.asarray(p.chunk_row),
        "chunk1": None if p.chunk1 is None else np.asarray(p.chunk1),
        "extras": None if p.extras is None
        else tuple(np.asarray(e) for e in p.extras),
    }


def assert_same_ell(port, ref: dict):
    assert port.m == ref["m"] and port.nnz == ref["nnz"]
    assert port.padded_nnz == ref["padded_nnz"]
    assert len(port.buckets) == len(ref["buckets"])
    for (c, v), (rc, rv) in zip(port.buckets, ref["buckets"]):
        assert c.dtype == torch.int32 and v.dtype == torch.float32
        np.testing.assert_array_equal(c.numpy(), rc)
        np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(port.chunk_row.numpy(), ref["chunk_row"])
    if ref["chunk1"] is None:
        assert port.chunk1 is None
    else:
        np.testing.assert_array_equal(port.chunk1.numpy(), ref["chunk1"])
    if ref["extras"] is None:
        assert port.extras is None
    else:
        for e, re_ in zip(port.extras, ref["extras"]):
            np.testing.assert_array_equal(e.numpy(), re_)


def hub_graph_with_empty_rows(seed=3, m=6000):
    """Rows longer than the widest bucket (2048: split chunks, non-empty
    extras), many empty rows, and a dense block; duplicate-free."""
    rng = np.random.default_rng(seed)
    blk_cols = np.argsort(rng.random((256, 128)), axis=1)[:, :80]
    rows = np.concatenate([
        np.repeat(np.arange(256), 80),
        np.full(3000, 300), np.full(4500, 301),
        np.repeat(np.arange(1000, m), 2),
    ])
    cols = np.concatenate([
        blk_cols.ravel(),
        np.sort(rng.choice(m, 3000, replace=False)),
        np.sort(rng.choice(m, 4500, replace=False)),
        rng.integers(0, m, (m - 1000) * 2),
    ])
    key = np.unique(rows.astype(np.int64) * m + cols)
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    return CSRGraph.from_coo(key // m, key % m, vals, m, name="hub")


def dup_graph():
    """Duplicate (row, col) entries, which must sum (as in
    tests/test_duplicates.py)."""
    rng = np.random.default_rng(0)
    m = 700
    rows = rng.integers(0, m, 8_000)
    cols = rng.integers(0, m, 8_000)
    rows = np.concatenate([rows, rows[:3000]])
    cols = np.concatenate([cols, cols[:3000]])
    vals = (2 * rng.random(len(rows)) - 1).astype(np.float32)
    order = np.lexsort((cols, rows))
    row_ptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    return CSRGraph.from_arrays(row_ptr, cols[order], vals[order], name="dups")


GRAPHS = {
    "hub": hub_graph_with_empty_rows,
    "community_rbdeg": lambda: reorder(
        community_graph(3000, 200_000, n_comm=6, seed=5), "rbdeg"),
    "dups": dup_graph,
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_tables_match_jax(name):
    g = GRAPHS[name]()
    port = prepare_ell(g, device="cpu")
    assert_same_ell(port, jax_ell_dict(j_prepare_ell(jax_graph(g))))
    if name == "hub":
        assert g.degrees.max() > 2048 and (g.degrees == 0).any()
        assert port.extras is not None and len(port.extras[0]) >= 2


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_matches_jax_and_scipy(name, k):
    g = GRAPHS[name]()
    B = make_features(g, k)
    C = prepare_ell(g, device="cpu")(torch.from_numpy(B)).numpy()
    C_jax = np.asarray(j_prepare_ell(jax_graph(g))(jnp.asarray(B)))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    assert res_check(spmm_scipy(g, B), C, g.degrees).err_frac == 0


def test_ell_convert_computes_like_jax():
    g = hub_graph_with_empty_rows()
    B = make_features(g, 32)
    jplan = j_prepare_ell(jax_graph(g))
    plan = ell_plan_from_numpy(jax_ell_dict(jplan), "cpu")
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


def test_ell_into_and_sub_batches():
    """``into=`` adds in place; a small ``max_gather_rows`` (many sub-batches
    per bucket) gives the same result; the chunk scatter-add assembly
    (no chunk1) agrees with the gather assembly."""
    g = hub_graph_with_empty_rows()
    B = torch.from_numpy(make_features(g, 8))
    plan = prepare_ell(g, device="cpu")
    C = plan(B)
    base = torch.ones((g.m, 8))
    out = plan(B, into=base)
    assert out.data_ptr() == base.data_ptr()
    torch.testing.assert_close(out, C + 1, rtol=1e-6, atol=1e-6)
    plan.max_gather_rows = 1000
    torch.testing.assert_close(plan(B), C, rtol=1e-6, atol=1e-6)
    plan.chunk1 = plan.extras = None
    torch.testing.assert_close(plan(B), C, rtol=1e-5, atol=1e-5)


def test_spmm_dispatch_on_cpu():
    g = dup_graph()
    B = make_features(g, 8)
    gold = spmm(g, B, method="ref")
    C = spmm(g, B, method="ell", device="cpu")
    assert C.device.type == "cpu"
    assert res_check(gold, C.numpy(), g.degrees).ok
    with pytest.raises(ValueError):
        spmm(g, B, method="band", device="cpu")


def test_ell_empty_graph():
    g = CSRGraph.from_arrays(np.zeros(5, np.int64), [], [])
    plan = prepare_ell(g, device="cpu")
    assert plan.buckets == () and plan.chunk1 is None
    assert torch.count_nonzero(plan(torch.ones((4, 3)))) == 0


# ---------------------------------------------------------------------------
# the row-unit kernel's tables and a NumPy emulation of the kernel
# ---------------------------------------------------------------------------

REDUCE_WARPS = 8  # csrc/gespmm.cu: RWARPS
EPS32 = float(np.finfo(np.float32).eps)


def assert_sums_close(got, want, row_len, absprod):
    """rtol = atol = 1e-5, widened for rows of several thousand nonzeros to
    the worst-case rounding of two f32 sums of L terms taken in different
    orders, 2·L·eps32·Σ|terms| (``absprod``: the product of |A| and |B|;
    ``row_len``: L per output row)."""
    tol = np.maximum(1e-5 + 1e-5 * np.abs(want),
                     2 * np.asarray(row_len)[:, None] * EPS32 * absprod)
    bad = np.abs(np.asarray(got, np.float64) - want) > tol
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond tolerance, "
                           f"max |diff| {np.abs(got - want).max():.3e}")


def emulate_row_units(t, B, into=None):
    """What csrc/gespmm.cu computes, in NumPy f32: each unit's sum taken
    entry by entry in order; a row of one unit writes (or, with ``into``,
    adds to) its output row, the units of a longer row their partial rows;
    then per split row warp w sums parts w, w + 8, ... in order and the
    eight sums are added in warp order.  Rows no unit writes stay NaN when
    there is no ``into``, so a test sees whether every row was written."""
    cols, vals = t.cols.numpy(), t.vals.numpy()
    start = t.row_start.numpy().astype(np.int64)
    k = B.shape[1]
    out = np.full((t.m, k), np.nan, np.float32) if into is None \
        else np.array(into, np.float32)
    scratch = np.full((t.n_parts, k), np.nan, np.float32)
    for row, lo, hi, part in t.units.numpy():
        e = slice(start[row] + lo, start[row] + hi)
        prod = vals[e, None] * B[cols[e]]
        acc = np.cumsum(prod, axis=0, dtype=np.float32)[-1] if hi > lo \
            else np.zeros(k, np.float32)
        if part >= 0:
            scratch[part] = acc
        elif into is None:
            out[row] = acc
        elif hi > lo:
            out[row] = out[row] + acc
    for row, p_lo, p_hi in t.splits.numpy():
        warp = [np.cumsum(scratch[p_lo + w:p_hi:REDUCE_WARPS], axis=0,
                          dtype=np.float32)[-1]
                if p_lo + w < p_hi else np.zeros(k, np.float32)
                for w in range(REDUCE_WARPS)]
        s = np.cumsum(np.stack(warp), axis=0, dtype=np.float32)[-1]
        out[row] = s if into is None else out[row] + s
    return out


def check_row_tables(t, row_ptr, col, vals):
    """The units partition each row's run of the flat store in order, at
    most ROW_UNIT_ENTRIES nonzeros of one row a unit; split rows own
    consecutive partial rows and one split entry; the run holds the CSR's
    nonzeros of the row in CSR order (so the row lengths are the CSR's
    degrees and no pad lies inside a run)."""
    u = t.units.numpy().astype(np.int64)
    splits = t.splits.numpy()
    m = len(row_ptr) - 1
    deg = np.diff(np.asarray(row_ptr, np.int64))
    assert t.m == m and t.units.dtype == t.splits.dtype == torch.int32
    assert np.all(np.diff(u[:, 0]) >= 0)                 # row order
    assert np.all(u[:, 2] - u[:, 1] <= ROW_UNIT_ENTRIES)
    assert np.all(u[:, 2] >= u[:, 1])
    per_row = np.bincount(u[:, 0], minlength=m)
    assert np.all(per_row >= 1)                           # empty rows too
    first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    last = first + per_row - 1
    assert np.all(u[first, 1] == 0) and np.all(u[last, 2] == deg)
    inner = np.setdiff1d(np.arange(len(u)), first)
    assert np.all(u[inner, 1] == u[inner - 1, 2])         # no gap, no overlap
    multi = per_row[u[:, 0]] > 1
    assert np.all(u[~multi, 3] == -1)
    np.testing.assert_array_equal(u[multi, 3], np.arange(multi.sum()))
    assert t.n_parts == multi.sum()
    split_rows = np.flatnonzero(per_row > 1)
    np.testing.assert_array_equal(splits[:, 0], split_rows)
    np.testing.assert_array_equal(splits[:, 1], u[first[split_rows], 3])
    np.testing.assert_array_equal(splits[:, 2] - splits[:, 1],
                                  per_row[split_rows])
    start = t.row_start.numpy().astype(np.int64)
    idx = np.repeat(start - np.asarray(row_ptr[:-1], np.int64), deg) \
        + np.arange(int(deg.sum()))
    np.testing.assert_array_equal(t.cols.numpy()[idx], col)
    np.testing.assert_array_equal(t.vals.numpy()[idx], vals)


def _windowed_cases():
    g = reorder(community_graph(3000, 200_000, n_comm=6, seed=5), "rbdeg")
    return g, dict(tm=256, W=128, J=4, min_count=32)


def _hub(transposed=False):
    """flex_tpu.io.synth.hub_graph: 90 % of the edges on 512 columns, so
    its transpose has rows of thousands of nonzeros."""
    jg = j_hub_graph(3000, 60_000, seed=2)
    g = CSRGraph.from_arrays(np.asarray(jg.row_ptr), np.asarray(jg.col),
                             np.asarray(jg.vals), name="hub_synth")
    if not transposed:
        return g
    rows = np.repeat(np.arange(g.m), g.degrees)
    return CSRGraph.from_coo(g.col, rows, g.vals, g.m, name="hub_synth_T")


RESIDUE_CASES = {
    # name -> (port plan, JAX plan, the residue's CSR (row_ptr, col, vals))
    "ell_hub": lambda: _ell_case(hub_graph_with_empty_rows()),
    "ell_hub_synth": lambda: _ell_case(_hub()),
    "ell_dups": lambda: _ell_case(dup_graph()),
    "windowed_residue": lambda: _windowed_residue_case(),
    "transposed_hub": lambda: _transposed_case(hub_graph_with_empty_rows()),
    "transposed_hub_synth": lambda: _transposed_case(_hub()),
}


def _ell_case(g):
    return (prepare_ell(g, device="cpu"), j_prepare_ell(jax_graph(g)),
            (g.row_ptr, g.col, g.vals))


def _windowed_residue_case():
    g, kw = _windowed_cases()
    port = prepare_windowed(g, device="cpu", **kw).ell
    ref = j_prepare_windowed(jax_graph(g), **kw).ell
    return port, ref, _residue_csr(port)


def _transposed_case(g):
    """prepare_ell_transpose with its pad entries, as the JAX package's
    with_bwd_plan builds it: transposed row 0 holds every pad."""
    port = prepare_ell_transpose(prepare_ell(g, device="cpu"), g.n)
    ref = j_with_bwd_plan(j_prepare_ell(jax_graph(g)), g.n).bwd_plan
    return port, ref, _residue_csr(port)


def _residue_csr(plan):
    """(row_ptr, col, vals) of the real entries of a plan's buckets in CSR
    order, from the bucket arrays and the kernel's units (a row's real
    entries are its run's first deg positions of the first chunk on)."""
    m = plan.m
    deg = np.zeros(m, np.int64)
    u = plan.rows.units.numpy().astype(np.int64)
    np.add.at(deg, u[:, 0], u[:, 2] - u[:, 1])
    # the runs, taken from the buckets themselves: chunk by chunk
    per_row_cols = [[] for _ in range(m)]
    per_row_vals = [[] for _ in range(m)]
    o = 0
    for c, v in plan.buckets:
        N, w = c.shape
        for i, r in enumerate(plan.chunk_row.numpy()[o:o + N]):
            per_row_cols[r].append(c.numpy()[i])
            per_row_vals[r].append(v.numpy()[i])
        o += N
    col = np.concatenate([np.concatenate(x)[:d] if x else np.zeros(0, np.int32)
                          for x, d in zip(per_row_cols, deg)])
    val = np.concatenate([np.concatenate(x)[:d] if x else np.zeros(0,
                                                                  np.float32)
                          for x, d in zip(per_row_vals, deg)])
    return np.concatenate([[0], np.cumsum(deg)]), col, val


@pytest.mark.parametrize("name", sorted(RESIDUE_CASES))
def test_row_tables_cover_every_nonzero(name):
    port, ref, (row_ptr, col, vals) = RESIDUE_CASES[name]()
    assert_same_ell(port, jax_ell_dict(ref))
    check_row_tables(port.rows, row_ptr, col, vals)
    # the buckets are views of the kernel's flat store
    base = port.rows.cols.data_ptr()
    end = base + port.rows.cols.numel() * 4
    assert all(base <= c.data_ptr() < end for c, _ in port.buckets)
    if name.startswith("transposed"):
        # transposed row 0 holds every pad entry of the forward's buckets
        fwd_pads = port.nnz - int(np.count_nonzero(vals))
        assert np.diff(row_ptr)[0] >= fwd_pads > 0
        assert np.diff(row_ptr)[0] > 2 * ROW_UNIT_ENTRIES
    if name in ("ell_hub", "transposed_hub"):
        assert port.rows.splits.shape[0] > 0


@pytest.mark.parametrize("k", [16, 41, 128])
@pytest.mark.parametrize("name", sorted(RESIDUE_CASES))
def test_row_unit_emulation_matches_jax_ell_into(name, k):
    """The emulated kernel with ``into=`` against the JAX package's
    ``_ell_spmm`` with ``into=`` on the same tables (its accumulator is
    padded to 128 lanes below k = 128, as it requires); the wrapper on the
    CPU, the plain version, gives the same."""
    port, ref, (row_ptr, _, _) = RESIDUE_CASES[name]()
    rng = np.random.default_rng(k)
    n = int(port.rows.cols.max()) + 1
    B = (2 * rng.random((n, k)) - 1).astype(np.float32)
    into = (2 * rng.random((port.m, k)) - 1).astype(np.float32)
    emu = emulate_row_units(port.rows, B, into)
    kp = max(k, 128)
    into_pad = np.zeros((port.m, kp), np.float32)
    into_pad[:, :k] = into
    want = np.asarray(j_ell_spmm(
        ref.buckets, ref.chunk_row, jnp.asarray(B), m=ref.m,
        max_gather_rows=ref.max_gather_rows, out_rows=ref.m,
        into=jnp.asarray(into_pad), chunk1=ref.chunk1,
        extras=ref.extras))[:, :k]
    row_len = np.diff(row_ptr)
    absprod = np.abs(into) + emulate_row_units(
        dataclasses.replace(port.rows, vals=port.rows.vals.abs()), np.abs(B))
    assert_sums_close(emu, want, row_len, absprod)
    via = gespmm_rows(port.rows, torch.from_numpy(B),
                      into=torch.from_numpy(into.copy()))
    assert_sums_close(via.numpy(), want, row_len, absprod)
    plain = ell_spmm_plain(port, torch.from_numpy(B),
                           into=torch.from_numpy(into.copy()))
    assert_sums_close(emu, plain.numpy(), row_len, absprod)


@pytest.mark.parametrize("name", ["ell_hub", "windowed_residue",
                                  "transposed_hub"])
def test_row_unit_emulation_without_into_writes_every_row(name):
    port, ref, (row_ptr, col, vals) = RESIDUE_CASES[name]()
    B = np.random.default_rng(1).random((int(col.max()) + 1, 8),
                                        dtype=np.float32)
    emu = emulate_row_units(port.rows, B)
    assert not np.isnan(emu).any()
    assert not emu[np.diff(row_ptr) == 0].any()
    absprod = emulate_row_units(
        dataclasses.replace(port.rows, vals=port.rows.vals.abs()), B)
    assert_sums_close(emu, ell_spmm_plain(port, torch.from_numpy(B)).numpy(),
                      np.diff(row_ptr), absprod)


@pytest.mark.parametrize("name", ["ell_hub", "ell_hub_synth",
                                  "windowed_residue", "transposed_hub"])
def test_ell_convert_carries_the_same_row_tables(name):
    port, ref, _ = RESIDUE_CASES[name]()
    conv = ell_plan_from_numpy(jax_ell_dict(ref), "cpu")
    for f in ("row_start", "units", "splits"):
        np.testing.assert_array_equal(getattr(conv.rows, f).numpy(),
                                      getattr(port.rows, f).numpy(), f)
    assert conv.rows.n_parts == port.rows.n_parts
    np.testing.assert_array_equal(conv.rows.cols.numpy(),
                                  port.rows.cols.numpy())
    np.testing.assert_array_equal(conv.rows.vals.numpy(),
                                  port.rows.vals.numpy())


def test_transposed_plan_without_pads():
    """``keep_pads=False`` (what ``with_bwd_plan`` builds) drops the
    forward's pad entries from transposed row 0 and keeps g_B; its tables
    then differ from the JAX package's, by design."""
    g = hub_graph_with_empty_rows()
    plan = prepare_ell(g, device="cpu")
    keep = prepare_ell_transpose(plan, g.n)
    drop = prepare_ell_transpose(plan, g.n, keep_pads=False)
    assert drop.nnz == g.nnz and keep.nnz == plan.padded_nnz
    assert with_bwd_plan(plan, g.n).bwd_plan.nnz == g.nnz
    gmat = torch.from_numpy(make_features(g, 16))
    torch.testing.assert_close(drop(gmat), keep(gmat), rtol=1e-5, atol=1e-5)
    check_row_tables(drop.rows, *_residue_csr(drop))


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_into", [False, True])
def test_residue_autograd_of_the_card_path(with_into, grad, monkeypatch):
    """The autograd function the card takes (run here on CPU tensors, where
    its forward is the plain version).  Without a ``bwd_plan`` its first
    backward builds the transposed plan ``with_bwd_plan`` attaches and
    keeps it: one build in two backwards, and g_B bit for bit that plan's
    and equal to autograd through the plain ops; the cotangent of ``into``
    is g.  A plan's call enters it only when a gradient can flow
    (``grad``): never under ``torch.no_grad()``."""
    g = hub_graph_with_empty_rows()
    plan = prepare_ell(g, device="cpu")
    tb = with_bwd_plan(plan, g.n)
    rng = np.random.default_rng(0)
    B0 = torch.from_numpy(make_features(g, 8))
    co = torch.from_numpy(rng.random((g.m, 8), dtype=np.float32))
    if not grad:
        monkeypatch.setattr(_EllApply, "apply", lambda *a: 1 / 0)
        B = B0.clone().requires_grad_()
        with torch.no_grad():
            out = tb(B, torch.ones((g.m, 8), requires_grad=True)
                     if with_into else None)
        want = ell_spmm_plain(plan, B0, torch.ones((g.m, 8))
                              if with_into else None)
        assert torch.equal(out, want) and out.grad_fn is None
        return
    entered, built, apply = [], [], _EllApply.apply
    monkeypatch.setattr(_EllApply, "apply",
                        lambda *a: entered.append(1) or apply(*a))
    monkeypatch.setattr(ell_spmm, "prepare_ell_transpose",
                        lambda *a, **kw: built.append(kw) or
                        prepare_ell_transpose(*a, **kw))
    grads = []
    for fn in (lambda B, i: _EllApply.apply(plan, B, i),
               lambda B, i: _EllApply.apply(plan, B, i),
               lambda B, i: ell_spmm_plain(plan, B, i), tb):
        B = B0.clone().requires_grad_()
        base = torch.ones((g.m, 8), requires_grad=True)
        into = base.clone() if with_into else None
        (fn(B, into) * co).sum().backward()
        grads.append((B.grad, base.grad))
    assert built == [{"keep_pads": False}] and plan.bwd_plan is None
    assert plan._kept_bwd is not None and len(entered) == 3
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][0], grads[3][0])
    torch.testing.assert_close(grads[0][0], grads[2][0], rtol=1e-5,
                               atol=1e-5)
    if with_into:
        for _, g_into in grads:
            torch.testing.assert_close(g_into, co)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_stats_and_traffic_model_match_jax(name):
    g = GRAPHS[name]()
    port, ref = prepare_ell(g, device="cpu"), j_prepare_ell(jax_graph(g))
    assert port.stats == ref.stats
    for k in (16, 128):
        assert port.traffic_model(k) == ref.traffic_model(k)


# -- the width ladder and b_dtype of the JAX signature ------------------------

LADDERS = {"4-8-16": (4, 8, 16), "2-3-5-64": (2, 3, 5, 64),
           "default": DEFAULT_WIDTHS}


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("name", ["hub", "dups"])
def test_prepare_ell_honours_widths_as_jax(name, ladder):
    """``prepare_ell(g, dev, widths)``: the bucket tables, the plain CPU
    path and the row-unit kernel's tables for the given ladder equal or
    agree with the JAX plan's (widths once raised a TypeError)."""
    widths = LADDERS[ladder]
    g = GRAPHS[name]()
    port = prepare_ell(g, None, widths, device="cpu")
    assert_same_ell(port, jax_ell_dict(j_prepare_ell(jax_graph(g),
                                                     widths=widths)))
    B = make_features(g, 16)
    C = spmm(g, B, "ell", widths=widths, device="cpu").numpy()
    C_jax = np.asarray(j_spmm(jax_graph(g), jnp.asarray(B), "ell",
                              widths=widths))
    np.testing.assert_allclose(C, C_jax, rtol=1e-5, atol=1e-5)
    t = port.rows
    check_row_tables(t, g.row_ptr, g.col, g.vals)
    absprod = np.abs(g.to_scipy()) @ np.abs(B)
    assert_sums_close(emulate_row_units(t, B), C_jax, g.degrees, absprod)


def test_b_dtype_float32_only():
    """``b_dtype`` is accepted as in the JAX signature: float32 is the
    default, bfloat16 (the gather mode ported since ROADMAP.md §1 item 5;
    its numbers are held to the JAX package's in tests/test_torch_bf16.py)
    builds a bf16 plan whose output stays float32, and any other dtype is
    refused."""
    g = GRAPHS["dups"]()
    B = make_features(g, 8)
    np.testing.assert_array_equal(
        prepare_ell(g, b_dtype="float32", device="cpu")(
            torch.from_numpy(B)).numpy(),
        prepare_ell(g, device="cpu")(torch.from_numpy(B)).numpy())
    cg = GRAPHS["community_rbdeg"]()
    for prep, gr, kw in ((prepare_ell, g, {}),
                         (prepare_windowed, cg, {"min_count": 16})):
        plan = prep(gr, b_dtype="bfloat16", device="cpu", **kw)
        assert plan.b_dtype == "bfloat16"
        C = plan(torch.from_numpy(make_features(gr, 8)))
        assert C.dtype == torch.float32
        with pytest.raises(ValueError, match="b_dtype"):
            prep(gr, b_dtype="float16", device="cpu", **kw)
    assert spmm(cg, make_features(cg, 8), "windowed", b_dtype="bfloat16",
                min_count=16, device="cpu").dtype == torch.float32
    plan = prepare_windowed(cg, b_dtype="float32", min_count=16,
                            device="cpu")
    assert plan.stats["n_steps"] > 0
