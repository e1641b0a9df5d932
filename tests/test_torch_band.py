"""Band SpMM of the PyTorch port against the JAX package: the host window
model, band arrays equal to the JAX plan's, the two kernels' plain
versions and whole plans against the JAX plan with its Pallas kernels in
interpret mode (rtol=atol=1e-5: f32 sums in another order), the port's own
plans against SciPy under res_check, and the refusals.  The split band's
depth ranges (one per 128-row tile) hold every nonzero, are the same on a
plan converted from the JAX plan's arrays, and a NumPy emulation of the
kernel's range-restricted loop equals the plain version and the Pallas
kernel; the same for the unsplit band (``impl="pallas"``), whose kernel
runs on the same ranged body.  The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.pallas_band import _band_spmm_pallas2
from flex_tpu.ops.pallas_band import panel_window_stats as j_window_stats
from flex_tpu.ops.pallas_band import prepare_band as j_prepare_band

from flex_tpu_torch.convert import band_plan_from_numpy
from flex_tpu_torch.io import banded_graph, make_features, uniform_graph
from flex_tpu_torch.ops.pallas_band import (
    IMPLS, RANGE_STEP, band_depth_ranges, band_spmm_v1, band_spmm_v1_plain,
    band_spmm_v2, band_spmm_v2_plain, panel_window_stats, prepare_band,
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


# ---------------------------------------------------------------------------
# depth ranges of the split band (what the ranged kernel reads)
# ---------------------------------------------------------------------------

def _halves_and_empty():
    """tm = 256, W = 768.  Panel 0 spans the window; in panel 1 the first
    128-row tile lies in the left half only and the second in the right
    half only; panel 2's first tile is empty; panel 3's tiles cross from
    one half into the other; panel 4 is empty."""
    rng = np.random.default_rng(3)
    spans = ((0, 256, 0, 700), (256, 384, 512, 600), (384, 512, 800, 1000),
             (640, 768, 520, 700), (768, 1024, 700, 900))
    rows, cols = [], []
    for r0, r1, c0, c1 in spans:
        rows.append(np.repeat(np.arange(r0, r1), 6))
        cols.append(rng.integers(c0, c1, rows[-1].shape))
    key = np.unique(np.concatenate(rows) * 1280 + np.concatenate(cols))
    vals = (2 * rng.random(len(key)) - 1).astype(np.float32)
    return CSRGraph.from_coo(key // 1280, key % 1280, vals, 1280,
                             name="halves_and_empty")


RANGE_CASES = dict(CASES, halves_and_empty=(
    _halves_and_empty, dict(tm=256, min_density=0.0)))


def _tiles(plan, bm=128):
    """(panel, tile, the tile's rows of [A_left | A_right]) of a split plan."""
    cat = np.concatenate([b.numpy() for b in plan.band], axis=2)
    for p in range(cat.shape[0]):
        for t in range(-(-cat.shape[1] // bm)):
            yield p, t, cat[p, t * bm:(t + 1) * bm]


@pytest.mark.parametrize("name", sorted(RANGE_CASES))
def test_band_depth_ranges_hold_every_nonzero(name):
    make, kw = RANGE_CASES[name]
    plan = prepare_band(make(), device="cpu", **kw)
    W = plan.w_pad
    r = plan.ranges.numpy()
    assert plan.ranges.dtype == torch.int32
    assert r.shape == (plan.band[0].shape[0],
                       -(-plan.band[0].shape[1] // 128), 2)
    kinds = set()
    for p, t, rows in _tiles(plan):
        lo, hi = r[p, t]
        assert lo % RANGE_STEP == 0 and hi % RANGE_STEP == 0
        assert 0 <= lo <= hi <= 2 * W
        nz = np.flatnonzero(rows.any(axis=0))
        if not len(nz):
            assert lo == hi
            kinds.add("empty")
            continue
        # every nonzero inside, and the range no wider than the rounding
        assert lo <= nz[0] and nz[-1] < hi
        assert lo > nz[0] - RANGE_STEP and hi < nz[-1] + 1 + RANGE_STEP
        kinds.add("left" if hi <= W else "right" if lo >= W else "both")
    if name == "halves_and_empty":
        assert kinds == {"empty", "left", "right", "both"}
    assert prepare_band(make(), device="cpu", impl="xla", **kw).ranges is None
    # the unsplit band's ranges: of its own depth W, every nonzero inside
    p1 = prepare_band(make(), device="cpu", impl="pallas", **kw)
    r1 = p1.ranges.numpy()
    assert p1.ranges.dtype == torch.int32 and r1.shape == r.shape
    band = p1.band.numpy()
    for p in range(band.shape[0]):
        for t in range(r1.shape[1]):
            lo, hi = r1[p, t]
            assert lo % RANGE_STEP == 0 and 0 <= lo <= hi <= W
            nz = np.flatnonzero(band[p, t * 128:(t + 1) * 128].any(axis=0))
            assert (lo == hi) if not len(nz) else \
                (lo <= nz[0] and nz[-1] < hi)
    torch.testing.assert_close(band_depth_ranges(*plan.band), plan.ranges,
                               rtol=0, atol=0)
    torch.testing.assert_close(band_depth_ranges(p1.band), p1.ranges,
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(RANGE_CASES))
def test_band_convert_carries_the_same_depth_ranges(name):
    make, kw = RANGE_CASES[name]
    g = make()
    mine = prepare_band(g, device="cpu", **kw)
    conv = band_plan_from_numpy(
        jax_band_dict(j_prepare_band(jax_graph(g), **kw)), "cpu")
    assert conv.ranges.dtype == torch.int32
    np.testing.assert_array_equal(conv.ranges.numpy(), mine.ranges.numpy())
    conv1 = band_plan_from_numpy(
        jax_band_dict(j_prepare_band(jax_graph(g), impl="pallas", **kw)),
        "cpu")
    np.testing.assert_array_equal(
        conv1.ranges.numpy(),
        prepare_band(g, device="cpu", impl="pallas", **kw).ranges.numpy())
    conv_x = band_plan_from_numpy(
        jax_band_dict(j_prepare_band(jax_graph(g), impl="xla", **kw)), "cpu")
    assert conv_x.ranges is None


def _emulate_ranged_v2(plan, B, bm=128):
    """What csrc/band_spmm.cu's v2 kernel computes, in NumPy: each 128-row
    tile the product of its depth range of [A_left | A_right] alone with
    the B rows that range meets (rows >= n as zero)."""
    W, k = plan.w_pad, B.shape[1]
    iW = plan.ws.numpy().astype(np.int64)
    B_pad = np.zeros(((-(-plan.n // W) + 2) * W, k), np.float32)
    B_pad[:plan.n] = B
    P, TM, _ = plan.band[0].shape
    out = np.full((P, TM, k), np.nan, np.float32)
    for p, t, rows in _tiles(plan, bm):
        lo, hi = plan.ranges[p, t].tolist()
        b0 = iW[p] * W
        out[p, t * bm:t * bm + len(rows)] = \
            rows[:, lo:hi] @ B_pad[b0 + lo:b0 + hi]
    return out.reshape(P * TM, k)


@pytest.mark.parametrize("k", [16, 41, 128])
@pytest.mark.parametrize("name", sorted(RANGE_CASES))
def test_ranged_loop_matches_plain_and_pallas(name, k):
    make, kw = RANGE_CASES[name]
    g = make()
    jplan = j_prepare_band(jax_graph(g), **kw)
    plan = band_plan_from_numpy(jax_band_dict(jplan), "cpu")
    B = make_features(g, k)
    emu = _emulate_ranged_v2(plan, B)
    assert not np.isnan(emu).any()              # every tile was written
    B_t = torch.from_numpy(B)
    np.testing.assert_allclose(
        emu, band_spmm_v2_plain(*plan.band, plan.ws, B_t).numpy(),
        rtol=1e-5, atol=1e-5)
    # the wrapper takes the table and, on the CPU, the plain version
    via = band_spmm_v2(*plan.band, plan.ws, B_t, ranges=plan.ranges)
    np.testing.assert_allclose(emu, via.numpy(), rtol=1e-5, atol=1e-5)
    kt = -(-k // 128) * 128                     # the JAX plan's lane padding
    B_lanes = jnp.zeros((g.n, kt), jnp.float32).at[:, :k].set(B)
    ref = np.asarray(_band_spmm_pallas2(
        *jplan.band, jplan.ws, B_lanes, m=g.m, n=g.n,
        precision=jax.lax.Precision.HIGHEST, interpret=True))[:, :k]
    np.testing.assert_allclose(emu[:g.m], ref, rtol=1e-5, atol=1e-5)


def test_band_v2_wrapper_rejects_a_bad_range_table():
    make, kw = CASES["band1024"]
    p2 = prepare_band(make(), device="cpu", **kw)
    B = torch.ones((p2.n, 4))
    for bad in (p2.ranges.long(), p2.ranges[:-1], p2.ranges[..., :1],
                p2.ranges.to("meta")):
        with pytest.raises(ValueError):
            band_spmm_v2(*p2.band, p2.ws, B, ranges=bad)


def _emulate_ranged_v1(plan, B, bm=128):
    """What csrc/band_spmm.cu's kernel computes for the unsplit band, in
    NumPy: each 128-row tile the product of its depth range of the band
    alone with the B rows ws128·128 + [lo, hi) (rows >= n as zero)."""
    W, k = plan.w_pad, B.shape[1]
    ws = plan.ws.numpy().astype(np.int64) * 128
    B_pad = np.zeros((-(-plan.n // 128) * 128 + W, k), np.float32)
    B_pad[:plan.n] = B
    band = plan.band.numpy()
    P, TM, _ = band.shape
    out = np.full((P, TM, k), np.nan, np.float32)
    for p in range(P):
        for t in range(-(-TM // bm)):
            lo, hi = plan.ranges[p, t].tolist()
            rows = band[p, t * bm:(t + 1) * bm]
            out[p, t * bm:t * bm + len(rows)] = \
                rows[:, lo:hi] @ B_pad[ws[p] + lo:ws[p] + hi]
    return out.reshape(P * TM, k)


@pytest.mark.parametrize("k", [16, 41, 128])
@pytest.mark.parametrize("name", sorted(RANGE_CASES))
def test_ranged_v1_loop_matches_plain_and_pallas(name, k):
    """Kernel 6 on kernel 5's ranged body: the emulated loop against the
    plain version, the wrapper on the CPU and ``_call_pallas_v1`` (the
    Pallas kernel in interpret mode, lanes padded as the JAX plan pads
    them)."""
    make, kw = RANGE_CASES[name]
    g = make()
    jplan = j_prepare_band(jax_graph(g), impl="pallas", **kw)
    plan = band_plan_from_numpy(jax_band_dict(jplan), "cpu")
    B = make_features(g, k)
    emu = _emulate_ranged_v1(plan, B)
    assert not np.isnan(emu).any()
    B_t = torch.from_numpy(B)
    np.testing.assert_allclose(
        emu, band_spmm_v1_plain(plan.band, plan.ws, B_t).numpy(),
        rtol=1e-5, atol=1e-5)
    via = band_spmm_v1(plan.band, plan.ws, B_t, ranges=plan.ranges)
    np.testing.assert_allclose(emu, via.numpy(), rtol=1e-5, atol=1e-5)
    kt = -(-k // 128) * 128
    B_lanes = jnp.zeros((g.n, kt), jnp.float32).at[:, :k].set(B)
    ref = np.asarray(jplan._call_pallas_v1(B_lanes))[:, :k]
    np.testing.assert_allclose(emu[:g.m], ref, rtol=1e-5, atol=1e-5)


def test_band_v1_wrapper_rejects_a_bad_range_table():
    make, kw = CASES["band1024"]
    p1 = prepare_band(make(), device="cpu", impl="pallas", **kw)
    B = torch.ones((p1.n, 4))
    band_spmm_v1(p1.band, p1.ws, B, ranges=p1.ranges)
    for bad in (p1.ranges.long(), p1.ranges[:-1], p1.ranges[..., :1],
                p1.ranges.to("meta")):
        with pytest.raises(ValueError):
            band_spmm_v1(p1.band, p1.ws, B, ranges=bad)
